// Compression-plane kernels (K5-K9) for Hopper: the client side and the
// top-k server side of the code-domain fast path, and the server side of
// the slow path's packed wire (dequantize, top-k unpack).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/wire_pack.py:
//   K5  :286 quantize_with_scale_keyed_pallas, :310 quantize_pack4_keyed_pallas
//   K6  :170 quantize_with_scale_pallas, :204 quantize_pack4_pallas
//       (their _nearest kernels included)
//   K7  :66 nibble_pack_pallas, :90 nibble_unpack_pallas, :112 dequantize_pallas
//       (16-byte runs a thread)
//   K8  :441 topk_scatter_add_pallas (_topk_scatter_add_seg_kernel, :418)
//   K9  :352 topk_unpack_pallas, :387 topk_unpack_segmented_pallas (one call)
//
// Every kernel takes a leading client axis: x (K, n) with blockIdx.y as the
// client, so that one launch serves all K clients of a leaf (the TPU
// version is vmapped, one client per call). A scale is shared by the
// clients (stride 0) or one per client (stride 1): client k reads
// scale[k * stride].
//
// wire_quantize (K5 and K6, one entry point). Per element p of client k:
//   y    = clip(x / s, -levels, levels)      IEEE division, clamp first
//   code = floor(y) + [u < y - floor(y)]     stochastic, or
//   code = rint(y)                           nearest (half to even, as jnp.round)
// with u read from a streamed field (K6) or drawn here (K5) from the
// client's key words (k0, k1) and p: the threefry2x32 hash of
// repro/kernels/ref.py:173-212 on uint32 (threefry.cuh), bit for bit, so
// K5's codes equal the reference's, not only in distribution. With pack4
// a wire byte holds elements 2i (low nibble) and 2i+1 (high nibble); an
// odd n pads the last high nibble with 0. K6 (wire_quantize_kernel): a
// thread takes 8 consecutive elements of a row, with 16-byte loads and
// an 8-byte store of codes or a 4-byte store of bytes where the row's
// run is whole and aligned, element by element at a ragged tail. K5
// (wire_quantize_keyed_kernel): a thread owns 8 consecutive threefry
// blocks, hashes each once and quantizes both positions it serves (pair
// and pair + half); when half is odd a high-half byte spans two blocks,
// and its codes meet in shared memory (the kernel's comment).
//
// nibble_pack / nibble_unpack (K7): a thread takes 16 wire bytes and their
// 32 codes, with vector loads and stores where the run is whole and
// aligned (pack: two 16-byte loads, one 16-byte store; unpack: two runs of
// 8 bytes, 256 bytes apart, each an 8-byte load and a 16-byte store, so
// that a warp's store covers 512 consecutive bytes). An even n is one flat
// row of K·n codes (byte j is codes 2j and 2j + 1 whatever the client), so
// every run but the last is whole; an odd n is taken a row at a time, each
// row's last byte padded with a 0 high nibble, its runs aligned only where
// the row's start is.
//
// dequantize (K7): code * scale, one IEEE product an element. A thread
// takes 16 codes of the flat (K·n) array as four runs of 4, 128 codes
// apart (a warp's store covers 2 KB in four 512-byte pieces; 16
// consecutive codes a thread, its stores 64 bytes apart across the warp,
// ran slower than one code a thread): a 4-byte load and a 16-byte store
// where the run is whole and under one scale (shared, or one row's),
// element by element with each element's row scale where a run crosses a
// row's end under per-client scales.
//
// The top-k kernels bucket each client row's payload by output window;
// they never sort a row. One call launches two kernels on the caller's
// stream, the first the same for both:
//   sort   one block of 512 threads per chunk of 8,192 consecutive entries
//          of a client's payload: a shared histogram of the row's 2048-wide
//          output windows (an entry's rank in its window from the shared
//          atomicAdd), its scan, and the chunk's entries placed by window
//          in shared memory as 64-bit keys, (j + 1) in the high bits, the
//          value's bits in the low word, the place in the window between
//          them (or in a 16-bit array of its own when k >= 2**21); then
//          the chunk's keys and its scan go out with coalesced stores.
//          Indices outside [0, n) are dropped here. The histogram holds
//          at most 36 Ki windows (n <= 75,497,472); a longer row is sorted
//          by window groups of 32 Ki windows, one block per (chunk, group):
//          each block reads the whole chunk, counts its entries in the
//          groups before its own (the group's first slot in the chunk),
//          and sorts those of its group as above. The groups' runs lie in
//          group order, so the layout is the one the single histogram
//          gives.
//   topk_unpack (K9): one block of 128 threads per (window, client)
//          gathers the window's run from every chunk of the row (the
//          chunks' scans, a block scan of the run lengths, then the keys)
//          and takes a shared 64-bit atomicMax per key into the window:
//          the largest j wins with its value, an empty element keeps key
//          0, whose low word is +0.0f. The block then writes every element
//          of its window once, two a thread and step. The largest j is the
//          pair last in payload order, as the TPU kernels' serial walk
//          stores it: bit for bit, and the same on every run whatever
//          order the atomics ran in.
//   topk_scatter_add (K8): one block of 128 threads per window walks the
//          clients in client order; for each it gathers that client's run
//          of the window from every chunk as K9 does and adds
//          weight · value (two IEEE operations) into a shared window that
//          starts at +0.0f. A client's indices are distinct (a top-k
//          selection), so no element is touched twice in one client's
//          step and no atomics are needed; a barrier separates the
//          clients. An index several clients picked sums in client order
//          from 0, as the reference's serial scatter does. The window is
//          written out once.
// No global atomics, and no shape depends on the data on the host, so a
// call captures in one CUDA graph. The range is int32's: n < 2**31 - 2048,
// K·k < 2**31 - 1.
//
// Bound on an H100 SXM. wire_quantize keyed: operations. A size-n draw
// needs ceil(n/2) threefry2x32 blocks, each serving two positions (pair
// and pair + half). A block is 2 counter adds, 20 rounds of (add, rotate,
// xor) and 5 key injections of 2 adds, 72 32-bit integer operations, and
// 3 more for its second counter; each element adds 2 for its mantissa
// fill. On the card's 64 INT32 lanes per SM (16.7 Tops/s at 1.98 GHz)
// that is about 50 us at K=4 and n=5,308,416, against 28 us to move x in
// and the bytes out. The kernel hashes each block once, as the bound
// counts, and one block more per 2,048 when half is odd (a byte across
// two blocks of threads). Nearest and streamed rounding, the nibble
// kernels, dequantize, the scatter-add and the top-k unpack are bound by
// bytes: the nibble kernels move K·n + K·(n+1)/2 bytes (31.9 MB, 9.51 us
// at K = 4, n = 5,308,416), dequantize K·n + 4·K·n (106.2 MB, 31.7 us);
// their 16-byte runs issue one load or store a 16 bytes. K8's bound
// counts the payloads and weights read once and the (n,) output written
// once; its two kernels add the keys as K9's do. K9's bound counts
// the payload read once and the (K, n) output written once (93.4 MB at
// K = 4, n = 5,308,416: 27.9 us); its two kernels add the 64-bit slots
// written and read in order and the chunks' scans (about 18 MB at that
// size, most of it in L2). The output is 91 % of the bound's bytes: the
// window kernel's stores wait on its gather of a run from every chunk,
// its cost above the write alone.
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

enum Rounding { kNearest = 0, kStreamed = 1, kKeyed = 2 };

// K6: consecutive elements of a row a thread (two 16-byte loads of x, and
// of u when streamed; one 8-byte store of codes or 4-byte store of bytes)
constexpr int kElems = 8;
// K5: consecutive threefry blocks of a row a thread, each hashed once
constexpr int kPairs = 8;

// y = clip(x / s, ±levels); rint(y) (nearest), or floor(y) + [u < y - floor(y)]
template <int MODE>
__device__ __forceinline__ int quantize_code(float x, float s, float levels, float u) {
  float y = __fdiv_rn(x, s);
  y = y < -levels ? -levels : (y > levels ? levels : y);
  if constexpr (MODE == kNearest) {
    return static_cast<int>(rintf(y));
  }
  const float lo = floorf(y);
  return static_cast<int>(lo + (u < y - lo ? 1.0f : 0.0f));
}

__device__ __forceinline__ int8_t pack_byte(int even, int odd) {
  return static_cast<int8_t>(static_cast<uint8_t>((even & 0xF) | ((odd & 0xF) << 4)));
}

__device__ __forceinline__ uint32_t code_byte(int c) {
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(c)));
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// v[j] = row[start + j] for start + j < limit (0 past it): 16-byte loads
// where the run is whole and aligned
template <int N>
__device__ __forceinline__ void load_run(const float* __restrict__ row, uint32_t start,
                                         uint32_t limit, float (&v)[N]) {
  if (start + N <= limit && aligned(row + start, 16)) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + start + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = start + j < limit ? row[start + j] : 0.0f;
  }
}

// row[start + j] = c[j] for start + j < limit: one 4- or 8-byte store
// where the run is whole and aligned
template <int N>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ row, uint32_t start,
                                            uint32_t limit, const int (&c)[N]) {
  if (start + N <= limit && aligned(row + start, N)) {
    uint32_t w[N / 4];
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      w[j] = code_byte(c[4 * j]) | code_byte(c[4 * j + 1]) << 8 |
             code_byte(c[4 * j + 2]) << 16 | code_byte(c[4 * j + 3]) << 24;
    if constexpr (N == 8) {
      *reinterpret_cast<uint2*>(row + start) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(row + start) = w[0];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (start + j < limit) row[start + j] = static_cast<int8_t>(c[j]);
  }
}

// K6 (nearest, streamed). x (K, n) fp32, scale[k * scale_stride], u (K, n)
// fp32 (streamed) -> out (K, n) int8 codes, or (K, (n+1)/2) nibble bytes
// (PACK4). A thread takes kElems consecutive elements of row blockIdx.y.
template <int MODE, bool PACK4>
__global__ void __launch_bounds__(kThreads)
    wire_quantize_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                         int scale_stride, const float* __restrict__ u,
                         int8_t* __restrict__ out, int n, float levels) {
  const int k = blockIdx.y;
  const uint32_t un = static_cast<uint32_t>(n);
  const uint32_t i0 = (blockIdx.x * kThreads + threadIdx.x) * kElems;
  if (i0 >= un) return;
  const float s = scale[k * scale_stride];
  float xv[kElems], uv[kElems];
  load_run<kElems>(x + static_cast<size_t>(k) * n, i0, un, xv);
  if constexpr (MODE == kStreamed) load_run<kElems>(u + static_cast<size_t>(k) * n, i0, un, uv);
  int c[kElems];
#pragma unroll
  for (int j = 0; j < kElems; ++j)
    c[j] = quantize_code<MODE>(xv[j], s, levels, MODE == kStreamed ? uv[j] : 0.0f);
  if constexpr (PACK4) {
    // odd n: the last byte's high nibble is 0 (c past n is unused)
    int b[kElems / 2];
#pragma unroll
    for (int j = 0; j < kElems / 2; ++j)
      b[j] = static_cast<uint8_t>(pack_byte(c[2 * j], i0 + 2 * j + 1 < un ? c[2 * j + 1] : 0));
    const uint32_t nb = (un + 1u) / 2u;
    store_codes<kElems / 2>(out + static_cast<size_t>(k) * nb, i0 / 2, nb, b);
  } else {
    store_codes<kElems>(out + static_cast<size_t>(k) * n, i0, un, c);
  }
}

__device__ __forceinline__ int keyed_code(float x, float s, float levels, uint32_t word) {
  return quantize_code<kKeyed>(x, s, levels, threefry::bits_to_unit(word));
}

// K5 (keyed). x (K, n) fp32, scale[k * scale_stride], keys (K, 2) uint32
// -> out as wire_quantize_kernel's. A thread owns kPairs consecutive
// threefry blocks p.. of row blockIdx.y (threefry.cuh), hashes each once
// and quantizes both positions it serves: the low half's p.., the high
// half's p + half... Low bytes pair blocks (2i, 2i + 1). When half is
// even so do the high bytes; when it is odd a high byte pairs blocks
// (2i - 1, 2i): the high codes go through shared memory, and the block's
// first byte takes the code before its range, hashed for it alone (the
// block before's last second word, or for block 0 position half - 1, the
// byte that straddles the halves). The low side leaves that byte out.
template <bool PACK4>
__global__ void __launch_bounds__(kThreads)
    wire_quantize_keyed_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                               int scale_stride, const uint32_t* __restrict__ keys,
                               int8_t* __restrict__ out, int n, float levels) {
  __shared__ int8_t high[kThreads * kPairs];
  const int k = blockIdx.y;
  const uint32_t un = static_cast<uint32_t>(n);
  const uint32_t half = (un + 1u) / 2u;
  const uint32_t block0 = blockIdx.x * (kThreads * kPairs);
  const uint32_t p = block0 + threadIdx.x * kPairs;
  const float s = scale[k * scale_stride];
  const uint32_t k0 = keys[2 * k], k1 = keys[2 * k + 1];
  const float* x_row = x + static_cast<size_t>(k) * n;
  float xl[kPairs], xh[kPairs];
  load_run<kPairs>(x_row, p, half, xl);
  load_run<kPairs>(x_row + half, p, un - half, xh);
  int lo[kPairs], hi[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    lo[j] = hi[j] = 0;
    if (p + j < half) {
      uint32_t o0, o1;
      threefry::threefry_pair(k0, k1, p + j, un, o0, o1);
      lo[j] = keyed_code(xl[j], s, levels, o0);
      if (p + j + half < un) hi[j] = keyed_code(xh[j], s, levels, o1);
    }
  }
  if constexpr (!PACK4) {
    int8_t* row = out + static_cast<size_t>(k) * n;
    store_codes<kPairs>(row, p, half, lo);
    store_codes<kPairs>(row + half, p, un - half, hi);
  } else {
    const uint32_t nb = (un + 1u) / 2u;
    int8_t* row = out + static_cast<size_t>(k) * nb;
#pragma unroll
    for (int j = 0; j < kPairs; j += 2)
      if (p + j + 1 < half) row[(p + j) / 2] = pack_byte(lo[j], lo[j + 1]);
    if (half % 2u == 0u) {
#pragma unroll
      for (int j = 0; j < kPairs; j += 2)
        if (half + p + j < un) row[(half + p + j) / 2] = pack_byte(hi[j], hi[j + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) high[threadIdx.x * kPairs + j] = static_cast<int8_t>(hi[j]);
      int before = 0;  // the code at position half + block0 - 1
      if (threadIdx.x == 0) {
        const uint32_t q = half + block0 - 1u;
        if (q < un)
          before = keyed_code(x_row[q], s, levels, threefry::threefry_word(k0, k1, q, un));
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPairs; j += 2) {
        const uint32_t r = threadIdx.x * kPairs + j;  // even: a byte's high nibble
        const uint32_t q = half + block0 + r - 1u;     // its low nibble's position
        if (q < un) row[q / 2] = pack_byte(r == 0 ? before : high[r - 1], high[r]);
      }
    }
  }
}

// K7: a thread's run, 16 bytes of int8 (16 codes, or 16 wire bytes that
// hold 32 codes)
constexpr int kRun = 16;

// the 4 wire bytes of 8 codes: a = codes 0..3, b = codes 4..7 (little
// endian); each byte's low nibble is the even code, its high the odd
__device__ __forceinline__ uint32_t pack_word(uint32_t a, uint32_t b) {
  a &= 0x0F0F0F0Fu;
  b &= 0x0F0F0F0Fu;
  a |= a >> 4;  // bytes 0 and 2: (c0 | c1 << 4), (c2 | c3 << 4)
  b |= b >> 4;
  return __byte_perm(a, b, 0x6420);
}

// the 8 sign-extended codes of 4 wire bytes w: lo = codes 0..3, hi = 4..7
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t& lo, uint32_t& hi) {
  // each nibble in its own byte, sign extended byte by byte: (v ^ 8) - 8
  const uint32_t e = __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  const uint32_t o = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  lo = __byte_perm(e, o, 0x5140);
  hi = __byte_perm(e, o, 0x7362);
}

__device__ __forceinline__ int8_t unpack_nibble(int b) {
  return static_cast<int8_t>(((b & 0xF) ^ 8) - 8);
}

// codes (rows, m) int8 in [-8, 7] -> (rows, (m+1)/2) int8 wire bytes, row
// blockIdx.y. A thread takes the wire bytes 16t..16t+15 of its row: two
// 16-byte loads of 32 codes and one 16-byte store where the run is whole
// and aligned, byte by byte otherwise (an odd m's last byte takes 0 for
// its high nibble). An even n is launched as one row of K·n codes: byte j
// of the flat output is codes 2j and 2j + 1 whatever the row, so every run
// but the last is whole, and aligned with the tensors. An odd n is
// launched a row each, its pad nibble at the row's end.
__global__ void __launch_bounds__(kThreads)
    nibble_pack_kernel(const int8_t* __restrict__ codes, int8_t* __restrict__ out, int64_t m) {
  const int64_t nb = (m + 1) / 2;
  const int64_t b0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kRun;
  if (b0 >= nb) return;
  const int8_t* src = codes + blockIdx.y * m;
  int8_t* dst = out + blockIdx.y * nb;
  if (2 * b0 + 2 * kRun <= m && aligned(src + 2 * b0, 16) && aligned(dst + b0, 16)) {
    const uint4 c0 = *reinterpret_cast<const uint4*>(src + 2 * b0);
    const uint4 c1 = *reinterpret_cast<const uint4*>(src + 2 * b0 + kRun);
    *reinterpret_cast<uint4*>(dst + b0) =
        make_uint4(pack_word(c0.x, c0.y), pack_word(c0.z, c0.w), pack_word(c1.x, c1.y),
                   pack_word(c1.z, c1.w));
  } else {
    for (int64_t i = b0; i < b0 + kRun && i < nb; ++i)
      dst[i] = pack_byte(src[2 * i], 2 * i + 1 < m ? src[2 * i + 1] : 0);
  }
}

// packed (rows, (m+1)/2) int8 -> codes (rows, m) int8, sign extended, rows
// as nibble_pack_kernel's. A warp takes 512 consecutive wire bytes of its
// row, a thread 16 of them as two runs of 8, 256 bytes apart, so that each
// warp instruction covers consecutive memory: an 8-byte load and the
// 16-byte store of its 16 codes where the run is whole and aligned, byte
// by byte otherwise.
__global__ void __launch_bounds__(kThreads)
    nibble_unpack_kernel(const int8_t* __restrict__ packed, int8_t* __restrict__ codes,
                         int64_t m) {
  const int64_t nb = (m + 1) / 2;
  const int lane = threadIdx.x % 32;
  const int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane) * kRun;
  const int8_t* src = packed + blockIdx.y * nb;
  int8_t* dst = codes + blockIdx.y * m;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t b0 = w0 + 256 * h + 8 * lane;
    if (b0 >= nb) break;
    if (2 * b0 + 16 <= m && aligned(src + b0, 8) && aligned(dst + 2 * b0, 16)) {
      const uint2 w = *reinterpret_cast<const uint2*>(src + b0);
      uint4 c;
      unpack_word(w.x, c.x, c.y);
      unpack_word(w.y, c.z, c.w);
      *reinterpret_cast<uint4*>(dst + 2 * b0) = c;
    } else {
      for (int64_t i = b0; i < b0 + 8 && i < nb; ++i) {
        const int b = static_cast<uint8_t>(src[i]);
        dst[2 * i] = unpack_nibble(b);
        if (2 * i + 1 < m) dst[2 * i + 1] = unpack_nibble(b >> 4);
      }
    }
  }
}

// codes (K, n) int8, scale[k * scale_stride] -> out (K, n) fp32, one IEEE
// product an element, over the flat (K·n) array, so that the runs stay
// aligned whatever n is. A warp takes 512 consecutive codes, a thread 16
// of them as four runs of 4, 128 codes apart, so that each warp
// instruction covers consecutive memory: a 4-byte load and a 16-byte
// store where the run is whole, aligned and under one scale (a shared
// scale, or one row's), element by element otherwise, each element with
// its own row's scale.
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                      int scale_stride, float* __restrict__ out, int64_t n, int64_t total) {
  const int lane = threadIdx.x % 32;
  const int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane) * kRun;
  const bool narrow = total <= 0xFFFFFFFFll;  // 32-bit row divisions
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t e0 = w0 + 128 * q + 4 * lane;
    if (e0 >= total) break;
    // the run's first row and place in it (one row for a shared scale)
    int64_t k = 0, r = e0;
    if (scale_stride != 0) {
      k = narrow ? static_cast<uint32_t>(e0) / static_cast<uint32_t>(n) : e0 / n;
      r = e0 - k * n;
    }
    if (e0 + 4 <= total && (scale_stride == 0 || r + 4 <= n) && aligned(codes + e0, 4) &&
        aligned(out + e0, 16)) {
      const float s = scale[k * scale_stride];
      const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + e0);
      *reinterpret_cast<float4*>(out + e0) =
          make_float4(__fmul_rn(static_cast<float>(static_cast<int8_t>(w)), s),
                      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 8)), s),
                      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 16)), s),
                      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 24)), s));
    } else {
      for (int64_t e = e0; e < e0 + 4 && e < total; ++e, ++r) {
        if (scale_stride != 0 && r == n) {
          r = 0;
          ++k;
        }
        out[e] = __fmul_rn(static_cast<float>(codes[e]), scale[k * scale_stride]);
      }
    }
  }
}

// blocks of kThreads threads for `units` runs of kRun; 0 past the grid's
// range
__host__ inline unsigned run_blocks(int64_t units) {
  const int64_t runs = (units + kRun - 1) / kRun;
  const int64_t blocks = (runs + kThreads - 1) / kThreads;
  return blocks < 0x7FFFFFFF ? static_cast<unsigned>(blocks) : 0u;
}

constexpr int kSeg = 2048;
// K8 and K9: one block of kSortThreads sorts a chunk of kChunk consecutive
// entries of a row by window; one block of kWindowThreads a window
constexpr int kSortThreads = 512, kSortPer = 16, kChunk = kSortThreads * kSortPer;
constexpr int kWindowThreads = 128;
// the slots pack (j + 1) << 11 | the place in the window above the value's
// bits when k < 2**21, else keep the place in a 16-bit array of its own
constexpr int kPackedJ = 1 << 21;
// the sort's histogram holds a row of at most kMaxWindows windows (with
// the chunk's keys and places, 229,444 B of the H100's 232,448 B a block);
// a longer row is sorted by groups of kGroupWindows windows (212,996 B)
constexpr int kMaxWindows = 36 * 1024, kGroupWindows = 32 * 1024;

// a[0..len) -> its exclusive scan in place, and a[len] = the total; every
// thread of the block calls it, between barriers. warp_sums: THREADS / 32.
template <int THREADS>
__device__ __forceinline__ void block_exclusive_scan(int* a, int len, int* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (len + THREADS - 1) / THREADS;
  const int lo = min(len, static_cast<int>(threadIdx.x) * per), hi = min(len, lo + per);
  int sum = 0;
  for (int s = lo; s < hi; ++s) sum += a[s];
  int incl = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warps' totals
    const int w = lane < THREADS / 32 ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += v;
    }
    if (lane < THREADS / 32) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int s = lo; s < hi; ++s) {
    const int c = a[s];
    a[s] = run;
    run += c;
  }
  if (threadIdx.x == THREADS - 1) a[len] = run;
}

// values and idx (K, k) -> each chunk of kChunk entries of a row sorted by
// window: its entries in [0, n) counted in a shared histogram of the row's
// windows (an entry's rank in its window from the shared atomicAdd), the
// counts scanned, each entry's 64-bit key written to the chunk's slot
// (first slot of its window + rank): (j + 1) in the high bits, the value's
// bits in the low word, the place in the window between them (PACKED) or
// in offs. starts (K, nchunk, nseg + 1): the chunk's first slot of each
// window, and its count of entries in range. Indices outside [0, n) are
// dropped here. GROUPED: block x is (chunk x % nchunk, window group x /
// nchunk); it histograms the group's windows only, and its slots start
// after the chunk's entries in the groups before (counted here too).
template <bool PACKED, bool GROUPED>
__global__ void __launch_bounds__(kSortThreads)
    topk_unpack_sort_kernel(const float* __restrict__ values, const int* __restrict__ idx,
                            int* __restrict__ starts, unsigned long long* __restrict__ keys,
                            unsigned short* __restrict__ offs, int k, int n, int nseg,
                            int nchunk) {
  // the chunk's keys in window order, their places (PACKED: none), then
  // the histogram (nw + 1)
  extern __shared__ __align__(16) unsigned long long sorted[];
  unsigned short* places = reinterpret_cast<unsigned short*>(sorted + kChunk);
  int* hist = reinterpret_cast<int*>(places + (PACKED ? 0 : kChunk));
  __shared__ int warp_sums[kSortThreads / 32];
  __shared__ int below;  // GROUPED: the chunk's entries in the groups before
  const int row = blockIdx.y;
  const int chunk = GROUPED ? blockIdx.x % nchunk : blockIdx.x;
  const int w_lo = GROUPED ? blockIdx.x / nchunk * kGroupWindows : 0;
  const int nw = GROUPED ? min(kGroupWindows, nseg - w_lo) : nseg;  // the windows histogrammed
  for (int w = threadIdx.x; w <= nw; w += kSortThreads) hist[w] = 0;
  if (GROUPED && threadIdx.x == 0) below = 0;
  __syncthreads();
  const size_t row_at = static_cast<size_t>(row) * k;
  const int j0 = chunk * kChunk + threadIdx.x;
  int at[kSortPer], rank[kSortPer];
#pragma unroll
  for (int e = 0; e < kSortPer; ++e) {  // every load in flight before the atomics
    const int j = j0 + e * kSortThreads;
    at[e] = j < k ? idx[row_at + j] : -1;
  }
  int mine_below = 0;
#pragma unroll
  for (int e = 0; e < kSortPer; ++e) {
    if (at[e] >= n) at[e] = -1;  // dropped: -1
    if (GROUPED && at[e] >= 0) {
      const int w = at[e] / kSeg - w_lo;
      if (w < 0) ++mine_below;
      if (w < 0 || w >= nw) at[e] = -1;  // another group's
    }
    if (at[e] >= 0) rank[e] = atomicAdd(&hist[at[e] / kSeg - w_lo], 1);
  }
  if constexpr (GROUPED) {
    for (int o = 16; o > 0; o >>= 1) mine_below += __shfl_xor_sync(0xffffffffu, mine_below, o);
    if (threadIdx.x % 32 == 0) atomicAdd(&below, mine_below);
  }
  __syncthreads();
  block_exclusive_scan<kSortThreads>(hist, nw, warp_sums);
  __syncthreads();
  const int base = GROUPED ? below : 0;
  int* st = starts + (static_cast<size_t>(row) * nchunk + chunk) * (nseg + 1) + w_lo;
  const int n_st = nw + (w_lo + nw == nseg ? 1 : 0);  // the last group writes the count
  for (int w = threadIdx.x; w < n_st; w += kSortThreads) st[w] = base + hist[w];
#pragma unroll
  for (int e = 0; e < kSortPer; ++e) {
    if (at[e] < 0) continue;
    const int j = j0 + e * kSortThreads;
    const int p = hist[at[e] / kSeg - w_lo] + rank[e];
    const unsigned place = static_cast<unsigned>(at[e] % kSeg);
    const unsigned long long order = static_cast<unsigned long long>(j) + 1ull;
    const unsigned long long hi = PACKED ? order << 11 | place : order;
    sorted[p] = hi << 32 | __float_as_uint(values[row_at + j]);
    if (!PACKED) places[p] = static_cast<unsigned short>(place);
  }
  __syncthreads();
  // the chunk's slots out in order: coalesced stores
  const size_t slot0 = row_at + static_cast<size_t>(chunk) * kChunk + base;
  for (int q = threadIdx.x; q < hist[nw]; q += kSortThreads) {
    keys[slot0 + q] = sorted[q];
    if (!PACKED) offs[slot0 + q] = places[q];
  }
}

// visit(key, place in the window) for each key of window w of a row: its
// run in every chunk of the row, kWindowThreads chunks at a time (the
// runs' lengths scanned, then one key a thread and step). Every thread of
// the block calls it; it ends on a barrier.
template <bool PACKED, typename Visit>
__device__ __forceinline__ void window_keys(const int* __restrict__ starts,
                                            const unsigned long long* __restrict__ keys,
                                            const unsigned short* __restrict__ offs, int row,
                                            int w, int nseg, int k, int nchunk, Visit visit) {
  __shared__ int run_at[kWindowThreads + 1];  // the runs' exclusive scan of lengths
  __shared__ int run_from[kWindowThreads];    // each run's first slot in the row
  __shared__ int warp_sums[kWindowThreads / 32];
  const size_t row_at = static_cast<size_t>(row) * k;
  for (int b0 = 0; b0 < nchunk; b0 += kWindowThreads) {
    const int b = b0 + threadIdx.x;
    int from = 0, len = 0;
    if (b < nchunk) {
      const int* st = starts + (static_cast<size_t>(row) * nchunk + b) * (nseg + 1) + w;
      from = st[0];
      len = st[1] - from;
      from += b * kChunk;
    }
    run_from[threadIdx.x] = from;
    run_at[threadIdx.x] = len;
    __syncthreads();
    block_exclusive_scan<kWindowThreads>(run_at, kWindowThreads, warp_sums);
    __syncthreads();
    for (int f = threadIdx.x; f < run_at[kWindowThreads]; f += kWindowThreads) {
      int lo = 0, hi = kWindowThreads - 1;  // the last run starting at or before f
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (run_at[mid] <= f) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const size_t slot = row_at + run_from[lo] + (f - run_at[lo]);
      const unsigned long long key = keys[slot];
      visit(key, PACKED ? static_cast<int>(key >> 32) & (kSeg - 1) : offs[slot]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key));
}

// Write a window to dst once, two elements a thread and step: pair(q)
// gives elements 2q and 2q + 1, one(t) element t (8-byte stores where dst
// is 8-byte aligned, else 4-byte ones).
template <typename Pair, typename One>
__device__ __forceinline__ void store_window(float* __restrict__ dst, int width, bool even,
                                             Pair pair, One one) {
  if (even) {
    float2* dst2 = reinterpret_cast<float2*>(dst);
    for (int q = threadIdx.x; q < width / 2; q += kWindowThreads) dst2[q] = pair(q);
    if ((width & 1) && threadIdx.x == 0) dst[width - 1] = one(width - 1);
  } else {
    for (int t = threadIdx.x; t < width; t += kWindowThreads) dst[t] = one(t);
  }
}

// starts and the sorted slots from the sort kernel -> out (K, n) fp32:
// one block per (window, row) gathers the window's run from every chunk
// and takes a shared 64-bit atomicMax per key into the window: the largest
// j wins with its value, an empty element keeps key 0, whose low word is
// +0.0f. Then every element of the window is written once.
template <bool PACKED>
__global__ void __launch_bounds__(kWindowThreads)
    topk_unpack_window_kernel(const int* __restrict__ starts,
                              const unsigned long long* __restrict__ keys,
                              const unsigned short* __restrict__ offs, float* __restrict__ out,
                              int k, int n, int nchunk) {
  __shared__ __align__(16) unsigned long long window[kSeg];
  const int row = blockIdx.y, w = blockIdx.x, nseg = gridDim.x;
  const int base = w * kSeg;
  ulonglong2* pairs = reinterpret_cast<ulonglong2*>(window);  // 16-byte shared accesses
  for (int q = threadIdx.x; q < kSeg / 2; q += kWindowThreads) pairs[q] = make_ulonglong2(0, 0);
  window_keys<PACKED>(starts, keys, offs, row, w, nseg, k, nchunk,
                      [&](unsigned long long key, int off) { atomicMax(&window[off], key); });
  const size_t first = static_cast<size_t>(row) * n + base;
  const auto pair = [&](int q) {
    const ulonglong2 p = pairs[q];
    return make_float2(key_value(p.x), key_value(p.y));
  };
  const auto one = [&](int t) { return key_value(window[t]); };
  store_window(out + first, min(kSeg, n - base), (first & 1) == 0, pair, one);
}

// starts and the sorted slots of K rows -> out (n,) fp32, the weighted sum
// of the rows: one block per window walks the rows in client order and
// adds weight · value of each key of the row's window into a shared window
// that starts at +0.0f (a row's indices are distinct: one add an element
// and row, no atomics; the window kernel's gather ends on a barrier).
template <bool PACKED>
__global__ void __launch_bounds__(kWindowThreads)
    topk_scatter_add_window_kernel(const int* __restrict__ starts,
                                   const unsigned long long* __restrict__ keys,
                                   const unsigned short* __restrict__ offs,
                                   const float* __restrict__ weights, float* __restrict__ out,
                                   int K, int k, int n, int nchunk) {
  __shared__ __align__(16) float window[kSeg];
  const int w = blockIdx.x, nseg = gridDim.x;
  const int base = w * kSeg;
  float4* quads = reinterpret_cast<float4*>(window);
  for (int q = threadIdx.x; q < kSeg / 4; q += kWindowThreads)
    quads[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int row = 0; row < K; ++row) {
    const float wt = weights[row];
    window_keys<PACKED>(starts, keys, offs, row, w, nseg, k, nchunk,
                        [&](unsigned long long key, int off) {
                          window[off] = __fadd_rn(window[off], __fmul_rn(wt, key_value(key)));
                        });
  }
  const float2* pairs = reinterpret_cast<const float2*>(window);
  const auto pair = [&](int q) { return pairs[q]; };
  const auto one = [&](int t) { return window[t]; };
  store_window(out + base, min(kSeg, n - base), true, pair, one);
}

// opt the sort kernel in to a histogram above 48 KB of shared memory (the
// attribute is raised once for each larger size, outside any stream)
template <bool PACKED, bool GROUPED>
cudaError_t allow_sort_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&topk_unpack_sort_kernel<PACKED, GROUPED>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Where the top-k layout lies in the int32 scratch that wire_pack.py's
// _scratch_parts sizes: the starts (K, nchunk, nseg + 1), then on an
// 8-byte boundary the slots' 64-bit keys (K, k) and their 16-bit window
// places (K, k).
struct TopkLayout {
  int nseg, nchunk;
  int* starts;
  unsigned long long* keys;
  unsigned short* offs;
  TopkLayout(int* scratch, int K, int k, int n)
      : nseg((n + kSeg - 1) / kSeg), nchunk((k + kChunk - 1) / kChunk), starts(scratch) {
    const size_t key_at = (static_cast<size_t>(K) * nchunk * (nseg + 1) + 1) / 2 * 2;
    keys = reinterpret_cast<unsigned long long*>(scratch + key_at);
    offs = reinterpret_cast<unsigned short*>(keys + static_cast<size_t>(K) * k);
  }
};

// The sort kernel over every chunk of the K rows: one histogram of the
// row's windows, or groups of kGroupWindows past kMaxWindows.
template <bool PACKED>
cudaError_t launch_sort(const float* values, const int* idx, const TopkLayout& L, int K, int k,
                        int n, cudaStream_t stream) {
  const bool grouped = L.nseg > kMaxWindows;
  const size_t smem = kChunk * sizeof(unsigned long long) +
                      (PACKED ? 0 : kChunk * sizeof(unsigned short)) +
                      static_cast<size_t>((grouped ? kGroupWindows : L.nseg) + 1) * sizeof(int);
  const cudaError_t err =
      grouped ? allow_sort_smem<PACKED, true>(smem) : allow_sort_smem<PACKED, false>(smem);
  if (err != cudaSuccess) return err;
  if (grouped) {
    const int groups = (L.nseg + kGroupWindows - 1) / kGroupWindows;
    topk_unpack_sort_kernel<PACKED, true><<<dim3(L.nchunk * groups, K), kSortThreads, smem,
                                            stream>>>(values, idx, L.starts, L.keys, L.offs, k,
                                                      n, L.nseg, L.nchunk);
  } else {
    topk_unpack_sort_kernel<PACKED, false><<<dim3(L.nchunk, K), kSortThreads, smem, stream>>>(
        values, idx, L.starts, L.keys, L.offs, k, n, L.nseg, L.nchunk);
  }
  return cudaGetLastError();
}

template <int MODE, bool PACK4>
void launch_quantize(const float* x, const float* scale, int scale_stride, const float* u,
                     const uint32_t* keys, int8_t* out, int K, int n, float levels,
                     cudaStream_t stream) {
  if constexpr (MODE == kKeyed) {
    const long long half = (static_cast<long long>(n) + 1) / 2;
    const dim3 grid(static_cast<unsigned>((half + kThreads * kPairs - 1) / (kThreads * kPairs)),
                    K);
    wire_quantize_keyed_kernel<PACK4><<<grid, kThreads, 0, stream>>>(x, scale, scale_stride,
                                                                    keys, out, n, levels);
  } else {
    const dim3 grid(
        static_cast<unsigned>((static_cast<long long>(n) + kThreads * kElems - 1) /
                              (kThreads * kElems)),
        K);
    wire_quantize_kernel<MODE, PACK4><<<grid, kThreads, 0, stream>>>(x, scale, scale_stride, u,
                                                                    out, n, levels);
  }
}

}  // namespace

extern "C" {

// mode: 0 nearest, 1 streamed u, 2 keyed; pack4: 0 codes, 1 nibble bytes;
// scale_stride: 0 one scale for all clients, 1 one per client
int wire_quantize(int mode, int pack4, const float* x, const float* scale, int scale_stride,
                  const float* u, const uint32_t* keys, int8_t* out, int K, int n,
                  float levels, cudaStream_t stream) {
  if (K <= 0 || n <= 0 || K > 65535 || (scale_stride != 0 && scale_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
#define WIRE_Q(M, P) \
  launch_quantize<M, P>(x, scale, scale_stride, u, keys, out, K, n, levels, stream)
  switch (mode * 2 + (pack4 ? 1 : 0)) {
    case 0: WIRE_Q(kNearest, false); break;
    case 1: WIRE_Q(kNearest, true); break;
    case 2: WIRE_Q(kStreamed, false); break;
    case 3: WIRE_Q(kStreamed, true); break;
    case 4: WIRE_Q(kKeyed, false); break;
    case 5: WIRE_Q(kKeyed, true); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIRE_Q
  return static_cast<int>(cudaGetLastError());
}

int dequantize(const int8_t* codes, const float* scale, int scale_stride, float* out, int K,
               int n, cudaStream_t stream) {
  if (K <= 0 || n <= 0 || K > 65535 || (scale_stride != 0 && scale_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(K) * n;
  const unsigned blocks = run_blocks(total);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<blocks, kThreads, 0, stream>>>(codes, scale, scale_stride, out, n, total);
  return static_cast<int>(cudaGetLastError());
}

// scratch: 8-byte aligned int32 space as wire_pack.py's _scratch_parts
// sizes it (TopkLayout). seg: the caller's window width, which must be
// this kernel's. Launches the sort and the window kernels in turn.
int topk_unpack(const float* values, const int* idx, int* scratch, float* out, int K, int k,
                int n, int seg, cudaStream_t stream) {
  if (K <= 0 || K > 65535 || k <= 0 || n <= 0 || seg != kSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  const TopkLayout L(scratch, K, k, n);
  const bool packed = k < kPackedJ;
  const cudaError_t err = packed ? launch_sort<true>(values, idx, L, K, k, n, stream)
                                 : launch_sort<false>(values, idx, L, K, k, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 windows(L.nseg, K);
  if (packed) {
    topk_unpack_window_kernel<true><<<windows, kWindowThreads, 0, stream>>>(
        L.starts, L.keys, L.offs, out, k, n, L.nchunk);
  } else {
    topk_unpack_window_kernel<false><<<windows, kWindowThreads, 0, stream>>>(
        L.starts, L.keys, L.offs, out, k, n, L.nchunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The weighted sum of K top-k payloads: values and idx (K, k), weights
// (K,) fp32 -> out (n,) fp32; scratch and seg as topk_unpack's. Launches
// the sort and the scatter-add window kernels in turn.
int topk_scatter_add(const float* values, const int* idx, const float* weights, int* scratch,
                     float* out, int K, int k, int n, int seg, cudaStream_t stream) {
  if (K <= 0 || K > 65535 || k <= 0 || n <= 0 || seg != kSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  const TopkLayout L(scratch, K, k, n);
  const bool packed = k < kPackedJ;
  const cudaError_t err = packed ? launch_sort<true>(values, idx, L, K, k, n, stream)
                                 : launch_sort<false>(values, idx, L, K, k, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (packed) {
    topk_scatter_add_window_kernel<true><<<L.nseg, kWindowThreads, 0, stream>>>(
        L.starts, L.keys, L.offs, weights, out, K, k, n, L.nchunk);
  } else {
    topk_scatter_add_window_kernel<false><<<L.nseg, kWindowThreads, 0, stream>>>(
        L.starts, L.keys, L.offs, weights, out, K, k, n, L.nchunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// an even n is one row of K·n codes (the flat pairing), an odd n K rows
int nibble_pack(const int8_t* codes, int8_t* out, int K, int n, cudaStream_t stream) {
  if (K <= 0 || n <= 0 || K > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n % 2 ? K : 1;
  const int64_t m = n % 2 ? n : static_cast<int64_t>(K) * n;
  const unsigned blocks = run_blocks((m + 1) / 2);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  nibble_pack_kernel<<<dim3(blocks, rows), kThreads, 0, stream>>>(codes, out, m);
  return static_cast<int>(cudaGetLastError());
}

int nibble_unpack(const int8_t* packed, int8_t* codes, int K, int n, cudaStream_t stream) {
  if (K <= 0 || n <= 0 || K > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n % 2 ? K : 1;
  const int64_t m = n % 2 ? n : static_cast<int64_t>(K) * n;
  const unsigned blocks = run_blocks((m + 1) / 2);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  nibble_unpack_kernel<<<dim3(blocks, rows), kThreads, 0, stream>>>(packed, codes, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
