// Compression-plane kernels (K5-K9) for Hopper: the client side and the
// top-k server side of the code-domain fast path, and the server side of
// the slow path's packed wire (dequantize, top-k unpack).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/wire_pack.py:
//   K5  :286 quantize_with_scale_keyed_pallas, :310 quantize_pack4_keyed_pallas
//   K6  :170 quantize_with_scale_pallas, :204 quantize_pack4_pallas
//       (their _nearest kernels included)
//   K7  :66 nibble_pack_pallas, :90 nibble_unpack_pallas, :112 dequantize_pallas
//   K8  :441 topk_scatter_add_pallas (_topk_scatter_add_seg_kernel, :418)
//   K9  :352 topk_unpack_pallas, :387 topk_unpack_segmented_pallas (one kernel)
//
// Every kernel takes a leading client axis: x (K, n) with blockIdx.y as the
// client, so that one launch serves all K clients of a leaf (the TPU
// version is vmapped, one client per call). A scale is shared by the
// clients (stride 0) or one per client (stride 1): client k reads
// scale[k * stride].
//
// wire_quantize (K5 and K6, one template). Per element p of client k:
//   y    = clip(x / s, -levels, levels)      IEEE division, clamp first
//   code = floor(y) + [u < y - floor(y)]     stochastic, or
//   code = rint(y)                           nearest (half to even, as jnp.round)
// with u read from a streamed field (K6) or drawn here (K5) from the
// client's key words (k0, k1) and p: the threefry2x32 hash of
// repro/kernels/ref.py:173-212 on uint32, bit for bit, so K5's codes equal
// the reference's, not only in distribution. With pack4 a thread makes one
// wire byte from elements 2i (low nibble) and 2i+1 (high nibble); an odd
// n pads the last high nibble with 0.
//
// nibble_pack / nibble_unpack (K7): one thread per byte.
//
// dequantize (K7): code * scale, one IEEE product per element and thread.
//
// topk_unpack (K9): the wrapper sorts each client's (value, index) payload
// by index with a stable sort and finds each 2048-wide output segment's
// slice of the row with searchsorted (K8's layout, one row per client).
// One block per (segment, client) zeroes its window in shared memory; the
// thread at the last entry of each run of equal indices stores that
// entry's value, so the pair last in payload order wins, as in the TPU
// kernels' serial walk; the block writes every element of its window
// once. No atomics.
//
// topk_scatter_add (K8): the wrapper sorts the weighted (value, index)
// pairs of all clients by index with a stable sort and finds each
// 2048-wide output segment's slice with searchsorted, as the TPU wrapper
// does. One block per segment zeroes its window in shared memory; each
// thread that starts a run of equal indices sums the run in order from 0
// (client order, as the stable sort keeps it) and stores the sum; the
// block writes the window out. No atomics: the sums are bitwise
// repeatable and in the reference's order.
//
// Bound on an H100 SXM. wire_quantize keyed: operations. A size-n draw
// needs ceil(n/2) threefry2x32 blocks, each serving two positions (pair
// and pair + half). A block is 2 counter adds, 20 rounds of (add, rotate,
// xor) and 5 key injections of 2 adds, 72 32-bit integer operations, and
// 3 more for its second counter; each element adds 2 for its mantissa
// fill. On the card's 64 INT32 lanes per SM (16.7 Tops/s at 1.98 GHz)
// that is about 50 us at K=4 and n=5,308,416, against 28 us to move x in
// and the bytes out. This kernel computes each element's block itself,
// so it hashes every block twice (once per position it serves) and
// throws one word away: twice the hash work the bound counts. Nearest and
// streamed rounding, the nibble kernels, dequantize, the scatter-add and
// the top-k unpack are bound by bytes. Nothing here is tuned yet: one
// element (or byte) per thread, no vector loads. The top-k unpack's
// wrapper sorts each row; the kernel alone moves the bound's bytes once.
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Rounding { kNearest = 0, kStreamed = 1, kKeyed = 2 };

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// one threefry2x32 block (jax's 20-round schedule, ref.py:156-171)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t inj[5][2] = {{k1, ks2}, {ks2, k0}, {k0, k1}, {k1, ks2}, {ks2, k0}};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += inj[i][0];
    x1 += inj[i][1] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// the uniform at flat position p of a size-n draw (ref.py:173-202)
__device__ __forceinline__ float keyed_uniform(uint32_t k0, uint32_t k1, uint32_t p,
                                               uint32_t n) {
  const uint32_t half = (n + 1u) / 2u;
  const bool lo = p < half;
  const uint32_t pair = lo ? p : p - half;
  const uint32_t c1 = pair + half < n ? pair + half : 0u;
  uint32_t o0, o1;
  threefry2x32(k0, k1, pair, c1, o0, o1);
  const uint32_t bits = lo ? o0 : o1;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

template <int MODE>
__device__ __forceinline__ int8_t quantize_one(float x, float s, float levels, const float* u_row,
                                               uint32_t k0, uint32_t k1, uint32_t p,
                                               uint32_t n) {
  float y = __fdiv_rn(x, s);
  y = y < -levels ? -levels : (y > levels ? levels : y);
  if constexpr (MODE == kNearest) {
    return static_cast<int8_t>(static_cast<int>(rintf(y)));
  }
  float u;
  if constexpr (MODE == kStreamed) {
    u = u_row[p];
  } else {
    u = keyed_uniform(k0, k1, p, n);
  }
  const float lo = floorf(y);
  const float code = lo + (u < y - lo ? 1.0f : 0.0f);
  return static_cast<int8_t>(static_cast<int>(code));
}

__device__ __forceinline__ int8_t pack_byte(int even, int odd) {
  return static_cast<int8_t>(static_cast<uint8_t>((even & 0xF) | ((odd & 0xF) << 4)));
}

// x (K, n) fp32, scale () fp32, u (K, n) fp32 or null, keys (K, 2) uint32 or
// null -> out (K, n) int8 codes, or (K, (n+1)/2) int8 nibble bytes (PACK4)
template <int MODE, bool PACK4>
__global__ void __launch_bounds__(kThreads)
    wire_quantize_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                         int scale_stride, const float* __restrict__ u,
                         const uint32_t* __restrict__ keys, int8_t* __restrict__ out, int n,
                         float levels) {
  const int k = blockIdx.y;
  const int n_out = PACK4 ? (n + 1) / 2 : n;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const float s = scale[k * scale_stride];
  const float* x_row = x + static_cast<size_t>(k) * n;
  const float* u_row = MODE == kStreamed ? u + static_cast<size_t>(k) * n : nullptr;
  uint32_t k0 = 0, k1 = 0;
  if (MODE == kKeyed) {
    k0 = keys[2 * k];
    k1 = keys[2 * k + 1];
  }
  const uint32_t un = static_cast<uint32_t>(n);
  if (PACK4) {
    const int p = 2 * i;
    const int even = quantize_one<MODE>(x_row[p], s, levels, u_row, k0, k1, p, un);
    const int odd = p + 1 < n
                        ? quantize_one<MODE>(x_row[p + 1], s, levels, u_row, k0, k1, p + 1, un)
                        : 0;
    out[static_cast<size_t>(k) * n_out + i] = pack_byte(even, odd);
  } else {
    out[static_cast<size_t>(k) * n + i] =
        quantize_one<MODE>(x_row[i], s, levels, u_row, k0, k1, i, un);
  }
}

// codes (K, n) int8 in [-8, 7] -> (K, (n+1)/2) int8
__global__ void __launch_bounds__(kThreads)
    nibble_pack_kernel(const int8_t* __restrict__ codes, int8_t* __restrict__ out, int n) {
  const int k = blockIdx.y;
  const int nb = (n + 1) / 2;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nb) return;
  const int8_t* row = codes + static_cast<size_t>(k) * n;
  const int even = row[2 * i];
  const int odd = 2 * i + 1 < n ? row[2 * i + 1] : 0;
  out[static_cast<size_t>(k) * nb + i] = pack_byte(even, odd);
}

// packed (K, (n+1)/2) int8 -> codes (K, n) int8, sign extended
__global__ void __launch_bounds__(kThreads)
    nibble_unpack_kernel(const int8_t* __restrict__ packed, int8_t* __restrict__ codes, int n) {
  const int k = blockIdx.y;
  const int nb = (n + 1) / 2;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nb) return;
  const int b = static_cast<uint8_t>(packed[static_cast<size_t>(k) * nb + i]);
  int8_t* row = codes + static_cast<size_t>(k) * n;
  row[2 * i] = static_cast<int8_t>(((b & 0xF) ^ 8) - 8);
  if (2 * i + 1 < n) row[2 * i + 1] = static_cast<int8_t>((((b >> 4) & 0xF) ^ 8) - 8);
}

// codes (K, n) int8, scale[k * scale_stride] -> out (K, n) fp32
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                      int scale_stride, float* __restrict__ out, int n) {
  const int k = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t at = static_cast<size_t>(k) * n + i;
  out[at] = __fmul_rn(static_cast<float>(codes[at]), scale[k * scale_stride]);
}

constexpr int kSeg = 2048;

// values and idx (K, k), each row sorted by index (stable), bounds (K, nseg + 1)
// the first entry of each segment of the row -> out (K, n) fp32
__global__ void __launch_bounds__(kThreads)
    topk_unpack_kernel(const float* __restrict__ values, const int* __restrict__ idx,
                       const int* __restrict__ bounds, float* __restrict__ out, int k,
                       int n) {
  __shared__ float window[kSeg];
  const int row = blockIdx.y;
  const int nseg = gridDim.x;
  const int base = blockIdx.x * kSeg;
  const int width = min(kSeg, n - base);
  for (int t = threadIdx.x; t < width; t += kThreads) window[t] = 0.0f;
  __syncthreads();
  const int* row_idx = idx + static_cast<size_t>(row) * k;
  const float* row_val = values + static_cast<size_t>(row) * k;
  const int start = bounds[row * (nseg + 1) + blockIdx.x];
  const int end = bounds[row * (nseg + 1) + blockIdx.x + 1];
  for (int j = start + threadIdx.x; j < end; j += kThreads) {
    const int at = row_idx[j];
    if (j + 1 < end && row_idx[j + 1] == at) continue;  // not the last of its run
    const int off = at - base;
    if (off >= 0 && off < width) window[off] = row_val[j];
  }
  __syncthreads();
  float* row_out = out + static_cast<size_t>(row) * n + base;
  for (int t = threadIdx.x; t < width; t += kThreads) row_out[t] = window[t];
}

// values and idx (m,) sorted by index (stable), bounds (nseg + 1,) the
// first entry of each segment -> out (n,) fp32
__global__ void __launch_bounds__(kThreads)
    topk_scatter_add_kernel(const float* __restrict__ values, const int* __restrict__ idx,
                            const int* __restrict__ bounds, float* __restrict__ out, int n) {
  __shared__ float window[kSeg];
  const int base = blockIdx.x * kSeg;
  const int width = min(kSeg, n - base);
  for (int t = threadIdx.x; t < width; t += kThreads) window[t] = 0.0f;
  __syncthreads();
  const int start = bounds[blockIdx.x];
  const int end = bounds[blockIdx.x + 1];
  for (int j = start + threadIdx.x; j < end; j += kThreads) {
    const int at = idx[j];
    if (j > start && idx[j - 1] == at) continue;  // not the first of its run
    float sum = 0.0f;
    for (int q = j; q < end && idx[q] == at; ++q) sum += values[q];
    const int off = at - base;
    if (off >= 0 && off < width) window[off] = sum;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < width; t += kThreads) out[base + t] = window[t];
}

template <int MODE, bool PACK4>
void launch_quantize(const float* x, const float* scale, int scale_stride, const float* u,
                     const uint32_t* keys, int8_t* out, int K, int n, float levels,
                     cudaStream_t stream) {
  const int n_out = PACK4 ? (n + 1) / 2 : n;
  const dim3 grid((n_out + kThreads - 1) / kThreads, K);
  wire_quantize_kernel<MODE, PACK4><<<grid, kThreads, 0, stream>>>(x, scale, scale_stride, u,
                                                                  keys, out, n, levels);
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
  const dim3 grid((n + kThreads - 1) / kThreads, K);
  dequantize_kernel<<<grid, kThreads, 0, stream>>>(codes, scale, scale_stride, out, n);
  return static_cast<int>(cudaGetLastError());
}

// seg: the caller's segment width, which must be this kernel's window
int topk_unpack(const float* values, const int* idx, const int* bounds, float* out, int K,
                int k, int n, int seg, cudaStream_t stream) {
  if (K <= 0 || K > 65535 || k <= 0 || n <= 0 || seg != kSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kSeg - 1) / kSeg, K);
  topk_unpack_kernel<<<grid, kThreads, 0, stream>>>(values, idx, bounds, out, k, n);
  return static_cast<int>(cudaGetLastError());
}

int nibble_pack(const int8_t* codes, int8_t* out, int K, int n, cudaStream_t stream) {
  if (K <= 0 || n <= 0 || K > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((n + 1) / 2 + kThreads - 1) / kThreads, K);
  nibble_pack_kernel<<<grid, kThreads, 0, stream>>>(codes, out, n);
  return static_cast<int>(cudaGetLastError());
}

int nibble_unpack(const int8_t* packed, int8_t* codes, int K, int n, cudaStream_t stream) {
  if (K <= 0 || n <= 0 || K > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((n + 1) / 2 + kThreads - 1) / kThreads, K);
  nibble_unpack_kernel<<<grid, kThreads, 0, stream>>>(packed, codes, n);
  return static_cast<int>(cudaGetLastError());
}

// seg: the caller's segment width, which must be this kernel's window
int topk_scatter_add(const float* values, const int* idx, const int* bounds, float* out, int n,
                     int seg, cudaStream_t stream) {
  if (n <= 0 || seg != kSeg) return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (n + kSeg - 1) / kSeg;
  topk_scatter_add_kernel<<<nseg, kThreads, 0, stream>>>(values, idx, bounds, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
