// The normal kernel for Hopper: jax.random.normal drawn in the kernel and
// added, scaled, to a table of leaves in one launch.
//
// Replaces the per-leaf `p + sigma * jax.random.normal(k_i, p.shape)` of
// src/repro/core/fvn.py:40-48 (FVN, one call a client step), of the
// gaussian adversary (src/repro/core/corruption.py:128-141) and of the DP
// noise (src/repro/core/aggregation.py:175-180). The reference has no
// Pallas kernel here: XLA fuses the draw; the port's plain version is
// src/repro_torch/kernels/ref.py:normal_axpy_ref.
//
// One launch walks a table of up to kMaxLeaves leaves. Leaf i is
// (x, out, n, key words, scale, dtype): out = x + scale * normal(key, n),
// in x's dtype (fp32 or bf16, rounded to nearest even), the product and
// then the sum as two IEEE float32 operations. The scale is one value
// (scale_value, or scale[0] from the device when `scale` is set: the DP
// noise's sigma·clip/m) or, with `inner` < n, scale[p / inner] for
// position p (the gaussian adversary's per-client scale · RMS): it is read
// on the device, so no call waits on the host. The table is the kernel's
// parameter, passed by value (__grid_constant__), so a call copies
// nothing to the card before its launch.
//
// A thread owns kPairs (4) consecutive threefry blocks of its leaf
// (threefry.cuh): it hashes each once and serves both positions of each,
// the low half's pair.. and the high half's pair + half.., 8 draws. It
// loads and stores each half's run of 4 with one 16-byte (fp32) or 8-byte
// (bf16) access where the run is whole and aligned (half even, 4 | half
// for fp32 leaves), element by element otherwise. Leaf i's blocks of
// threads start at first_block[i], so each block lies in one leaf.
//
// The normal of a word is jax 0.9.0's CPU program for jax.random.normal,
// written out operation by operation as ref.py's uniform_to_normal is:
// the fill f, u = max(lo, fmaf(f, 2, lo)), then XLA's ErfInv32 (Giles's
// two polynomials in w = -log1p(-u·u)) over XLA's CPU log1p (Cephes's
// rational form where |y| < sqrt(2) - 1, Eigen's float log of 1 + y
// elsewhere), every fused multiply-add of that program an fmaf and every
// other product, sum, quotient and root one IEEE operation (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so that nvcc contracts nothing on
// its own. The plain version takes each fmaf in fp64 (exact product, one
// rounding) and equals the true fma on all 2**23 values the fill gives:
// the kernel equals the plain version bit for bit, and both equal
// jax.random.normal on the CPU.
//
// XLA's log1p is a select of its two branches, and a warp's 32 lanes
// almost always need both, so a lane cannot skip one without divergence.
// The kernel runs one branch a draw instead: the warp sorts its 256
// draws' y = -u·u by branch into a list in shared memory (Cephes's from
// the front, Eigen's from the back; a draw's slot from __ballot_sync and
// __popc), runs each branch over its own entries 32 a pass (about 6
// Cephes passes and 3 Eigen passes where the select took 8 of both) and
// reads each result back from its draw's slot. Each branch is a function
// of y alone, so a value's bits depend neither on its lane nor on the
// other branch. threefry_normal_words runs the same code over given words
// (all 2**23 fills in chip_smoke.py); nothing on a path calls it.
//
// Bound on an H100 SXM at rnnt-librispeech's 35 leaves and 105,333,760
// fp32 elements (chip_smoke.py computes it from the run's draws): 842.7 MB
// read and written take 0.252 ms at 3.35 TB/s; the 52.7 M threefry blocks
// at 75 int32 operations and the fill's 2 an element 0.249 ms on the 64
// INT32 lanes an SM. Beside the bound, not in it, the compiled code's issue
// rate: with one log1p branch a draw it issues 9.36 G SASS instructions
// there (tools/k7_normal_parent_ab.py --sass counts each piece), 0.280 ms at
// one warp instruction a clock on each of 4 · 132 schedulers; XLA's select
// of both branches 12.8 G, 0.383 ms.
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. The
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

// one entry of the table; outside the unnamed namespace, so that the C
// entry point that takes it keeps external linkage
struct Leaf {
  const void* x;
  void* out;
  const float* scale;  // null: scale_value
  float scale_value;
  uint32_t n;      // elements, < 2**31
  uint32_t inner;  // elements a scale entry covers (>= n: one scale)
  uint32_t k0, k1;
  int bf16;             // 1: x and out are bf16, 0: fp32
  uint32_t first_block;  // set by the entry point
};

namespace {


constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;  // the table fits the 4 KB of kernel parameters
constexpr int kPairs = 4;  // threefry blocks a thread
static_assert(kPairs % 4 == 0, "a half's run is whole 4-element vectors");
constexpr int kDraws = 2 * kPairs;
constexpr int kWarpDraws = 32 * kDraws;  // a warp's list of draws
// XLA's log1p takes Cephes's branch where |y| < sqrt(2) - 1 (its select's
// condition, unchanged)
constexpr float kCephesBelow = 0.41421357f;

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
};

// XLA's CPU log1p of y in float32 (ref.py:xla_log1p_f32), its branch for
// |y| < sqrt(2) - 1: y + (-y²/2 + y³ P(y) / Q(y)) (Cephes)
__device__ __forceinline__ float log1p_cephes(float y) {
  const float y2 = __fmul_rn(y, y);
  float q = __fadd_rn(y, 15.062909f);
  q = fmaf(q, y, 83.04757f);
  q = fmaf(q, y, 221.7624f);
  q = fmaf(q, y, 309.09872f);
  q = fmaf(q, y, 216.42789f);
  q = fmaf(q, y, 60.11866f);
  float p = fmaf(4.527e-05f, y, 0.49854103f);
  p = fmaf(p, y, 6.5787325f);
  p = fmaf(p, y, 29.911919f);
  p = fmaf(p, y, 60.94967f);
  p = fmaf(p, y, 57.112965f);
  p = fmaf(p, y, 20.039553f);
  const float r = __fdiv_rn(p, q);
  return __fadd_rn(y, fmaf(y2, -0.5f, __fmul_rn(__fmul_rn(y, y2), r)));
}

// the same, its other branch: Eigen's plog_float of x = 1 + y
__device__ __forceinline__ float log1p_eigen(float y) {
  const float x = __fadd_rn(y, 1.0f);
  const uint32_t bits = __float_as_uint(x > 1.1754944e-38f ? x : 1.1754944e-38f);
  float e = __fadd_rn(static_cast<float>(static_cast<int>(bits >> 23) - 127), 1.0f);
  const float m = __uint_as_float((bits & 0x7FFFFFu) | 0x3F000000u);
  const bool below = m < 0.70710677f;
  e = __fsub_rn(e, below ? 1.0f : 0.0f);
  const float t = __fadd_rn(__fsub_rn(m, 1.0f), below ? m : 0.0f);
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  const float a = fmaf(fmaf(t, 0.070376836f, -0.1151461f), t, 0.116769984f);
  const float b = fmaf(fmaf(t, -0.12420141f, 0.14249323f), t, -0.16668057f);
  const float d = fmaf(fmaf(t, 0.20000714f, -0.24999994f), t, 0.3333333f);
  const float poly = fmaf(fmaf(fmaf(a, t3, b), t3, d), t3, __fmul_rn(e, -0.00021219444f));
  return fmaf(e, 0.693359375f, __fadd_rn(__fsub_rn(t, __fmul_rn(t2, 0.5f)), poly));
}

// XLA's float32 ErfInv (ref.py:xla_erf_inv_f32) of a uniform value x,
// given lg = log1p(-x·x): the special cases of the plain version (1 + y at
// 0, below 0 or infinite in the log1p; |x| = 1) lie outside the values x
// takes, so the kernel leaves them out. The rare branch w >= 5 (about 0.3 %
// of the draws) is a branch, not a select, so that most warps skip its
// square root.
__device__ __forceinline__ float erf_inv_of(float x, float lg) {
  float p;
  if (lg > -5.0f) {
    const float w = __fsub_rn(-2.5f, lg);
    p = fmaf(2.81022636e-08f, w, 3.43273939e-07f);
    p = fmaf(w, p, -3.5233877e-06f);
    p = fmaf(w, p, -4.39150654e-06f);
    p = fmaf(w, p, 0.00021858087f);
    p = fmaf(w, p, -0.00125372503f);
    p = fmaf(w, p, -0.00417768164f);
    p = fmaf(w, p, 0.246640727f);
    p = fmaf(w, p, 1.50140941f);
  } else {
    const float w = __fsub_rn(__fsqrt_rn(-lg), 3.0f);
    p = fmaf(-0.000200214257f, w, 0.000100950558f);
    p = fmaf(w, p, 0.00134934322f);
    p = fmaf(w, p, -0.00367342844f);
    p = fmaf(w, p, 0.00573950773f);
    p = fmaf(w, p, -0.0076224613f);
    p = fmaf(w, p, 0.00943887047f);
    p = fmaf(w, p, 1.00167406f);
    p = fmaf(w, p, 2.83297682f);
  }
  return __fmul_rn(x, p);
}

// jax.random.normal's uniform of one threefry word: max(lo, f · 2 + lo)
__device__ __forceinline__ float uniform_of(uint32_t word) {
  const float lo = -(1.0f - 0x1p-24f);
  return fmaxf(lo, fmaf(threefry::bits_to_unit(word), 2.0f, lo));
}

// z[j] = jax.random.normal's float32 value (ref.py:uniform_to_normal) of
// the uniform u[j]; every lane of the warp calls it, and a draw the lane
// does not own has u = 0 (its value unused). y = -u·u goes into the warp's
// `list` (kWarpDraws floats in shared memory) by branch: for draw j the
// warp's Cephes draws (one __ballot_sync) fill the front in lane order
// after those of draws 0..j-1, its Eigen draws the back, so a lane's slot
// is n_cephes + r or kWarpDraws - 1 - (32·j - n_cephes) - (lane - r), with
// r its Cephes rank (__popc of the ballot below it). Each branch then
// runs over its own entries, 32 a pass, in place, and each draw reads its
// log1p back from its slot.
__device__ __forceinline__ void warp_normals(const float (&u)[kDraws], float (&z)[kDraws],
                                             float* list) {
  float lg[kDraws];
  const int lane = threadIdx.x % 32;
  const uint32_t below = (1u << lane) - 1u;
  int n_cephes = 0;
  int slot[kDraws];
#pragma unroll
  for (int j = 0; j < kDraws; ++j) {
    const float y = __fmul_rn(u[j], -u[j]);
    const bool cephes = fabsf(y) < kCephesBelow;
    const uint32_t mc = __ballot_sync(0xffffffffu, cephes);
    const int r = __popc(mc & below);
    slot[j] = n_cephes + r + (cephes ? 0 : kWarpDraws - 1 - 32 * j - lane);
    list[slot[j]] = y;
    n_cephes += __popc(mc);
  }
  __syncwarp();
  for (int i = lane; i < n_cephes; i += 32) list[i] = log1p_cephes(list[i]);
  for (int i = n_cephes + lane; i < kWarpDraws; i += 32) list[i] = log1p_eigen(list[i]);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kDraws; ++j) lg[j] = list[slot[j]];
  __syncwarp();  // the list is free again
#pragma unroll
  for (int j = 0; j < kDraws; ++j) z[j] = __fmul_rn(1.4142135f, erf_inv_of(u[j], lg[j]));
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) { return __uint_as_float(b << 16); }

__device__ __forceinline__ uint32_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v[j] = x[start + j] as float for start + j < limit (0 past it): 16-byte
// (fp32, 4 elements) or 8-byte (bf16, 4 elements) loads where the run is
// whole and aligned
__device__ __forceinline__ void load_run(const Leaf& L, uint32_t start, uint32_t limit,
                                         float (&v)[kPairs]) {
  const bool whole = start + kPairs <= limit;
  if (L.bf16) {
    const uint16_t* x = static_cast<const uint16_t*>(L.x) + start;
    if (whole && aligned(x, 8)) {
#pragma unroll
      for (int j = 0; j < kPairs; j += 4) {
        const uint2 q = *reinterpret_cast<const uint2*>(x + j);
        v[j] = bf16_bits_to_float(q.x & 0xFFFFu);
        v[j + 1] = bf16_bits_to_float(q.x >> 16);
        v[j + 2] = bf16_bits_to_float(q.y & 0xFFFFu);
        v[j + 3] = bf16_bits_to_float(q.y >> 16);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        v[j] = start + j < limit ? bf16_bits_to_float(x[j]) : 0.0f;
    }
  } else {
    const float* x = static_cast<const float*>(L.x) + start;
    if (whole && aligned(x, 16)) {
#pragma unroll
      for (int j = 0; j < kPairs; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(x + j);
        v[j] = q.x;
        v[j + 1] = q.y;
        v[j + 2] = q.z;
        v[j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) v[j] = start + j < limit ? x[j] : 0.0f;
    }
  }
}

// out[start + j] = v[j] in the leaf's dtype for start + j < limit: 16- or
// 8-byte stores where the run is whole and aligned
__device__ __forceinline__ void store_run(const Leaf& L, uint32_t start, uint32_t limit,
                                          const float (&v)[kPairs]) {
  const bool whole = start + kPairs <= limit;
  if (L.bf16) {
    uint16_t* out = static_cast<uint16_t*>(L.out) + start;
    if (whole && aligned(out, 8)) {
#pragma unroll
      for (int j = 0; j < kPairs; j += 4)
        *reinterpret_cast<uint2*>(out + j) =
            make_uint2(float_to_bf16_bits(v[j]) | float_to_bf16_bits(v[j + 1]) << 16,
                       float_to_bf16_bits(v[j + 2]) | float_to_bf16_bits(v[j + 3]) << 16);
    } else {
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        if (start + j < limit) out[j] = static_cast<uint16_t>(float_to_bf16_bits(v[j]));
    }
  } else {
    float* out = static_cast<float*>(L.out) + start;
    if (whole && aligned(out, 16)) {
#pragma unroll
      for (int j = 0; j < kPairs; j += 4)
        *reinterpret_cast<float4*>(out + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        if (start + j < limit) out[j] = v[j];
    }
  }
}

__device__ __forceinline__ float scale_at(const Leaf& L, uint32_t p) {
  if (L.scale == nullptr) return L.scale_value;
  return L.scale[L.inner >= L.n ? 0u : p / L.inner];
}

__global__ void __launch_bounds__(kThreads)
    threefry_normal_axpy_kernel(const __grid_constant__ Table table) {
  __shared__ float lists[kThreads / 32][kWarpDraws];
  // the block's leaf: the last whose first block is at most this one
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.leaf[mid].first_block <= blockIdx.x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& L = table.leaf[lo];
  const uint32_t half = (L.n + 1u) / 2u;
  // the thread's first block; draws 0..kPairs-1 are the low half's
  // positions p.., draws kPairs.. the high half's p + half..
  const uint32_t p = ((blockIdx.x - L.first_block) * kThreads + threadIdx.x) * kPairs;
  float u[kDraws];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    u[j] = u[kPairs + j] = 0.0f;
    if (p + j < half) {
      uint32_t o0, o1;
      threefry::threefry_pair(L.k0, L.k1, p + j, L.n, o0, o1);
      u[j] = uniform_of(o0);
      if (p + half + j < L.n) u[kPairs + j] = uniform_of(o1);
    }
  }
  float z[kDraws];
  warp_normals(u, z, lists[threadIdx.x / 32]);
  float lo_x[kPairs], hi_x[kPairs];
  load_run(L, p, half, lo_x);
  load_run(L, p + half, L.n, hi_x);
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {  // a scale entry is read for positions in the leaf only
    if (p + j < half) lo_x[j] = __fadd_rn(lo_x[j], __fmul_rn(scale_at(L, p + j), z[j]));
    if (p + half + j < L.n)
      hi_x[j] = __fadd_rn(hi_x[j], __fmul_rn(scale_at(L, p + half + j), z[kPairs + j]));
  }
  store_run(L, p, half, lo_x);
  store_run(L, p + half, L.n, hi_x);
}

// out[i] = jax.random.normal's value of the word words[i], through the
// axpy kernel's warp_normals: a thread takes kDraws consecutive words
__global__ void __launch_bounds__(kThreads)
    threefry_normal_words_kernel(const uint32_t* __restrict__ words, float* __restrict__ out,
                                 uint32_t n) {
  __shared__ float lists[kThreads / 32][kWarpDraws];
  const uint32_t i0 = (blockIdx.x * kThreads + threadIdx.x) * kDraws;
  float u[kDraws];
#pragma unroll
  for (int j = 0; j < kDraws; ++j) u[j] = i0 + j < n ? uniform_of(words[i0 + j]) : 0.0f;
  float z[kDraws];
  warp_normals(u, z, lists[threadIdx.x / 32]);
#pragma unroll
  for (int j = 0; j < kDraws; ++j)
    if (i0 + j < n) out[i0 + j] = z[j];
}

}  // namespace

extern "C" {

int threefry_normal_max_leaves() { return kMaxLeaves; }

// leaves: `count` table entries (first_block ignored); one launch on
// `stream` over all of them
int threefry_normal_axpy(const Leaf* leaves, int count, cudaStream_t stream) {
  if (count <= 0 || count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Table table;
  uint32_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    const Leaf& L = leaves[i];
    if (L.n == 0 || L.n >= 0x80000000u || L.inner == 0 || L.x == nullptr ||
        L.out == nullptr || (L.bf16 != 0 && L.bf16 != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    table.leaf[i] = L;
    table.leaf[i].first_block = blocks;
    blocks += ((L.n + 1u) / 2u + kThreads * kPairs - 1) / (kThreads * kPairs);
  }
  table.count = count;
  threefry_normal_axpy_kernel<<<blocks, kThreads, 0, stream>>>(table);
  return static_cast<int>(cudaGetLastError());
}

// words (n,) uint32 -> out (n,) float32, jax.random.normal's value of each
// word: the check that holds the kernel's normal to the plain version on
// every fill; no path calls it
int threefry_normal_words(const uint32_t* words, float* out, int n, cudaStream_t stream) {
  if (n <= 0 || words == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t blocks = (static_cast<uint32_t>(n) + kThreads * kDraws - 1) / (kThreads * kDraws);
  threefry_normal_words_kernel<<<blocks, kThreads, 0, stream>>>(words, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
