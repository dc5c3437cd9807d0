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
// A thread owns one threefry block of its leaf (threefry.cuh): it hashes
// the block once and writes both positions the block serves, pair and
// pair + half. Leaf i's blocks start at first_block[i], so each block of
// 256 threads lies in one leaf.
//
// The normal of a word is jax 0.9.0's CPU program for jax.random.normal,
// written out operation by operation as ref.py's uniform_to_normal is:
// the fill f, u = max(lo, fmaf(f, 2, lo)), then XLA's ErfInv32 (Giles's
// two polynomials in w = -log1p(-u·u)) over XLA's CPU log1p (Cephes's
// rational form below sqrt(2) - 1, Eigen's float log of 1 + y above),
// every fused multiply-add of that program an fmaf and every other
// product, sum, quotient and root one IEEE operation (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so that nvcc contracts nothing on
// its own. The plain version takes each fmaf in fp64 (exact product, one
// rounding) and equals the true fma on all 2**23 values the fill gives:
// the kernel equals the plain version bit for bit, and both equal
// jax.random.normal on the CPU.
//
// Bound on an H100 SXM: bytes. At rnnt-librispeech's 35 leaves and
// 105,333,760 fp32 elements the call reads and writes 842.7 MB (0.252 ms
// at 3.35 TB/s); its 52.7 M threefry blocks at 75 int32 operations take
// about 0.237 ms on the INT32 lanes, and each element adds about 94 fp32
// operations (both branches of the log1p, the erf_inv polynomial, the
// scaled sum; about 0.148 ms) on the fp32 lanes beside them.
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

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
};

// XLA's CPU log1p of y in float32 (ref.py:xla_log1p_f32)
__device__ __forceinline__ float xla_log1p(float y) {
  // |y| < sqrt(2) - 1: y + (-y²/2 + y³ P(y) / Q(y)) (Cephes)
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
  const float small = __fadd_rn(y, fmaf(y2, -0.5f, __fmul_rn(__fmul_rn(y, y2), r)));
  // otherwise Eigen's plog_float of x = 1 + y
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
  const float large =
      fmaf(e, 0.693359375f, __fadd_rn(__fsub_rn(t, __fmul_rn(t2, 0.5f)), poly));
  return fabsf(y) < 0.41421357f ? small : large;
}

// XLA's float32 ErfInv (ref.py:xla_erf_inv_f32) of a uniform value u: the
// special cases of the plain version (1 + y at 0, below 0 or infinite in
// the log1p; |u| = 1) lie outside the values u takes, so the kernel leaves
// them out. The rare branch w >= 5 (about 0.3 % of the draws) is a branch,
// not a select, so that most warps skip its square root.
__device__ __forceinline__ float xla_erf_inv(float x) {
  const float lg = xla_log1p(__fmul_rn(x, -x));
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

// jax.random.normal's float32 value of one threefry word
// (ref.py:uniform_to_normal)
__device__ __forceinline__ float word_to_normal(uint32_t word) {
  const float lo = -(1.0f - 0x1p-24f);
  const float u = fmaxf(lo, fmaf(threefry::bits_to_unit(word), 2.0f, lo));
  return __fmul_rn(1.4142135f, xla_erf_inv(u));
}

__device__ __forceinline__ float load(const Leaf& L, uint32_t p) {
  return L.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(L.x)[p])
                : static_cast<const float*>(L.x)[p];
}

__device__ __forceinline__ void store(const Leaf& L, uint32_t p, float v) {
  if (L.bf16) {
    static_cast<__nv_bfloat16*>(L.out)[p] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(L.out)[p] = v;
  }
}

__device__ __forceinline__ float scale_at(const Leaf& L, uint32_t p) {
  if (L.scale == nullptr) return L.scale_value;
  return L.scale[L.inner >= L.n ? 0u : p / L.inner];
}

__device__ __forceinline__ void axpy_one(const Leaf& L, uint32_t p, uint32_t word) {
  store(L, p, __fadd_rn(load(L, p), __fmul_rn(scale_at(L, p), word_to_normal(word))));
}

__global__ void __launch_bounds__(kThreads)
    threefry_normal_axpy_kernel(const __grid_constant__ Table table) {
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
  const uint32_t pair = (blockIdx.x - L.first_block) * kThreads + threadIdx.x;
  const uint32_t half = (L.n + 1u) / 2u;
  if (pair >= half) return;
  uint32_t o0, o1;
  threefry::threefry_pair(L.k0, L.k1, pair, L.n, o0, o1);
  axpy_one(L, pair, o0);
  if (pair + half < L.n) axpy_one(L, pair + half, o1);
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
    blocks += ((L.n + 1u) / 2u + kThreads - 1) / kThreads;
  }
  table.count = count;
  threefry_normal_axpy_kernel<<<blocks, kThreads, 0, stream>>>(table);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
