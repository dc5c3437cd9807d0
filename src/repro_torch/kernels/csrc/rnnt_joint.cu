// Fused RNN-T joint kernels (K3 forward, K4 backward) for Hopper.
//
// Replaces the Pallas TPU kernels src/repro/kernels/rnnt_joint.py:86
// rnnt_joint_fused (_kernel, :34) and :251 rnnt_joint_bwd_fused
// (_bwd_eg_kernel, :175, and _bwd_w_kernel, :218). For every lattice
// point n = (b, t, u) of the (B, T, U1) lattice:
//
//   h      = tanh(e[b, t] + g[b, u])                        (J,)
//   logits = h @ W + bias                                   (V,)
//   lse    = logsumexp(logits)
//   blank  = logits[0] - lse,  label = logits[labels[b, u]] - lse
//
// and, from the saved lse and the cotangents dblank, dlabel,
//
//   dlogits = dblank·[v=0] + dlabel·[v=label] − (dblank+dlabel)·exp(logits − lse)
//   dpre    = (dlogits @ Wᵀ)·(1 − h²)
//   de[b,t] = Σ_u dpre,  dg[b,u] = Σ_t dpre,  dW = Σ_n h ⊗ dlogits,  db = Σ_n dlogits.
//
// The forward writes the (B, T, U1, V) logits once and reads them once;
// the backward writes their cotangent once and reads it twice.
//
// Bound on an H100 SXM: the operations. The forward is one
// (N × J)·(J × V) product, N = B·T·U1; at the paper-width client step
// (N = 8,448, J = 640, V = 4,096) that is 44.3 GFLOP, 0.66 ms at the
// 67 TFLOP/s fp32 rate, while its inputs are about 11 MB (W is 10.5 MB
// and stays in the 50 MB L2); its logits scratch (138.4 MB written and
// read, about 0.08 ms at 3.35 TB/s) is not counted, as the function does
// not need it. The backward computes the logits once and adds the dh and
// dW products: 133 GFLOP, 1.98 ms; its dlogits (138.4 MB at that width)
// written once and read twice move 415 MB, about 0.12 ms at 3.35 TB/s.
// The kernels use fp32 FMA on the CUDA cores (no tensor cores: TF32 or
// bf16 wgmma would change the numbers), so this is the bound they are
// held to.
//
// Design. The TPU kernel walks a (b, t-tile, u-tile, v-slab) grid in
// order and carries the online max/sum-exp and the dh sum in scratch
// from one grid step to the next, and keeps the logits out of HBM because
// its VMEM is small. Here blocks run in parallel and in no order, and
// every product runs on the register-blocked fp32 tile product of
// csrc/tile_product.cuh (64 x 128 tiles of 128 threads, 8 x 8 outputs a
// thread, 3 blocks an SM), each at the card's occupancy, with scratch the
// wrapper allocates:
//
// - K3 is three launches. joint_h_kernel writes h = tanh(e + g) (N × J
//   fp32, 21,626,880 B at the paper width); joint_logits_kernel computes
//   h·W + bias into logits (N × V fp32, 138,412,032 B), each logit one
//   fmaf chain over j in order from 0 plus the bias; joint_lse_kernel,
//   one warp a lattice point, takes the log-sum-exp over V in 128-column
//   slabs in slab order (lane tx holds columns v0 + tx + 32c, c = 0..3: the
//   slab's max by a shuffle tree, its sum of exponentials by lane in c
//   order then by the xor tree, merged into the running sum as l·e^(m −
//   m') + s), and the blank and label log-probs. The design before, one
//   block a 32-point tile with h in shared memory and W streamed through
//   it, took these sums in this order: this design keeps its bits, at 3
//   blocks an SM where it held 2, with shared memory that no longer grows
//   with J.
// - K4 is five launches: joint_h_kernel again; joint_dlogits_kernel
//   computes h·W and writes dlogits from the logits in its epilogue
//   (N × V fp32), and dh_fix (N × 2 fp32, 67,584 B), dh's operand at v = 0
//   and at the label (see dlogit_dh); joint_dh_kernel computes dlogits·Wᵀ
//   with those two values replaced and writes dpre = dh·(1 − h²);
//   joint_bwd_reduce_kernel takes de and dg as sums over u and over t in
//   a fixed order (the TPU sums its dg partials outside the kernel too,
//   rnnt_joint.py:309); joint_dw_kernel computes hᵀ·dlogits into dW, and
//   its first row of tiles sums db from the same dlogits slabs. No
//   atomics. Each logit is one fmaf chain over j in order from 0, dh one
//   chain for each 128-column vocab slab and dW and db one for each
//   32-point lattice tile, added into running sums in order: the bits of
//   the design before, which recomputed the logits in two kernels.
//
// Every (N × V) index is 64-bit.
//
// Every sum is taken in a fixed order, so the forward and the backward
// give the same bits on every run. Math is fp32 with expf/logf/tanhf (no
// fast math); e and g may be fp32 or bf16, W, bias, lse and the cotangents
// are fp32, labels int32 in [0, V).
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches one kernel on the caller's stream, allocates
// nothing, and returns a cudaError_t as int so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <cstdint>

#include "tile_product.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: the log-sum-exp's lattice points a block
// the lattice tile and vocab slab of the designs before, whose sums these
// keep: dW's and db's runs, and the forward's and dh's slabs
constexpr int kM = 32;
constexpr int kTV = 128;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Lattice {
  long long N;  // B·T·U1
  int T, U1, J, V;
};

// The softmax cotangent of one logit (rnnt_joint.py:148-172), in the
// TPU kernel's order of operations: -(dbl + dlb)·exp(logit − lse), + dbl
// at v = 0, + dlb at the label. The design before this one (whose bits
// this design keeps: PERF.md) computed it in two kernels, and nvcc
// contracted the product with the sums differently in each: as dlogit
// for dW and db, as dlogit_dh for dh. The two differ only at v = 0 and at
// the label. Both are written out so that no compiler choice moves them.
__device__ __forceinline__ float dlogit(float logit, float lse, float dbl, float dlb, int v,
                                        int label) {
  const float p = expf(logit - lse), m = -(dbl + dlb);
  float d = v == 0 ? fmaf(m, p, dbl) : __fmul_rn(m, p);
  if (v == label) d = __fadd_rn(d, dlb);
  return d;
}
__device__ __forceinline__ float dlogit_dh(float logit, float lse, float dbl, float dlb, int v,
                                           int label) {
  const float p = expf(logit - lse), m = -(dbl + dlb);
  if (v == 0) {
    const float d = fmaf(m, p, dbl);
    return v == label ? __fadd_rn(d, dlb) : d;
  }
  return v == label ? fmaf(m, p, dlb) : __fmul_rn(m, p);
}

// ---- The forward (K3): h, the logits on the tile product, their log-sum-exp ----

// logits[n, v] = h[n] · W[:, v] + bias[v]: the tile product with A = h (its
// rows run along k = j) and B = W as it lies, as joint_dlogits_kernel
// computes it; each logit is one fmaf chain over j in order from 0, then
// one add of the bias, as the design before computed it.
template <bool VEC>
__global__ void __launch_bounds__(tile::kThreads, tile::kBlocksPerSm)
    joint_logits_kernel(Lattice L, const float* __restrict__ h, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ logits) {
  const long long m0 = static_cast<long long>(blockIdx.y) * tile::kM;
  const int c0 = blockIdx.x * tile::kC;
  tile::ColSlab<tile::kM, VEC> a;
  tile::RowSlab<tile::kC, VEC> bw;
  float acc[8][8];
  tile::mainloop<0>(
      [&](tile::ASlab&, tile::BSlab& bs, int s) {
        const int k0 = s * tile::kK;
        a.stage(h, L.J, k0, L.J, m0, L.N);
        bw.stage(bs, w, L.V, k0, L.J, c0, L.V);
      },
      [&](tile::ASlab& as, tile::BSlab&, int) { a.land(as); }, tile::NoSlabHook(),
      (L.J + tile::kK - 1) / tile::kK, acc, nullptr);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int v = c0 + tile::col(q);
    const float bv = v < L.V ? bias[v] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][q] = __fadd_rn(acc[i][q], bv);
  }
  tile::store<VEC>(acc, logits, L.V, m0, L.N, c0, L.V);
}

// blank, label and lse of lattice point n from its logits row, one warp a
// point, in the design before's order: V in kTV-column slabs in slab
// order; lane tx holds columns v0 + tx + 32c (c = 0..3, -inf past V); the
// slab's max by the shuffle tree; each lane's exponentials summed in c
// order from 0, then across the warp by the xor tree; the running sum l
// and max m merged as l·e^(m − m') + s with one fma (as nvcc contracted
// it); lse = m + log(max(l, 1e-30)). Every rounding is written out.
__global__ void __launch_bounds__(kThreads)
    joint_lse_kernel(Lattice L, const float* __restrict__ logits, const int* __restrict__ labels,
                     float* __restrict__ blank_out, float* __restrict__ label_out,
                     float* __restrict__ lse_out) {
  constexpr int NC = kTV / 32;
  const int tx = threadIdx.x & 31;
  const long long n = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (n >= L.N) return;  // the whole warp
  const float* row = logits + n * L.V;
  float m_run = -INFINITY, l_run = 0.f;
#pragma unroll 2
  for (int v0 = 0; v0 < L.V; v0 += kTV) {
    float lg[NC], mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int v = v0 + tx + 32 * c;
      lg[c] = v < L.V ? row[v] : -INFINITY;
      mx = fmaxf(mx, lg[c]);
    }
    const float nm = fmaxf(m_run, warp_max(mx));  // finite: column v0 < V is in the slab
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) s = __fadd_rn(s, expf(__fsub_rn(lg[c], nm)));
    l_run = fmaf(l_run, expf(__fsub_rn(m_run, nm)), warp_sum(s));
    m_run = nm;
  }
  if (tx == 0) {
    const long long bt = n / L.U1, b = bt / L.T, u = n - bt * L.U1;
    const int label = labels[b * L.U1 + u];
    const float s = __fadd_rn(m_run, logf(fmaxf(l_run, 1e-30f)));
    blank_out[n] = __fsub_rn(row[0], s);
    label_out[n] = __fsub_rn(label >= 0 && label < L.V ? row[label] : 0.f, s);
    lse_out[n] = s;
  }
}

// ---- The backward (K4): three tile products over a materialized dlogits ----

// The design before this one summed dh over 128-column vocab slabs (kTV)
// and dW and db over 32-point lattice tiles (kM), each slab's or tile's
// fmaf chain added into a running sum in order; the products keep those
// runs, so they keep its bits: runs of kDhChunk and kDwChunk slabs of k.
constexpr int kDhChunk = kTV / tile::kK;
constexpr int kDwChunk = kM / tile::kK;

// h[n, j] = tanh(e[b, t, j] + g[b, u, j]) for the lattice point n = (b, t,
// u) of the block: the first launch of K3 and of K4.
template <typename T>
__global__ void __launch_bounds__(128)
    joint_h_kernel(Lattice L, const T* __restrict__ e, const T* __restrict__ g,
                   float* __restrict__ h) {
  const long long n = blockIdx.x;
  const long long bt = n / L.U1, b = bt / L.T, u = n - bt * L.U1;
  const T* er = e + bt * L.J;
  const T* gr = g + (b * L.U1 + u) * L.J;
  float* hr = h + n * L.J;
  for (int j = threadIdx.x; j < L.J; j += blockDim.x) hr[j] = tanhf(to_f(er[j]) + to_f(gr[j]));
}

// dlogits[n, v] = dlogit(h[n] · W[:, v] + bias[v]): the tile product with A
// = h (its rows run along k = j) and B = W as it lies; each logit is one
// fmaf chain over j in order from 0, as the design before computed it.
// dh_fix[n] = dlogit_dh at v = 0 and at the label of n, the two values of
// dh's operand that differ from dlogits.
template <bool VEC>
__global__ void __launch_bounds__(tile::kThreads, tile::kBlocksPerSm)
    joint_dlogits_kernel(Lattice L, const float* __restrict__ h, const float* __restrict__ w,
                         const float* __restrict__ bias, const int* __restrict__ labels,
                         const float* __restrict__ lse, const float* __restrict__ dblank,
                         const float* __restrict__ dlabel, float* __restrict__ dlogits,
                         float2* __restrict__ dh_fix) {
  const long long m0 = static_cast<long long>(blockIdx.y) * tile::kM;
  const int c0 = blockIdx.x * tile::kC;
  tile::ColSlab<tile::kM, VEC> a;
  tile::RowSlab<tile::kC, VEC> bw;
  float acc[8][8];
  tile::mainloop<0>(
      [&](tile::ASlab&, tile::BSlab& bs, int s) {
        const int k0 = s * tile::kK;
        a.stage(h, L.J, k0, L.J, m0, L.N);
        bw.stage(bs, w, L.V, k0, L.J, c0, L.V);
      },
      [&](tile::ASlab& as, tile::BSlab&, int) { a.land(as); }, tile::NoSlabHook(),
      (L.J + tile::kK - 1) / tile::kK, acc, nullptr);
  float bv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int v = c0 + tile::col(q);
    bv[q] = v < L.V ? bias[v] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long n = m0 + tile::row(i);
    if (n >= L.N) continue;
    const long long bt = n / L.U1, b = bt / L.T, u = n - bt * L.U1;
    const int label = labels[b * L.U1 + u];
    const float ls = lse[n], dbl = dblank[n], dlb = dlabel[n];
    float* out = dlogits + n * L.V;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + tile::col(half * 4);
      float d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = c + q;
        const float logit = acc[i][half * 4 + q] + bv[half * 4 + q];
        d[q] = dlogit(logit, ls, dbl, dlb, v, label);
        if (v == 0) dh_fix[n].x = dlogit_dh(logit, ls, dbl, dlb, v, label);
        if (v == label) dh_fix[n].y = dlogit_dh(logit, ls, dbl, dlb, v, label);
      }
      if constexpr (VEC) {
        if (c < L.V) *reinterpret_cast<float4*>(out + c) = make_float4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < L.V) out[c + q] = d[q];
        }
      }
    }
  }
}

// dpre[n, j] = (dlogits[n] · W[j, :]) · (1 − h[n, j]²): the tile product
// with A = dlogits, its values at v = 0 and at the label replaced by
// dh_fix's, and B = Wᵀ, both read along their rows of V, in runs of
// kDhChunk slabs (a 128-column vocab slab each) added into a running sum in
// shared memory (run: tile::kRunFloats floats).
template <bool VEC>
__global__ void __launch_bounds__(tile::kThreads, tile::kBlocksPerSm)
    joint_dh_kernel(Lattice L, const float* __restrict__ dlogits,
                    const float2* __restrict__ dh_fix, const int* __restrict__ labels,
                    const float* __restrict__ w, const float* __restrict__ h,
                    float* __restrict__ dpre) {
  extern __shared__ __align__(16) float run[];
  using ASlabLoader = tile::ColSlab<tile::kM, VEC>;
  const long long m0 = static_cast<long long>(blockIdx.y) * tile::kM;
  const int c0 = blockIdx.x * tile::kC;
  ASlabLoader a;
  tile::ColSlab<tile::kC, VEC> bt;
  // the label and dh_fix of the row of each of this thread's A runs
  int label[ASlabLoader::kRuns];
  float2 fix[ASlabLoader::kRuns];
#pragma unroll
  for (int i = 0; i < ASlabLoader::kRuns; ++i) {
    const long long n = m0 + ASlabLoader::x(i);
    label[i] = -1;  // past N: the run stays zero
    fix[i] = make_float2(0.f, 0.f);
    if (n < L.N) {
      const long long bt_ = n / L.U1, b = bt_ / L.T, u = n - bt_ * L.U1;
      label[i] = labels[b * L.U1 + u];
      fix[i] = dh_fix[n];
    }
  }
  float acc[8][8];
  tile::mainloop<kDhChunk>(
      [&](tile::ASlab&, tile::BSlab&, int s) {
        const int k0 = s * tile::kK;
        a.stage(dlogits, L.V, k0, L.V, m0, L.N);
#pragma unroll
        for (int i = 0; i < ASlabLoader::kRuns; ++i) {
          const int k = k0 + ASlabLoader::kq(i);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k + e == 0 && label[i] >= 0) a.r[i][e] = fix[i].x;
            if (k + e == label[i]) a.r[i][e] = fix[i].y;
          }
        }
        bt.stage(w, L.V, k0, L.V, c0, L.J);
      },
      [&](tile::ASlab& as, tile::BSlab& bs, int) {
        a.land(as);
        bt.land(bs);
      },
      tile::NoSlabHook(), (L.V + tile::kK - 1) / tile::kK, acc, run);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long n = m0 + tile::row(i);
    if (n >= L.N) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = c0 + tile::col(q);
      if (j < L.J) {
        const size_t at = static_cast<size_t>(n) * L.J + j;
        const float hv = h[at];
        // dh·(1 − h·h) contracted as nvcc compiled the design before this
        // one (whose bits this design keeps: PERF.md), written out
        dpre[at] = acc[i][q] * fmaf(-hv, hv, 1.f);
      }
    }
  }
}

// dW[j, v] = Σ_n h[n, j] · dlogits[n, v] and db[v] = Σ_n dlogits[n, v]: the
// tile product with A = hᵀ (h's rows as they lie) and B = dlogits, in runs
// of kDwChunk slabs (a 32-point lattice tile each) added into a running sum
// in shared memory (run: tile::kRunFloats floats). The blocks of the first
// row of tiles also sum db from the dlogits slabs they hold, thread c
// column c, in the same runs.
template <bool VEC>
__global__ void __launch_bounds__(tile::kThreads, tile::kBlocksPerSm)
    joint_dw_kernel(Lattice L, const float* __restrict__ h, const float* __restrict__ dlogits,
                    float* __restrict__ dw, float* __restrict__ db) {
  extern __shared__ __align__(16) float run[];
  const int m0 = blockIdx.y * tile::kM, c0 = blockIdx.x * tile::kC;
  const int nslab = static_cast<int>((L.N + tile::kK - 1) / tile::kK);
  const bool sums_db = blockIdx.y == 0;
  tile::RowSlab<tile::kM, VEC> ah;
  tile::RowSlab<tile::kC, VEC> bd;
  float db_part = 0.f, db_run = 0.f, acc[8][8];
  tile::mainloop<kDwChunk>(
      [&](tile::ASlab& as, tile::BSlab& bs, int s) {
        const int k0 = s * tile::kK;
        ah.stage(as, h, L.J, k0, L.N, m0, L.J);
        bd.stage(bs, dlogits, L.V, k0, L.N, c0, L.V);
      },
      [&](tile::ASlab&, tile::BSlab&, int) {},
      [&](const tile::BSlab& bs, int s) {
        if (sums_db) {
#pragma unroll
          for (int kk = 0; kk < tile::kK; ++kk) db_part += bs[kk][threadIdx.x];
          if ((s + 1) % kDwChunk == 0 || s + 1 == nslab) {
            db_run += db_part;
            db_part = 0.f;
          }
        }
      },
      nslab, acc, run);
  tile::store<VEC>(acc, dw, L.V, m0, L.J, c0, L.V);
  if (sums_db && c0 + static_cast<int>(threadIdx.x) < L.V) db[c0 + threadIdx.x] = db_run;
}

// de[b, t, j] = Σ_u dpre[b, t, u, j] and dg[b, u, j] = Σ_t dpre[b, t, u, j],
// each summed in index order by one thread.
__global__ void __launch_bounds__(kThreads)
    joint_bwd_reduce_kernel(Lattice L, long long BT, long long BU,
                            const float* __restrict__ dpre, float* __restrict__ de,
                            float* __restrict__ dg) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int J = L.J;
  if (idx < BT * J) {
    const long long bt = idx / J, j = idx - bt * J;
    const float* p = dpre + bt * L.U1 * J + j;
    float s = 0.f;
    for (int u = 0; u < L.U1; ++u) s += p[static_cast<long long>(u) * J];
    de[idx] = s;
  } else if (idx < (BT + BU) * J) {
    const long long k = idx - BT * J;
    const long long bu = k / J, j = k - bu * J;
    const long long b = bu / L.U1, u = bu - b * L.U1;
    const float* p = dpre + (b * L.T * L.U1 + u) * J + j;
    float s = 0.f;
    for (int t = 0; t < L.T; ++t) s += p[static_cast<long long>(t) * L.U1 * J];
    dg[k] = s;
  }
}

// Allow the kernel more than the default 48 KB of dynamic shared
// memory. The attribute belongs to the current device, so it is set on
// every launch (microseconds, next to a kernel of milliseconds).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_shape(int B, int T, int U1, int J, int V) {
  return B <= 0 || T <= 0 || U1 <= 0 || J <= 0 || V <= 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The products' grid: tiles of (rows, columns)
dim3 tile_grid(long long rows, long long cols) {
  return dim3(static_cast<unsigned>((cols + tile::kC - 1) / tile::kC),
              static_cast<unsigned>((rows + tile::kM - 1) / tile::kM));
}

// One launch of a product kernel, in its VEC or element-wise route.
template <typename KVec, typename KElem, typename... Args>
cudaError_t launch_product(KVec kvec, KElem kelem, bool vec, dim3 grid, size_t smem,
                           cudaStream_t s, Args... args) {
  if (smem > 0) {
    cudaError_t err = allow_smem(vec ? kvec : kelem, smem);
    if (err != cudaSuccess) return err;
  }
  if (vec) {
    kvec<<<grid, tile::kThreads, smem, s>>>(args...);
  } else {
    kelem<<<grid, tile::kThreads, smem, s>>>(args...);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 e and g, 1 = bfloat16. w, b, lse, the cotangents
// and every output are float32; labels int32 (B, U1). Tensors are
// contiguous: e (B, T, J), g (B, U1, J), w (J, V), b (V,), blank, label,
// lse, dblank, dlabel (B, T, U1). Each entry point returns a cudaError_t
// as int.

// h (B, T, U1, J) float32 = tanh(e + g) through the h kernel: the first
// launch of the forward and of the backward.
extern "C" int rnnt_joint_h(int dtype, const void* e, const void* g, void* h, int B, int T,
                            int U1, int J, void* stream) {
  if (bad_shape(B, T, U1, J, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(L.N);
  float* hp = static_cast<float*>(h);
  if (dtype == 0) {
    joint_h_kernel<float><<<blocks, 128, 0, s>>>(L, static_cast<const float*>(e),
                                                 static_cast<const float*>(g), hp);
  } else if (dtype == 1) {
    joint_h_kernel<__nv_bfloat16><<<blocks, 128, 0, s>>>(
        L, static_cast<const __nv_bfloat16*>(e), static_cast<const __nv_bfloat16*>(g), hp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits (B, T, U1, V) float32 = h·w + b from h (B, T, U1, J) float32
// through the logits kernel.
extern "C" int rnnt_joint_fwd_logits(const void* h, const void* w, const void* b,
                                     void* logits, int B, int T, int U1, int J, int V,
                                     void* stream) {
  if (bad_shape(B, T, U1, J, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  const bool vec = J % 4 == 0 && V % 4 == 0 && aligned16(h) && aligned16(w) &&
                   aligned16(logits);
  return static_cast<int>(launch_product(
      joint_logits_kernel<true>, joint_logits_kernel<false>, vec, tile_grid(L.N, V), 0,
      static_cast<cudaStream_t>(stream), L, static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(logits)));
}

// blank, label and lse (B, T, U1) float32 from the logits (B, T, U1, V)
// and the labels through the log-sum-exp kernel.
extern "C" int rnnt_joint_fwd_lse(const void* logits, const void* labels, void* blank,
                                  void* label, void* lse, int B, int T, int U1, int V,
                                  void* stream) {
  if (bad_shape(B, T, U1, 1, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, 1, V};
  constexpr int per_block = kThreads / 32;
  joint_lse_kernel<<<static_cast<unsigned>((L.N + per_block - 1) / per_block), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<float*>(blank), static_cast<float*>(label), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

// dlogits (B, T, U1, V) float32 and dh_fix (B, T, U1, 2) float32 (dh's
// operand at v = 0 and at the label) from h (B, T, U1, J) float32 and the
// forward's inputs and lse, through the dlogits kernel.
extern "C" int rnnt_joint_bwd_dlogits(const void* h, const void* w, const void* b,
                                      const void* labels, const void* lse, const void* dblank,
                                      const void* dlabel, void* dlogits, void* dh_fix, int B,
                                      int T, int U1, int J, int V, void* stream) {
  if (bad_shape(B, T, U1, J, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  const bool vec = J % 4 == 0 && V % 4 == 0 && aligned16(h) && aligned16(w) &&
                   aligned16(dlogits);
  return static_cast<int>(launch_product(
      joint_dlogits_kernel<true>, joint_dlogits_kernel<false>, vec, tile_grid(L.N, V), 0,
      static_cast<cudaStream_t>(stream), L, static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(dblank), static_cast<const float*>(dlabel),
      static_cast<float*>(dlogits), static_cast<float2*>(dh_fix)));
}

// dpre (B, T, U1, J) float32 from dlogits, dh_fix, the labels, W and h
// through the dh kernel.
extern "C" int rnnt_joint_bwd_dh(const void* dlogits, const void* dh_fix, const void* labels,
                                 const void* w, const void* h, void* dpre, int B, int T, int U1,
                                 int J, int V, void* stream) {
  if (bad_shape(B, T, U1, J, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  const bool vec = V % 4 == 0 && aligned16(dlogits) && aligned16(w);
  return static_cast<int>(launch_product(
      joint_dh_kernel<true>, joint_dh_kernel<false>, vec, tile_grid(L.N, J),
      tile::kRunFloats * sizeof(float), static_cast<cudaStream_t>(stream), L,
      static_cast<const float*>(dlogits), static_cast<const float2*>(dh_fix),
      static_cast<const int*>(labels), static_cast<const float*>(w),
      static_cast<const float*>(h), static_cast<float*>(dpre)));
}

// de (B, T, J) and dg (B, U1, J) from dpre (B, T, U1, J) through the
// reduce kernel.
extern "C" int rnnt_joint_bwd_reduce(const void* dpre, void* de, void* dg, int B, int T, int U1,
                                     int J, void* stream) {
  if (bad_shape(B, T, U1, J, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, 1};
  const long long BT = static_cast<long long>(B) * T, BU = static_cast<long long>(B) * U1;
  const long long total = (BT + BU) * J;
  joint_bwd_reduce_kernel<<<static_cast<unsigned int>((total + kThreads - 1) / kThreads),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      L, BT, BU, static_cast<const float*>(dpre), static_cast<float*>(de),
      static_cast<float*>(dg));
  return static_cast<int>(cudaGetLastError());
}

// dw (J, V) and db (V,) float32 from h and dlogits through the dw kernel.
extern "C" int rnnt_joint_bwd_dw(const void* h, const void* dlogits, void* dw, void* db, int B,
                                 int T, int U1, int J, int V, void* stream) {
  if (bad_shape(B, T, U1, J, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  const bool vec = J % 4 == 0 && V % 4 == 0 && aligned16(h) && aligned16(dlogits) &&
                   aligned16(dw);
  return static_cast<int>(launch_product(
      joint_dw_kernel<true>, joint_dw_kernel<false>, vec, tile_grid(J, V),
      tile::kRunFloats * sizeof(float), static_cast<cudaStream_t>(stream), L,
      static_cast<const float*>(h), static_cast<const float*>(dlogits),
      static_cast<float*>(dw), static_cast<float*>(db)));
}
