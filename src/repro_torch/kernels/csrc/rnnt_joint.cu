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
// The (B, T, U1, V) logits never exist in device memory, in either
// direction: the forward writes 3 floats per lattice point.
//
// Bound on an H100 SXM: the operations. The forward is one
// (N × J)·(J × V) product, N = B·T·U1; at the paper-width client step
// (N = 8,448, J = 640, V = 4,096) that is 44.3 GFLOP, 0.66 ms at the
// 67 TFLOP/s fp32 rate, while its inputs are about 11 MB (W is 10.5 MB
// and stays in the 50 MB L2). The backward recomputes the logits twice
// and adds the dh and dW products: 177 GFLOP, 2.64 ms. The kernels use
// fp32 FMA on the CUDA cores (no tensor cores: TF32 or bf16 wgmma would
// change the numbers), so this is the bound they are held to.
//
// Design. The TPU kernel walks a (b, t-tile, u-tile, v-slab) grid in
// order and carries the online max/sum-exp and the dh sum in scratch
// from one grid step to the next. Here blocks run in parallel and in no
// order, so each block owns its work and loops over the sequential axis
// itself:
//
// - joint_fwd_kernel (K3): one block per tile of kM consecutive lattice
//   points (the flattened (b, t, u) index, so a ragged T or U1 wastes
//   at most one partial tile: 8,448 points are 264 full tiles). h for
//   the tile stays in shared memory; W streams through shared memory in
//   (kKC × kTV) chunks for each vocab slab; each thread keeps a 4 × 4
//   register tile of logits; the online max and sum-exp of each row are
//   reduced across its warp with shuffles. Ragged V is masked.
// - joint_bwd_eg_kernel (K4, the counterpart of _bwd_eg_kernel): the
//   same tiles; per slab it recomputes the logits, forms dlogits in
//   shared memory and adds dlogits·W_slabᵀ to dh, held in shared memory
//   for the whole tile. It writes dpre per lattice point; then
//   joint_bwd_reduce_kernel takes de and dg as sums over u and over t
//   in a fixed order (the TPU sums its dg partials outside the kernel
//   too, rnnt_joint.py:309). No atomics.
// - joint_bwd_w_kernel (K4, the counterpart of _bwd_w_kernel): one
//   block per vocab slab of kTVW columns. Its (J × kTVW) dW and its db
//   stay on chip while the whole lattice streams past, one tile at a
//   time, so each column is summed by one block in one order. No atomics.
//
// h rows are padded to a multiple of 4 floats, so the products read h
// from shared memory 16 bytes at a time.
//
// Every sum is taken in a fixed order, so the backward gives the same
// bits on every run. Math is fp32 with expf/logf/tanhf (no fast math);
// e and g may be fp32 or bf16, W, bias, lse and the cotangents are fp32,
// labels int32 in [0, V).
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches one kernel on the caller's stream, allocates
// nothing, and returns a cudaError_t as int so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps; warp ty owns rows 4·ty .. 4·ty + 3
constexpr int kM = 32;         // lattice points per tile
constexpr int kKC = 32;        // rows of W per streamed chunk
constexpr int kTV = 128;       // vocab slab of the forward and the eg kernel
constexpr int kTVW = 32;       // vocab slab of one block of the w kernel

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

// Row stride of the h tile in shared memory: J rounded up to 4, so that
// four consecutive h values of a row load as one 16-byte access; the
// padding columns hold zeros.
__host__ __device__ __forceinline__ int padded(int J) { return (J + 3) & ~3; }

// Fill hs (kM × padded(J)) with h = tanh(e + g) for the tile starting
// at n0 (zero rows past N), one warp per row, and the tile's per-row
// labels, lse and cotangents (the last three only when lse is given).
template <typename T>
__device__ void load_tile(const Lattice& L, const T* __restrict__ e, const T* __restrict__ g,
                          const int* __restrict__ labels, const float* __restrict__ lse,
                          const float* __restrict__ dblank, const float* __restrict__ dlabel,
                          long long n0, float* hs, int* lbl_s, float* lse_s, float* dbl_s,
                          float* dlb_s) {
  const int J = L.J, Jp = padded(J);
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < kM; m += kThreads / 32) {
    const long long n = n0 + m;
    float* hrow = hs + m * Jp;
    if (n < L.N) {
      const long long bt = n / L.U1;  // b·T + t
      const long long b = bt / L.T, u = n - bt * L.U1;
      const T* er = e + bt * J;
      const T* gr = g + (b * L.U1 + u) * J;
      for (int j = lane; j < Jp; j += 32)
        hrow[j] = j < J ? tanhf(to_f(er[j]) + to_f(gr[j])) : 0.f;
      if (lane == 0) lbl_s[m] = labels[b * L.U1 + u];
    } else {
      for (int j = lane; j < Jp; j += 32) hrow[j] = 0.f;
      if (lane == 0) lbl_s[m] = -1;
    }
    if (lse != nullptr && lane == 0) {
      const bool ok = n < L.N;
      lse_s[m] = ok ? lse[n] : 0.f;
      dbl_s[m] = ok ? dblank[n] : 0.f;
      dlb_s[m] = ok ? dlabel[n] : 0.f;
    }
  }
}

// Rows j0 .. j0 + kKC of W, columns v0 .. v0 + 32·NC, into ws (row
// stride 32·NC + 1, so that reading a column across a warp is free of
// bank conflicts); zero past J and V.
template <int NC>
__device__ void load_w_chunk(const Lattice& L, const float* __restrict__ w, int j0, int v0,
                             float* ws) {
  constexpr int width = 32 * NC, stride = width + 1;
  for (int idx = threadIdx.x; idx < kKC * width; idx += kThreads) {
    const int r = idx / width, c = idx - r * width;
    const int j = j0 + r, v = v0 + c;
    ws[r * stride + c] = (j < L.J && v < L.V) ? w[static_cast<long long>(j) * L.V + v] : 0.f;
  }
}

// acc[i][c] = Σ_j hs[4·ty + i][j] · W[j][v0 + tx + 32·c]: the tile's
// logits for one vocab slab of 32·NC columns, without the bias. Four
// values of j at a time: one 16-byte load of h per row (the padding
// columns of h and the rows of W past J are zero).
template <int NC>
__device__ __forceinline__ void slab_logits(const Lattice& L, const float* hs,
                                            const float* __restrict__ w, int v0, float* ws,
                                            float acc[4][NC]) {
  constexpr int stride = 32 * NC + 1;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int Jp = padded(L.J);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int j0 = 0; j0 < Jp; j0 += kKC) {
    __syncthreads();  // the previous chunk's readers are done with ws
    load_w_chunk<NC>(L, w, j0, v0, ws);
    __syncthreads();
    const int kmax = min(kKC, Jp - j0);  // a multiple of 4
    const float* hrow = hs + (4 * ty) * Jp + j0;
    for (int k = 0; k < kmax; k += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // one address per warp: broadcast
        a[i] = *reinterpret_cast<const float4*>(hrow + i * Jp + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bw[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) bw[c] = ws[(k + kk) * stride + tx + 32 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(av, bw[c], acc[i][c]);
        }
      }
    }
  }
}

// The softmax cotangent of one logit (rnnt_joint.py:148-172), in the
// TPU kernel's order of operations.
__device__ __forceinline__ float dlogit(float logit, float lse, float dbl, float dlb, int v,
                                        int label) {
  float d = -(dbl + dlb) * expf(logit - lse);
  if (v == 0) d += dbl;
  if (v == label) d += dlb;
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    joint_fwd_kernel(Lattice L, const T* __restrict__ e, const T* __restrict__ g,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     const int* __restrict__ labels, float* __restrict__ blank_out,
                     float* __restrict__ label_out, float* __restrict__ lse_out) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                             // kM × padded(J)
  float* ws = hs + kM * padded(L.J);            // kKC × (kTV + 1)
  float* blk_s = ws + kKC * (kTV + 1);          // kM
  float* lab_s = blk_s + kM;                    // kM
  int* lbl_s = reinterpret_cast<int*>(lab_s + kM);  // kM
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long n0 = static_cast<long long>(blockIdx.x) * kM;

  load_tile(L, e, g, labels, nullptr, nullptr, nullptr, n0, hs, lbl_s, nullptr, nullptr,
            nullptr);
  for (int m = threadIdx.x; m < kM; m += kThreads) blk_s[m] = lab_s[m] = 0.f;

  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  float acc[4][4];
  for (int v0 = 0; v0 < L.V; v0 += kTV) {
    slab_logits<4>(L, hs, w, v0, ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * ty + i;
      const int label = lbl_s[m];
      float lg[4], mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = v0 + tx + 32 * c;
        lg[c] = v < L.V ? acc[i][c] + bias[v] : -INFINITY;
        mx = fmaxf(mx, lg[c]);
        if (v == 0) blk_s[m] = lg[c];
        if (v == label) lab_s[m] = lg[c];
      }
      const float nm = fmaxf(m_run[i], warp_max(mx));  // finite: column v0 < V is in the slab
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) s += expf(lg[c] - nm);
      l_run[i] = l_run[i] * expf(m_run[i] - nm) + warp_sum(s);
      m_run[i] = nm;
    }
  }
  __syncthreads();  // blk_s / lab_s
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * ty + i;
      const long long n = n0 + m;
      if (n < L.N) {
        const float s = m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
        blank_out[n] = blk_s[m] - s;
        label_out[n] = lab_s[m] - s;
        lse_out[n] = s;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    joint_bwd_eg_kernel(Lattice L, const T* __restrict__ e, const T* __restrict__ g,
                        const float* __restrict__ w, const float* __restrict__ bias,
                        const int* __restrict__ labels, const float* __restrict__ lse,
                        const float* __restrict__ dblank, const float* __restrict__ dlabel,
                        float* __restrict__ dpre_out) {
  extern __shared__ __align__(16) float smem[];
  const int J = L.J;
  float* hs = smem;                         // kM × padded(J)
  float* dhs = hs + kM * padded(J);         // kM × J
  float* ws = dhs + kM * J;                 // kKC × (kTV + 1)
  float* ds = ws + kKC * (kTV + 1);         // kM × kTV
  float* lse_s = ds + kM * kTV;             // kM
  float* dbl_s = lse_s + kM;                // kM
  float* dlb_s = dbl_s + kM;                // kM
  int* lbl_s = reinterpret_cast<int*>(dlb_s + kM);  // kM
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long n0 = static_cast<long long>(blockIdx.x) * kM;

  load_tile(L, e, g, labels, lse, dblank, dlabel, n0, hs, lbl_s, lse_s, dbl_s, dlb_s);
  for (int idx = threadIdx.x; idx < kM * J; idx += kThreads) dhs[idx] = 0.f;

  float acc[4][4];
  for (int v0 = 0; v0 < L.V; v0 += kTV) {
    slab_logits<4>(L, hs, w, v0, ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * ty + i;
      const bool row = n0 + m < L.N;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = v0 + tx + 32 * c;
        ds[m * kTV + tx + 32 * c] =
            (row && v < L.V)
                ? dlogit(acc[i][c] + bias[v], lse_s[m], dbl_s[m], dlb_s[m], v, lbl_s[m])
                : 0.f;
      }
    }
    // dh[m][j] += Σ_v ds[m][v] · W[j][v0 + v], W streamed again by rows of J
    const int vmax = min(kTV, L.V - v0);
    for (int j0 = 0; j0 < J; j0 += kKC) {
      __syncthreads();  // ds is written; the previous chunk's readers are done
      load_w_chunk<4>(L, w, j0, v0, ws);
      __syncthreads();
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      const float* wrow = ws + tx * (kTV + 1);
      const float* drow = ds + (4 * ty) * kTV;
      for (int v = 0; v < vmax; ++v) {
        const float wv = wrow[v];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = fmaf(drow[i * kTV + v], wv, a[i]);
      }
      if (j0 + tx < J) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dhs[(4 * ty + i) * J + j0 + tx] += a[i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kM * J; idx += kThreads) {
    const int m = idx / J;
    if (n0 + m < L.N) {
      const float h = hs[m * padded(J) + idx - m * J];
      dpre_out[n0 * J + idx] = dhs[idx] * (1.f - h * h);
    }
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    joint_bwd_w_kernel(Lattice L, const T* __restrict__ e, const T* __restrict__ g,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       const int* __restrict__ labels, const float* __restrict__ lse,
                       const float* __restrict__ dblank, const float* __restrict__ dlabel,
                       float* __restrict__ dw, float* __restrict__ db) {
  extern __shared__ __align__(16) float smem[];
  const int J = L.J;
  const int Jp = padded(J);
  float* dws = smem;                        // J × kTVW
  float* hs = dws + J * kTVW;               // kM × Jp (16-byte aligned: kTVW = 32)
  float* ws = hs + kM * Jp;                 // kKC × (kTVW + 1)
  float* ds = ws + kKC * (kTVW + 1);        // kM × kTVW
  float* lse_s = ds + kM * kTVW;            // kM
  float* dbl_s = lse_s + kM;                // kM
  float* dlb_s = dbl_s + kM;                // kM
  int* lbl_s = reinterpret_cast<int*>(dlb_s + kM);  // kM
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int v0 = blockIdx.x * kTVW;
  const int v = v0 + tx;

  for (int idx = threadIdx.x; idx < J * kTVW; idx += kThreads) dws[idx] = 0.f;
  float db_acc = 0.f;  // column v, kept by warp 0
  float acc[4][1];
  for (long long n0 = 0; n0 < L.N; n0 += kM) {
    __syncthreads();  // the previous tile's readers are done with hs and ds
    load_tile(L, e, g, labels, lse, dblank, dlabel, n0, hs, lbl_s, lse_s, dbl_s, dlb_s);
    slab_logits<1>(L, hs, w, v0, ws, acc);  // starts with a barrier: hs is complete
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * ty + i;
      ds[m * kTVW + tx] =
          (n0 + m < L.N && v < L.V)
              ? dlogit(acc[i][0] + bias[v], lse_s[m], dbl_s[m], dlb_s[m], v, lbl_s[m])
              : 0.f;
    }
    __syncthreads();
    // dW[j][v] += Σ_m hs[m][j] · ds[m][v], for j = jt + 4·ty + i: one
    // 16-byte load of h per m
    for (int jt = 0; jt < Jp; jt += 32) {
      const int jb = jt + 4 * ty;
      if (jb >= Jp) break;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int m = 0; m < kM; ++m) {
        const float dv = ds[m * kTVW + tx];
        const float4 h4 = *reinterpret_cast<const float4*>(hs + m * Jp + jb);
        a[0] = fmaf(h4.x, dv, a[0]);
        a[1] = fmaf(h4.y, dv, a[1]);
        a[2] = fmaf(h4.z, dv, a[2]);
        a[3] = fmaf(h4.w, dv, a[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (jb + i < J) dws[(jb + i) * kTVW + tx] += a[i];
    }
    if (ty == 0) {
      float s = 0.f;
      for (int m = 0; m < kM; ++m) s += ds[m * kTVW + tx];
      db_acc += s;
    }
  }
  __syncthreads();
  if (v < L.V) {
    for (int j = ty; j < J; j += kThreads / 32)
      dw[static_cast<long long>(j) * L.V + v] = dws[j * kTVW + tx];
    if (ty == 0) db[v] = db_acc;
  }
}

size_t fwd_smem(int J) { return sizeof(float) * (kM * padded(J) + kKC * (kTV + 1) + 3 * kM); }
size_t eg_smem(int J) {
  return sizeof(float) * (kM * padded(J) + kM * J + kKC * (kTV + 1) + kM * kTV + 4 * kM);
}
size_t w_smem(int J) {
  return sizeof(float) *
         (J * kTVW + kM * padded(J) + kKC * (kTVW + 1) + kM * kTVW + 4 * kM);
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

template <typename T>
cudaError_t launch_fwd(const Lattice& L, const void* e, const void* g, const float* w,
                       const float* b, const int* labels, float* blank, float* label,
                       float* lse, cudaStream_t s) {
  const size_t smem = fwd_smem(L.J);
  cudaError_t err = allow_smem(joint_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned int blocks = static_cast<unsigned int>((L.N + kM - 1) / kM);
  joint_fwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      L, static_cast<const T*>(e), static_cast<const T*>(g), w, b, labels, blank, label, lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_eg(const Lattice& L, const void* e, const void* g, const float* w,
                          const float* b, const int* labels, const float* lse,
                          const float* dblank, const float* dlabel, float* dpre,
                          cudaStream_t s) {
  const size_t smem = eg_smem(L.J);
  cudaError_t err = allow_smem(joint_bwd_eg_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned int blocks = static_cast<unsigned int>((L.N + kM - 1) / kM);
  joint_bwd_eg_kernel<T><<<blocks, kThreads, smem, s>>>(
      L, static_cast<const T*>(e), static_cast<const T*>(g), w, b, labels, lse, dblank, dlabel,
      dpre);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_w(const Lattice& L, const void* e, const void* g, const float* w,
                         const float* b, const int* labels, const float* lse,
                         const float* dblank, const float* dlabel, float* dw, float* db,
                         cudaStream_t s) {
  const size_t smem = w_smem(L.J);
  cudaError_t err = allow_smem(joint_bwd_w_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned int blocks = static_cast<unsigned int>((L.V + kTVW - 1) / kTVW);
  joint_bwd_w_kernel<T><<<blocks, kThreads, smem, s>>>(
      L, static_cast<const T*>(e), static_cast<const T*>(g), w, b, labels, lse, dblank, dlabel,
      dw, db);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory per block, in bytes, of kernel 0 (forward),
// 1 (eg backward) or 2 (w backward) at joint width J; the wrapper
// refuses a J whose kernels would not fit the card.
extern "C" long long rnnt_joint_smem_bytes(int kernel, int J) {
  switch (kernel) {
    case 0: return static_cast<long long>(fwd_smem(J));
    case 1: return static_cast<long long>(eg_smem(J));
    case 2: return static_cast<long long>(w_smem(J));
    default: return -1;
  }
}

// dtype: 0 = float32 e and g, 1 = bfloat16. w, b, lse, the cotangents
// and every output are float32; labels int32 (B, U1). Tensors are
// contiguous: e (B, T, J), g (B, U1, J), w (J, V), b (V,), blank, label,
// lse, dblank, dlabel (B, T, U1). Returns a cudaError_t as int.
extern "C" int rnnt_joint_fwd(int dtype, const void* e, const void* g, const void* w,
                              const void* b, const void* labels, void* blank, void* label,
                              void* lse, int B, int T, int U1, int J, int V, void* stream) {
  if (bad_shape(B, T, U1, J, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const int* lp = static_cast<const int*>(labels);
  float* o0 = static_cast<float*>(blank);
  float* o1 = static_cast<float*>(label);
  float* o2 = static_cast<float*>(lse);
  if (dtype == 0) return static_cast<int>(launch_fwd<float>(L, e, g, wp, bp, lp, o0, o1, o2, s));
  if (dtype == 1)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(L, e, g, wp, bp, lp, o0, o1, o2, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dpre (B, T, U1, J) float32 through the eg kernel.
extern "C" int rnnt_joint_bwd_eg(int dtype, const void* e, const void* g, const void* w,
                                 const void* b, const void* labels, const void* lse,
                                 const void* dblank, const void* dlabel, void* dpre, int B,
                                 int T, int U1, int J, int V, void* stream) {
  if (bad_shape(B, T, U1, J, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const int* lp = static_cast<const int*>(labels);
  const float* sp = static_cast<const float*>(lse);
  const float* d0 = static_cast<const float*>(dblank);
  const float* d1 = static_cast<const float*>(dlabel);
  float* pp = static_cast<float*>(dpre);
  if (dtype == 0)
    return static_cast<int>(launch_bwd_eg<float>(L, e, g, wp, bp, lp, sp, d0, d1, pp, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_bwd_eg<__nv_bfloat16>(L, e, g, wp, bp, lp, sp, d0, d1, pp, s));
  return static_cast<int>(cudaErrorInvalidValue);
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

// dw (J, V) and db (V,) through the w kernel.
extern "C" int rnnt_joint_bwd_w(int dtype, const void* e, const void* g, const void* w,
                                const void* b, const void* labels, const void* lse,
                                const void* dblank, const void* dlabel, void* dw, void* db,
                                int B, int T, int U1, int J, int V, void* stream) {
  if (bad_shape(B, T, U1, J, V)) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const int* lp = static_cast<const int*>(labels);
  const float* sp = static_cast<const float*>(lse);
  const float* d0 = static_cast<const float*>(dblank);
  const float* d1 = static_cast<const float*>(dlabel);
  float* o0 = static_cast<float*>(dw);
  float* o1 = static_cast<float*>(db);
  if (dtype == 0)
    return static_cast<int>(launch_bwd_w<float>(L, e, g, wp, bp, lp, sp, d0, d1, o0, o1, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_bwd_w<__nv_bfloat16>(L, e, g, wp, bp, lp, sp, d0, d1, o0, o1, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
