// K10's backward for Hopper on the CUDA cores: dq, dk and dv of the
// forward's attention for fp32, and for bf16 at head widths that are not
// multiples of 16 (kernels/flash_attention.py:bwd_route; bf16 at widths of
// 16 n takes the tensor-core design, csrc/attention_bwd_wgmma.cu).
//
// Replaces no Pallas kernel: the JAX package differentiates the model's
// jnp attention (src/repro/models/attention.py:84 blockwise_attention)
// with jax.grad, and the Pallas K10 (src/repro/kernels/flash_attention.py
// :103) has no backward. This is its gradient for the forward's whole
// contract (csrc/attention.cu): causal or not, the query offset (query i
// sits at q_offset + i), the scale on q, a sliding window, the tanh logit
// softcap, GQA with H a multiple of Kv, Sq != Sk, ragged tiles, D and Dv
// up to 256, fp32 or bf16 in and out with fp32 sums.
//
// FlashAttention-2's equations, P recomputed from q, k and the forward's
// row log-sum-exp (lse (B, H, Sq) fp32; +inf for a row with no valid key):
//   s_raw = (scale q) . k,  t = tanh(s_raw / cap),  s = cap t (s = s_raw
//   without a softcap),  P = exp(s - lse) on valid keys (0 elsewhere),
//   di = rowsum(dO o),  dV = P^T dO,  dP = dO V^T,  dS = P (dP - di),
//   dS_raw = dS (1 - t^2) (the softcap's derivative from the recomputed
//   raw score),  dQ = scale dS_raw K,  dK = dS_raw^T (scale q).
// A row whose keys are all masked has P = 0, so it adds nothing anywhere.
//
// Three launches a call, on the caller's stream, no atomics, each sum in
// one fixed order (so a call's bits repeat):
//   fa_bwd_di_kernel: one warp a (b, i, h) row, di = sum of dO o (lanes
//     stride the width, then a xor tree);
//   fa_bwd_dkdv_kernel: grid (ceil(Sk / 64), B Kv), 256 threads a block
//     own 64 keys of one kv head and walk its G = H / Kv query heads in
//     order and each head's query tiles of 32 rows in order (only the
//     tiles the causal mask and the window leave), summing dK and dV in
//     registers (a thread: one key, every fourth column);
//   fa_bwd_dq_kernel: grid (ceil(Sq / 32), B H), 256 threads a block own
//     32 query rows of one head and walk the kv tiles of 64 keys in order
//     (those the forward would visit), summing dQ in registers (a thread:
//     one row, every eighth column).
// Tiles are staged in shared memory as fp32 with one float of padding a
// row, so a warp's 32 keys read 32 banks. A thread computes 8 scores and
// 8 dP of one key (s and dP share the key's k and v loads), then writes P
// and dS to shared memory for the products into dK, dV and dQ.
//
// What bounds it: at the whisper-base training shapes (bf16, D = 64) the
// backward's 2.5 forwards' worth of products (s twice, dP twice, dV, dK,
// dQ: 5 products of Sq Sk D against the forward's 2) would take a few
// microseconds on the tensor cores; this kernel runs them on the CUDA
// cores (67 TFLOP/s of fp32 fused multiply-adds at best), with two
// shared-memory loads per two fused multiply-adds in the dK/dV/dQ
// products, so it is bound by shared-memory bandwidth and the CUDA-core
// rate, not by the bytes it moves. The tensor-core design for bf16 is
// csrc/attention_bwd_wgmma.cu.
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes
// (kernels/flash_attention.py). The entry point allocates nothing: the
// wrapper passes di's scratch (B H Sq fp32). It returns the first
// cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;        // query rows a tile
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = kBQ / (kThreads / kBK);  // score rows a thread: 8

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, float v);
template <>
__device__ __forceinline__ void store_f<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store_f<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// DT: max(D, Dv) padded to 64, 128, 192 or 256. At 192 a block takes
// 165,120 B of shared memory, at 256 214,272 B: one block an SM.
template <int DT>
struct BwdSmem {
  static constexpr int ld = DT + 1;     // Qs, dOs, Ks, Vs rows
  static constexpr int p_ld = kBK + 1;  // Ps, dSs rows (one query row each)
  // Ks, Vs [kBK][ld]; Qs, dOs [kBQ][ld]; Ps, dSs [kBQ][p_ld]; lse, di [kBQ]
  static constexpr size_t floats = 2 * kBK * ld + 2 * kBQ * ld + 2 * kBQ * p_ld + 2 * kBQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Rows [q0, q0 + kBQ) of head h, batch b: Qs = scale q, dOs = dO, and the
// rows' lse and di (+inf and 0 past Sq, so those rows give P = 0).
template <typename T, int DT>
__device__ __forceinline__ void load_q_tile(float* Qs, float* dOs, float* lse_s, float* di_s,
                                            const T* q, const T* dout, const float* lse,
                                            const float* di, int b, int h, int q0, int Sq,
                                            int H, int D, int Dv, float scale) {
  constexpr int ld = BwdSmem<DT>::ld;
  for (int idx = threadIdx.x; idx < kBQ * DT; idx += kThreads) {
    const int r = idx / DT, d = idx % DT;
    const int i = q0 + r;
    const long long row = (static_cast<long long>(b) * Sq + i) * H + h;
    Qs[r * ld + d] = (i < Sq && d < D) ? load_f(q + row * D + d) * scale : 0.f;
    dOs[r * ld + d] = (i < Sq && d < Dv) ? load_f(dout + row * Dv + d) : 0.f;
  }
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int i = q0 + r;
    const long long at = (static_cast<long long>(b) * H + h) * Sq + i;
    lse_s[r] = i < Sq ? lse[at] : __int_as_float(0x7f800000);
    di_s[r] = i < Sq ? di[at] : 0.f;
  }
}

// Keys [t0, t0 + kBK) of kv head kvh, batch b (zeros past Sk and past the
// widths).
template <typename T, int DT>
__device__ __forceinline__ void load_kv_tile(float* Ks, float* Vs, const T* k, const T* v, int b,
                                             int kvh, int t0, int Sk, int Kv, int D, int Dv) {
  constexpr int ld = BwdSmem<DT>::ld;
  for (int idx = threadIdx.x; idx < kBK * DT; idx += kThreads) {
    const int j = idx / DT, d = idx % DT;
    const int key = t0 + j;
    const long long row = (static_cast<long long>(b) * Sk + key) * Kv + kvh;
    Ks[j * ld + d] = (key < Sk && d < D) ? load_f(k + row * D + d) : 0.f;
    Vs[j * ld + d] = (key < Sk && d < Dv) ? load_f(v + row * Dv + d) : 0.f;
  }
}

// This thread's P and dS of one query tile against one key tile: key j =
// tid % 64 of the tile, rows 8 (tid / 64) .. + 7; written to Ps and dSs
// ([row][key]).
template <int DT>
__device__ __forceinline__ void p_and_ds(float* Ps, float* dSs, const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs, const float* lse_s,
                                         const float* di_s, int q0, int t0, int Sq, int Sk,
                                         int causal, int window, float softcap, int q_offset) {
  constexpr int ld = BwdSmem<DT>::ld, p_ld = BwdSmem<DT>::p_ld;
  const int j = threadIdx.x % kBK;
  const int i0 = (threadIdx.x / kBK) * kRows;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DT; ++d) {
    const float kd = Ks[j * ld + d], vd = Vs[j * ld + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = fmaf(Qs[(i0 + r) * ld + d], kd, s[r]);
      dp[r] = fmaf(dOs[(i0 + r) * ld + d], vd, dp[r]);
    }
  }
  const int key = t0 + j;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    const int qpos = q_offset + q0 + i;
    const bool ok = q0 + i < Sq && key < Sk && (!causal || key <= qpos) &&
                    (window <= 0 || key > qpos - window);
    float t = 0.f, sc = s[r];
    if (softcap > 0.f) {
      t = tanhf(s[r] / softcap);
      sc = softcap * t;
    }
    const float p = ok ? expf(sc - lse_s[i]) : 0.f;
    float ds = p * (dp[r] - di_s[i]);
    if (softcap > 0.f) ds *= 1.f - t * t;
    Ps[i * p_ld + j] = p;
    dSs[i * p_ld + j] = ds;
  }
}

// di = rowsum(dO o) for every (b, i, h) row: one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_di_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ di,
                 long long rows, int Sq, int H, int Dv) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < Dv; d += 32)
    acc = fmaf(load_f(dout + row * Dv + d), load_f(o + row * Dv + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / (static_cast<long long>(Sq) * H);
    const int i = static_cast<int>((row / H) % Sq), h = static_cast<int>(row % H);
    di[(b * H + h) * Sq + i] = acc;
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                   int Sk, int H, int Kv, int D, int Dv, float scale, int causal, int window,
                   float softcap, int q_offset) {
  using L = BwdSmem<DT>;
  constexpr int NC = DT / 4;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * L::ld;
  float* Qs = Vs + kBK * L::ld;
  float* dOs = Qs + kBQ * L::ld;
  float* Ps = dOs + kBQ * L::ld;
  float* dSs = Ps + kBQ * L::p_ld;
  float* lse_s = dSs + kBQ * L::p_ld;
  float* di_s = lse_s + kBQ;

  const int kvh = blockIdx.y % Kv;
  const int b = blockIdx.y / Kv;
  const int G = H / Kv;
  const int k0 = blockIdx.x * kBK;
  const int jr = threadIdx.x / 4;  // this thread's key, and its columns sub + 4 c
  const int sub = threadIdx.x % 4;
  load_kv_tile<T, DT>(Ks, Vs, k, v, b, kvh, k0, Sk, Kv, D, Dv);

  // query rows [i_lo, i_hi) can see some key of this tile
  const int k_last = min(k0 + kBK, Sk) - 1;
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - q_offset);
  if (window > 0) i_hi = min(Sq, max(0, k_last + window - q_offset));

  float dK[NC], dV[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dK[c] = dV[c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = (i_lo / kBQ) * kBQ; q0 < i_hi; q0 += kBQ) {
      __syncthreads();  // the last tile's reads of Qs, dOs, Ps and dSs are done
      load_q_tile<T, DT>(Qs, dOs, lse_s, di_s, q, dout, lse, di, b, h, q0, Sq, H, D, Dv, scale);
      __syncthreads();
      p_and_ds<DT>(Ps, dSs, Qs, dOs, Ks, Vs, lse_s, di_s, q0, k0, Sq, Sk, causal, window,
                   softcap, q_offset);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        const float p = Ps[i * L::p_ld + jr], ds = dSs[i * L::p_ld + jr];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dV[c] = fmaf(p, dOs[i * L::ld + 4 * c + sub], dV[c]);
          dK[c] = fmaf(ds, Qs[i * L::ld + 4 * c + sub], dK[c]);
        }
      }
    }
  }
  const int key = k0 + jr;
  if (key >= Sk) return;
  const long long row = (static_cast<long long>(b) * Sk + key) * Kv + kvh;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = 4 * c + sub;
    if (d < D) store_f(dk + row * D + d, dK[c]);
    if (d < Dv) store_f(dv + row * Dv + d, dV[c]);
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, T* __restrict__ dq, int Sq, int Sk, int H, int Kv,
                 int D, int Dv, float scale, int causal, int window, float softcap,
                 int q_offset) {
  using L = BwdSmem<DT>;
  constexpr int NC = DT / 8;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * L::ld;
  float* Qs = Vs + kBK * L::ld;
  float* dOs = Qs + kBQ * L::ld;
  float* Ps = dOs + kBQ * L::ld;
  float* dSs = Ps + kBQ * L::p_ld;
  float* lse_s = dSs + kBQ * L::p_ld;
  float* di_s = lse_s + kBQ;

  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int kvh = h / (H / Kv);
  const int q0 = blockIdx.x * kBQ;
  const int ir = threadIdx.x / 8;  // this thread's row, and its columns sub + 8 c
  const int sub = threadIdx.x % 8;
  load_q_tile<T, DT>(Qs, dOs, lse_s, di_s, q, dout, lse, di, b, h, q0, Sq, H, D, Dv, scale);

  // keys [k_begin, k_end) can be valid for some row of this tile
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);

  float dQ[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dQ[c] = 0.f;
  for (int t0 = (k_begin / kBK) * kBK; t0 < k_end; t0 += kBK) {
    __syncthreads();  // the last tile's reads of Ks, Vs and dSs are done
    load_kv_tile<T, DT>(Ks, Vs, k, v, b, kvh, t0, Sk, Kv, D, Dv);
    __syncthreads();
    p_and_ds<DT>(Ps, dSs, Qs, dOs, Ks, Vs, lse_s, di_s, q0, t0, Sq, Sk, causal, window, softcap,
                 q_offset);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float ds = dSs[ir * L::p_ld + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) dQ[c] = fmaf(ds, Ks[j * L::ld + 8 * c + sub], dQ[c]);
    }
  }
  const int i = q0 + ir;
  if (i >= Sq) return;
  const long long row = (static_cast<long long>(b) * Sq + i) * H + h;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = 8 * c + sub;
    if (d < D) store_f(dq + row * D + d, dQ[c] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int DT>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
               const void* dout, void* dq, void* dk, void* dv, void* di, int B, int Sq, int Sk,
               int H, int Kv, int D, int Dv, float scale, int causal, int window, float softcap,
               int q_offset, cudaStream_t s) {
  static bool ready_kv = false, ready_q = false;
  constexpr size_t smem = BwdSmem<DT>::bytes;
  auto kdkdv = fa_bwd_dkdv_kernel<T, DT>;
  auto kdq = fa_bwd_dq_kernel<T, DT>;
  cudaError_t err = allow_smem(kdkdv, smem, &ready_kv);
  if (err == cudaSuccess) err = allow_smem(kdq, smem, &ready_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdi = static_cast<float*>(di);
  const long long rows = static_cast<long long>(B) * Sq * H;
  fa_bwd_di_kernel<T><<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
                        kThreads, 0, s>>>(static_cast<const T*>(o), tdo, fdi, rows, Sq, H, Dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkdv<<<dim3((Sk + kBK - 1) / kBK, B * Kv), kThreads, smem, s>>>(
      tq, tk, tv, tdo, flse, fdi, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, Kv, D, Dv,
      scale, causal, window, softcap, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdq<<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, smem, s>>>(
      tq, tk, tv, tdo, flse, fdi, static_cast<T*>(dq), Sq, Sk, H, Kv, D, Dv, scale, causal,
      window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Whether a launch at widths D, Dv takes the tiles of 256 (past 192), the
// test the dispatch below branches on: the wrapper counts those launches
// apart.
extern "C" int flash_attention_bwd_simt_wide(int D, int Dv) { return (D > Dv ? D : Dv) > 192; }

// K10's backward. dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq,
// dk and dv alike); lse (B, H, Sq) fp32 from the forward; di: B * H * Sq
// fp32 of scratch. D and Dv at most 256; H a multiple of Kv;
// B * H at most 65,535; Sq rows of 32 and Sk keys of 64 at most 2**31 blocks. Returns a
// cudaError_t as int (0 = success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* lse, const void* dout, void* dq,
                                   void* dk, void* dv, void* di, int B, int Sq, int Sk, int H,
                                   int Kv, int D, int Dv, float scale, int causal, int window,
                                   float softcap, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Kv <= 0 || H % Kv || D <= 0 || Dv <= 0 || D > 256 ||
      Dv > 256 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = D > Dv ? D : Dv;  // the tiles' width: 64, 128, 192 or 256
  const auto args = [&](auto launch) {
    return launch(q, k, v, o, lse, dout, dq, dk, dv, di, B, Sq, Sk, H, Kv, D, Dv, scale, causal,
                  window, softcap, q_offset, s);
  };
  const bool wide = flash_attention_bwd_simt_wide(D, Dv);
  if (dtype == 0)
    return wide           ? args(launch_bwd<float, 256>)
           : width <= 64  ? args(launch_bwd<float, 64>)
           : width <= 128 ? args(launch_bwd<float, 128>)
                          : args(launch_bwd<float, 192>);
  if (dtype == 1)
    return wide           ? args(launch_bwd<__nv_bfloat16, 256>)
           : width <= 64  ? args(launch_bwd<__nv_bfloat16, 64>)
           : width <= 128 ? args(launch_bwd<__nv_bfloat16, 128>)
                          : args(launch_bwd<__nv_bfloat16, 192>);
  return static_cast<int>(cudaErrorInvalidValue);
}
