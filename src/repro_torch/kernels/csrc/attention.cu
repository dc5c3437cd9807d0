// Attention kernels (K10 and K11) for Hopper, forward only.
//
// Replaces the Pallas TPU kernels
//   K10 src/repro/kernels/flash_attention.py:70 flash_attention
//       (_kernel :25, pallas_call :103): online-softmax attention with
//       causal and sliding-window masks, GQA and a tanh logit softcap;
//   K11 src/repro/kernels/decode_attention.py:62 flash_decode
//       (_kernel :25, pallas_call :86): one query token against a cache
//       up to a position read on the device.
// Both also take what the model's jnp functions have and the Pallas
// kernels lack (src/repro/models/attention.py:84 blockwise_attention,
// :158 decode_attention): the query scale, K10's query offset, K11's
// softcap and ring buffer, so every call of those functions on the card
// runs a kernel.
//
// flash_attention (K10). q (B, Sq, H, D), k (B, Sk, Kv, D), v (B, Sk, Kv,
// Dv), contiguous, bf16 or fp32; o (B, Sq, H, Dv) in q's dtype. Grid
// (ceil(Sq / 32), B * H): one block of 128 threads per 32 query rows of
// one head, which reads kv head h / (H / Kv) (GQA without copies). The
// block walks the kv axis in tiles of 64 keys staged in shared memory as
// fp32; a thread owns a 4 x 4 tile of the (32, 64) scores (its rows
// 4*ty..4*ty+3, its keys tx + 16*c) and a 4 x (Dv / 16) tile of the
// accumulator. Per tile, as blockwise_attention does per block: scores in
// fp32 from the scaled query, softcap, mask to -1e30, the row max over
// the 16 threads of a row (warp shuffles), m_safe = 0 for a row whose
// keys so far are all masked, p = exp(s - m_safe) masked to 0, corr =
// exp(m - m_safe) (0 while m is -1e30), l = l * corr + sum p, acc = acc *
// corr + p @ v. The output is acc / max(l, 1e-30), so a row with no valid
// key gives 0, as in the reference. Ragged Sq and Sk are masked (the
// Pallas kernel asserts Sq % tq == 0 and Sk % tk == 0, which Whisper's
// 1,500 source frames fail). A tile whose every score is masked (above
// the causal diagonal of the block's last row, or below the window of
// its first row) is skipped: its p are 0 and its corr exactly 1 (or acc
// and l are still 0), so skipping it changes no bit.
//
// flash_decode (K11). q (B, H, D), caches (B, S, Kv, D / Dv), pos one
// int32 on the device (so a decode step can be captured in a CUDA graph);
// o (B, H, Dv) in q's dtype. One block of 128 threads per (b, kv head)
// carries the G = H / Kv grouped query rows over the cache in tiles of
// 128 slots staged in shared memory as fp32, thread j scoring slot j of
// the tile for all G rows; the same online softmax as K10, with block
// reductions. Slot j is valid when its absolute position a (j, or pos -
// ((pos - j) mod S) for a ring buffer) has 0 <= a <= pos and a > pos -
// window (window 0: none), as in attention.py:190-197. Without a ring,
// only the tiles that hold valid slots are read.
//
// Bound on an H100 SXM. K10 at Whisper's encoder (B=4, H=8, Sq=Sk=1500,
// D=64, bf16): 4 B H Sq Sk D = 18.4 GFLOP, half of it Q.K^T, whose bf16
// products are exact in a bf16 MMA with fp32 accumulation (9.3 us at 989
// TFLOP/s), half P.V with fp32 p (137.6 us at the fp32 rate of 67
// TFLOP/s): 0.147 ms; 24.6 MB of bf16 in and out take 7.3 us, so the
// operations bound it. This kernel does both products in fp32, without
// tensor cores; its register tiles give 16 fused multiply-adds per two
// shared loads in both products. K11 moves the valid part of the cache once (at
// the cross cache, B=4, S=1500, Kv=8, D=64, bf16: 12.3 MB, 3.7 us at
// 3.35 TB/s) and does 4 flops a cached element: bytes bound it, and at
// B * Kv = 32 blocks on 132 SMs one SM's load rate and the launch
// dominate. Tensor cores (bf16 MMA), TMA and splitting S across blocks
// are later work.
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e30f;

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

__device__ __forceinline__ float softcap_f(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// ------------------------------------------------------------------ K10

constexpr int kTQ = 32;                        // query rows a block
constexpr int kTK = 64;                        // keys a tile
constexpr int kFaThreads = (kTQ / 4) * 16;     // 8 row groups x 16 key lanes

template <int DT>  // DT: the head width padded to 64 or 128
struct FaSmem {
  static constexpr int q_ld = kTQ + 4;   // Qs[DT][q_ld], transposed, rows 16-byte aligned
  static constexpr int k_ld = DT + 1;    // Ks[kTK][k_ld], padded: lanes read distinct banks
  static constexpr int v_ld = DT;        // Vs[kTK][v_ld]
  static constexpr int p_ld = kTQ + 4;   // Ps[kTK][p_ld], transposed
  static constexpr int floats = DT * q_ld + kTK * k_ld + kTK * v_ld + kTK * p_ld;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int DT>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
                       int Kv, int D, int Dv, float scale, int causal, int window,
                       float softcap, int q_offset) {
  using L = FaSmem<DT>;
  constexpr int DG = DT / 64;  // float4 groups of the accumulator a thread owns per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + DT * L::q_ld;
  float* Vs = Ks + kTK * L::k_ld;
  float* Ps = Vs + kTK * L::v_ld;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key lane; the 16 lanes of a row share a half warp
  const int ty = tid >> 4;  // row group: rows 4*ty .. 4*ty+3
  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int kvh = h / (H / Kv);
  const int q0 = blockIdx.x * kTQ;

  for (int idx = tid; idx < kTQ * DT; idx += kFaThreads) {
    const int r = idx / DT, d = idx % DT;
    const int i = q0 + r;
    float val = 0.f;
    if (i < Sq && d < D)
      val = load_f(q + ((static_cast<long long>(b) * Sq + i) * H + h) * D + d) * scale;
    Qs[d * L::q_ld + r] = val;
  }

  // keys [k_begin, k_end) can be valid for some row of this block
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kTQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);

  float m[4], l[4], acc[4][4 * DG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * DG; ++e) acc[i][e] = 0.f;
  }

  const T* kb = k + (static_cast<long long>(b) * Sk * Kv + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * Sk * Kv + kvh) * Dv;
  for (int t0 = (k_begin / kTK) * kTK; t0 < k_end; t0 += kTK) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int idx = tid; idx < kTK * DT; idx += kFaThreads) {
      const int j = idx / DT, d = idx % DT;
      const int key = t0 + j;
      const long long row = static_cast<long long>(key) * Kv;
      Ks[j * L::k_ld + d] = (key < Sk && d < D) ? load_f(kb + row * D + d) : 0.f;
      Vs[j * L::v_ld + d] = (key < Sk && d < Dv) ? load_f(vb + row * Dv + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * L::q_ld + ty * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kv = Ks[(tx + 16 * c) * L::k_ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][c] = fmaf(qv[i], kv, s[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = t0 + tx + 16 * c;
        ok[c] = key < Sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
        s[i][c] = ok[c] ? softcap_f(s[i][c], softcap) : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = ok[c] ? expf(s[i][c] - m_safe) : 0.f;
        rs += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int e = 0; e < 4 * DG; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * c) * L::p_ld + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[j * L::p_ld + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 va = *reinterpret_cast<const float4*>(&Vs[j * L::v_ld + g * 64 + tx * 4]);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g * 4 + e] = fmaf(pv[i], vv[e], acc[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Sq + row) * H + h) * Dv;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dv = g * 64 + tx * 4 + e;
        if (dv < Dv) store_f(orow + dv, acc[i][g * 4 + e] / denom);
      }
  }
}

// ------------------------------------------------------------------ K11

constexpr int kTS = 128;          // cache slots a tile; thread j scores slot j
constexpr int kDecThreads = kTS;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxG = 16;         // query heads a kv head

template <int DT>
struct DecSmem {
  static constexpr int k_ld = DT + 1;  // Ks[kTS][k_ld], padded: lanes read distinct banks
  static constexpr int v_ld = DT;      // Vs[kTS][v_ld]
  static constexpr int floats =
      kTS * k_ld + kTS * v_ld + kMaxG * DT + kMaxG * kTS + 2 * kDecWarps * kMaxG;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int DT>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ o, const int* __restrict__ pos_ptr,
                    int S, int Kv, int G, int D, int Dv, float scale, int window, int ring,
                    float softcap) {
  using L = DecSmem<DT>;
  constexpr int kOut = kMaxG * DT / kDecThreads;  // accumulator entries a thread may own
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTS * L::k_ld;
  float* Qs = Vs + kTS * L::v_ld;      // [kMaxG][DT], scaled
  float* Ps = Qs + kMaxG * DT;         // [kMaxG][kTS]
  float* red_max = Ps + kMaxG * kTS;   // [kDecWarps][kMaxG]
  float* red_sum = red_max + kDecWarps * kMaxG;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Kv, kvh = blockIdx.x % Kv;
  const int H = Kv * G;
  const int pos = *pos_ptr;

  for (int idx = tid; idx < kMaxG * DT; idx += kDecThreads) {
    const int g = idx / DT, d = idx % DT;
    float val = 0.f;
    if (g < G && d < D)
      val = load_f(q + (static_cast<long long>(b) * H + kvh * G + g) * D + d) * scale;
    Qs[idx] = val;
  }

  // the slots that can be valid: all of a ring; else (pos - window, pos]
  int lo = 0, hi = S - 1;
  if (!ring) {
    hi = min(S - 1, pos);
    if (window > 0) lo = max(0, pos - window + 1);
  }

  float m[kMaxG], l[kMaxG], acc[kOut];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kOut; ++r) acc[r] = 0.f;

  const T* kb = kc + (static_cast<long long>(b) * S * Kv + kvh) * D;
  const T* vb = vc + (static_cast<long long>(b) * S * Kv + kvh) * Dv;
  for (int t0 = (lo / kTS) * kTS; t0 <= hi; t0 += kTS) {
    __syncthreads();  // the previous tile's reads are done
    for (int idx = tid; idx < kTS * DT; idx += kDecThreads) {
      const int j = idx / DT, d = idx % DT;
      const int slot = t0 + j;
      const long long row = static_cast<long long>(slot) * Kv;
      Ks[j * L::k_ld + d] = (slot < S && d < D) ? load_f(kb + row * D + d) : 0.f;
      Vs[j * L::v_ld + d] = (slot < S && d < Dv) ? load_f(vb + row * Dv + d) : 0.f;
    }
    __syncthreads();

    const int slot = t0 + tid;
    bool valid = slot < S;
    if (valid) {
      int a = slot;
      if (ring) {
        int back = (pos - slot) % S;
        if (back < 0) back += S;
        a = pos - back;
      }
      valid = a >= 0 && a <= pos && (window <= 0 || a > pos - window);
    }
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      const float kv = Ks[tid * L::k_ld + d];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) s[g] = fmaf(Qs[g * DT + d], kv, s[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      s[g] = valid ? softcap_f(s[g], softcap) : kNegInf;
      float mx = s[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red_max[warp * kMaxG + g] = mx;
    }
    __syncthreads();

    float corr[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float mx = red_max[g];
#pragma unroll
      for (int w = 1; w < kDecWarps; ++w) mx = fmaxf(mx, red_max[w * kMaxG + g]);
      const float m_new = fmaxf(m[g], mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p = valid ? expf(s[g] - m_safe) : 0.f;
      Ps[g * kTS + tid] = p;
      float rs = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) red_sum[warp * kMaxG + g] = rs;
      corr[g] = m[g] <= kNegInf / 2 ? 0.f : expf(m[g] - m_safe);
      m[g] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float rs = red_sum[g];
#pragma unroll
      for (int w = 1; w < kDecWarps; ++w) rs += red_sum[w * kMaxG + g];
      l[g] = l[g] * corr[g] + rs;
    }
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int out = tid + r * kDecThreads;
      const int g = out / DT, dv = out % DT;
      if (g >= G) break;
      float cg = 0.f;
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg)
        if (gg == g) cg = corr[gg];
      float a = acc[r] * cg;
      const float* pg = Ps + g * kTS;
#pragma unroll 8
      for (int j = 0; j < kTS; ++j) a = fmaf(pg[j], Vs[j * L::v_ld + dv], a);
      acc[r] = a;
    }
  }

#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int out = tid + r * kDecThreads;
    const int g = out / DT, dv = out % DT;
    if (g >= G) break;
    if (dv >= Dv) continue;
    float lg = 0.f;
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg)
      if (gg == g) lg = l[gg];
    store_f(o + (static_cast<long long>(b) * H + kvh * G + g) * Dv + dv,
            acc[r] / fmaxf(lg, 1e-30f));
  }
}

// Opt in to the dynamic shared memory a kernel needs above 48 KB, once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int DT>
int launch_fa(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
              int Kv, int D, int Dv, float scale, int causal, int window, float softcap,
              int q_offset, cudaStream_t s) {
  static bool ready = false;
  auto kernel = flash_attention_kernel<T, DT>;
  cudaError_t err = allow_smem(kernel, FaSmem<DT>::bytes, &ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kTQ - 1) / kTQ, B * H);
  kernel<<<grid, kFaThreads, FaSmem<DT>::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, Kv, D, Dv, scale, causal, window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DT>
int launch_decode(const void* q, const void* kc, const void* vc, void* o, const void* pos, int B,
                  int S, int Kv, int G, int D, int Dv, float scale, int window, int ring,
                  float softcap, cudaStream_t s) {
  static bool ready = false;
  auto kernel = flash_decode_kernel<T, DT>;
  cudaError_t err = allow_smem(kernel, DecSmem<DT>::bytes, &ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * Kv, kDecThreads, DecSmem<DT>::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(o), static_cast<const int*>(pos), S, Kv, G, D, Dv, scale, window, ring,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). D and Dv at most
// 128; H a multiple of Kv; B * H at most 65,535. window 0 = none; softcap
// 0 = none. Returns a cudaError_t as int (0 = success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H, int Kv, int D, int Dv,
                                   float scale, int causal, int window, float softcap,
                                   int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Kv <= 0 || H % Kv || D <= 0 || Dv <= 0 || D > 128 ||
      Dv > 128 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = D <= 64 && Dv <= 64;
  if (dtype == 0)
    return narrow ? launch_fa<float, 64>(q, k, v, o, B, Sq, Sk, H, Kv, D, Dv, scale, causal,
                                         window, softcap, q_offset, s)
                  : launch_fa<float, 128>(q, k, v, o, B, Sq, Sk, H, Kv, D, Dv, scale, causal,
                                          window, softcap, q_offset, s);
  if (dtype == 1)
    return narrow ? launch_fa<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, Kv, D, Dv, scale,
                                                 causal, window, softcap, q_offset, s)
                  : launch_fa<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, Kv, D, Dv, scale,
                                                  causal, window, softcap, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// pos: one int32 on the device. G = H / Kv at most 16.
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, void* o, const void* pos, int B, int S,
                                int Kv, int G, int D, int Dv, float scale, int window, int ring,
                                float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || G <= 0 || G > kMaxG || D <= 0 || Dv <= 0 || D > 128 ||
      Dv > 128 || static_cast<long long>(B) * Kv > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = D <= 64 && Dv <= 64;
  if (dtype == 0)
    return narrow ? launch_decode<float, 64>(q, k_cache, v_cache, o, pos, B, S, Kv, G, D, Dv,
                                             scale, window, ring, softcap, s)
                  : launch_decode<float, 128>(q, k_cache, v_cache, o, pos, B, S, Kv, G, D, Dv,
                                              scale, window, ring, softcap, s);
  if (dtype == 1)
    return narrow ? launch_decode<__nv_bfloat16, 64>(q, k_cache, v_cache, o, pos, B, S, Kv, G,
                                                     D, Dv, scale, window, ring, softcap, s)
                  : launch_decode<__nv_bfloat16, 128>(q, k_cache, v_cache, o, pos, B, S, Kv, G,
                                                      D, Dv, scale, window, ring, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
