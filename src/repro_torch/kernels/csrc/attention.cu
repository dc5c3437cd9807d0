// Attention kernels (K10 and K11) for Hopper, forward (K10's backward is
// csrc/attention_bwd.cu).
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
// runs a kernel. Both keep blockwise_attention's guards: masked scores are
// -1e30, m_safe = 0 for a row whose keys so far are all masked, p = exp(s
// - m_safe) masked to 0, corr = exp(m - m_safe) (0 while m is -1e30), and
// the output is acc / max(l, 1e-30), so a row with no valid key gives 0.
// Both K10 routes also write the rows' log-sum-exp when given an lse
// buffer (the backward recomputes P from it); the write is after the last
// tile and touches none of o's arithmetic, so o keeps its bits.
// Ragged Sq, Sk and S are masked (the Pallas kernels assert divisible
// tiles, which Whisper's 1,500 source frames fail). A tile or a split
// whose every score is masked is skipped: its p are 0 and its corr exactly
// 1 (or acc and l are still 0), so skipping it changes no bit.
//
// K10 has two routes; the wrapper (kernels/flash_attention.py) picks one
// by a fixed rule: bf16 with D and Dv multiples of 16 (and 16-byte aligned
// tensors) takes the tensor cores, everything else the CUDA cores. Both take
// a q.k width D and a v width Dv up to 256 (gemma3's heads of 256; multi-
// head latent attention's 128 + 64 against 128, src/repro/models/mla.py:73).
//
// flash_attention_wgmma (K10 on tensor cores). q (B, Sq, H, D), k (B, Sk,
// Kv, D), v (B, Sk, Kv, Dv), bf16; o (B, Sq, H, Dv) bf16. Grid (ceil(Sq /
// 64), B * H): one warpgroup per 64 query rows of one head (two past Dv =
// 128, each accumulating half of o's columns), reading kv head h / (H /
// Kv). Q's tile is loaded once; K/V tiles of 64 keys stream
// through a ring of 2 stages by TMA (4-d tensor maps over the (B, S,
// heads, D) layouts, so nothing is transposed in HBM; zero fill past every
// edge), completing on mbarriers, so the next tile's copy overlaps this
// tile's work. S = Q.K^T by wgmma m64n64k16 from shared memory (bf16
// products, fp32 sums); the scale applies to the fp32 scores, not to bf16
// q. The online softmax runs in registers, a row's max and sum over the 4
// threads that share it, exp as ex2 on the special-function unit with
// log2(e) folded in; softcap and masks branch once a tile. P.V keeps fp32
// p, as the TPU kernel does: p = p_hi + p_lo, both bf16, and two
// register-A wgmma products against V in shared memory (MN-major, the
// transpose bit) accumulate in fp32. One bf16 term (bf16(p), as
// FlashAttention and SDPA do) would change 42 % of the bf16-rounded
// outputs at 1,500 keys, the two terms 0.25 % (tests/test_torch_
// attention.py). Bound at Whisper's encoder (B=4, H=8, Sq=Sk=1500, D=64):
// Q.K^T's 9.2 GFLOP and P.V's two bf16 products, 18.4 GFLOP, at 989
// TFLOP/s take 27.9 us; the 72 M exponentials about 18.5 us on the
// special-function units; 24.6 MB of bf16 in and out 7.3 us. The tensor
// work bounds it. What the design leaves: a tile's products and softmax
// run one after the other within the block (4 blocks of 110 registers an
// SM overlap each other's; a second score buffer to overlap them within
// the block cost registers and ran slower), and P.V runs twice the
// products of a one-term kernel.
//
// flash_attention (K10 on CUDA cores: fp32, or bf16 at other widths).
// Grid (ceil(Sq / 32), B * H): one block of 128 threads per 32 query rows
// of one head. The block walks the kv axis in tiles of 64 keys staged in
// shared memory as fp32; a thread owns a 4 x 4 tile of the (32, 64) scores
// (its rows 4*ty..4*ty+3, its keys tx + 16*c) and a 4 x (Dv / 16) tile of
// the accumulator. DT, the width its tiles hold, is 64, 128, 192 or 256
// (max(D, Dv) padded; at 256 a block takes 177,408 B, one an SM). Per
// tile, as blockwise_attention does per block: scores
// in fp32 from the scaled query, softcap, masks, the row max over the 16
// threads of a row (warp shuffles), the online softmax above. Bound at the
// encoder in fp32: 18.4 GFLOP at 67 TFLOP/s, 0.275 ms; its register tiles
// give 16 fused multiply-adds per two shared loads in both products.
//
// flash_decode (K11). q (B, H, D), caches (B, S, Kv, D / Dv), pos one
// int32 on the device (so a decode step can be captured in a CUDA graph);
// o (B, H, Dv) in q's dtype. Split over S: grid (B * Kv, ceil(S /
// split)), split a constant of the wrapper, so the grid depends on S only,
// never on pos. Slot j is valid when its absolute position a (j, or pos -
// ((pos - j) mod S) for a ring buffer) has 0 <= a <= pos and a > pos -
// window (window 0: none), as in attention.py:190-197; only valid slots
// are read. Each block runs the online softmax over its split for the G =
// H / Kv grouped rows, reading each k and v row once with 16-byte loads
// (a 64-wide bf16 row is 8 lanes) and scoring all G rows from it by
// shuffles within the lane group, and writes its partial (m, l, acc); the
// last block of a (b, kv head), found by an int32 ticket, merges the
// partials in split order: o = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s
// - M) l_s, 1e-30), M guarded as m_safe. One launch; deterministic. Bound
// at the cross cache (B=4, S=1500, Kv=8, D=64, bf16): the valid cache,
// 12.3 MB, at 3.35 TB/s, 3.7 us; 4 flops a cached element. At 768 blocks
// (64 slots a split) every SM has work; the merge is a second, short
// dependent pass in the last block.
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "wgmma_tma.cuh"  // TMA, mbarriers, wgmma descriptors and products, tensor maps

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

// The row's log-sum-exp for the backward (lse (B, H, Sq) fp32): m_safe +
// log(l) of the final running max and sum, so exp(s - lse) is the row's
// softmax; +inf for a row with no valid key (l = 0), whose p are then 0.
__device__ __forceinline__ void store_lse(float* lse, int b, int h, int H, int Sq, int row,
                                          float m, float l) {
  const float m_safe = m <= kNegInf / 2 ? 0.f : m;
  lse[(static_cast<long long>(b) * H + h) * Sq + row] =
      l > 0.f ? m_safe + logf(l) : __int_as_float(0x7f800000);
}

// ------------------------------------------------------------------ K10, CUDA cores

constexpr int kTQ = 32;                        // query rows a block
constexpr int kTK = 64;                        // keys a tile
constexpr int kFaThreads = (kTQ / 4) * 16;     // 8 row groups x 16 key lanes

template <int DT>  // DT: the head width padded to 64, 128, 192 or 256
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
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Sk, int H, int Kv, int D, int Dv, float scale, int causal,
                       int window, float softcap, int q_offset) {
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
    if (lse != nullptr && tx == 0) store_lse(lse, b, h, H, Sq, row, m[i], l[i]);
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

// ------------------------------------------------------------------ K10, tensor cores

constexpr int kWgRows = 64;         // query rows a block: the m64 of one warpgroup
constexpr int kWgKeys = 64;         // keys a tile: Q.K^T's n64, four k16 steps of P.V
constexpr int kWgThreads = 128;     // one warpgroup
constexpr int kWgStages = 2;        // K/V tiles in flight
static_assert(kWgRows == kTmaRows && kWgKeys == kTmaRows, "a tile is one tensor-map box");

// One stage: the K tile (nd regions) and the V tile (nv regions) of keys
// [t0, t0 + 64) of kv head kvh, batch b, completing on `bar`.
__device__ __forceinline__ void load_kv(uint8_t* dst, uint64_t* bar, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int nd, int nv, int kvh, int t0,
                                        int b) {
  mbar_expect_tx(bar, (nd + nv) * kAtom);
  for (int r = 0; r < nd; ++r) tma_load_4d(dst + r * kAtom, tm_k, 64 * r, kvh, t0, b, bar);
  for (int c = 0; c < nv; ++c) tma_load_4d(dst + (nd + c) * kAtom, tm_v, 64 * c, kvh, t0, b, bar);
}

constexpr size_t wg_smem_bytes(int nd, int dv) {
  return 1024 + static_cast<size_t>(kAtom) * (nd + kWgStages * (nd + (dv + 63) / 64)) +
         8 * (kWgStages + 1);
}

// The body of both tensor-core forwards (K10, bf16, D a multiple of 16 up
// to 256; ND = ceil(D / 64), 1 to 4). Grid (ceil(Sq / 64), B * H). DV1 = 0:
// flash_attention_wgmma_kernel<ND, DV>, one warpgroup a block accumulating
// all DV = Dv columns (up to 128). DV1 > 0: flash_attention_wgmma_wide_kernel
// <ND, DV1> at Dv > 128, two warpgroups a block on the same 64 query rows,
// warpgroup 0 accumulating columns [0, 128) (DV = 128), warpgroup 1
// columns [128, 128 + DV1) (DV1, 64 or 128, covers Dv - 128; columns past
// Dv are TMA's zeros and are not stored). Both run Q.K^T on the shared Q
// and K tiles with the same products in the same order, so their scores,
// row maxima and sums are the same bits, and each keeps ND <= 3's 64
// accumulator floats a thread; Q, K and V are loaded once a block.
// Shared memory, each region 1,024-byte aligned as the 128-byte swizzle
// needs: Q (ND regions of 64 rows x 64 columns), then kWgStages stages of
// K (ND regions) and V (ceil((DV + DV1) / 64) regions), then the stages'
// mbarriers and Q's. Thread 0 issues every TMA load; TMA zero-fills rows
// past Sq and Sk and columns past D and Dv, so a ragged tile adds 0 to both
// products and Q.K^T can run all 4 ND k16 steps (a compile-time count: with
// a run-time one, ptxas serialises the products). At ND = 3 (D = 192) and
// DV = 128 a block takes wg_smem_bytes(3, 128) = 107,544 B, two blocks an
// SM; at ND = 4 and Dv = 256 wg_smem_bytes(4, 256) = 164,888 B, one block
// an SM. Registers are ND = 2's: Q and K stay in shared memory.
template <int ND, int DV, int DV1>
__device__ __forceinline__ void fa_wgmma_body(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v,
                                              __nv_bfloat16* __restrict__ o,
                                              float* __restrict__ lse, int Sq, int Sk, int H,
                                              int Kv, int Dv, float scale, int causal, int window,
                                              float softcap, int q_offset) {
  constexpr int NWG = DV1 > 0 ? 2 : 1;
  constexpr int NV = (DV + DV1 + 63) / 64;
  constexpr int NO = DV / 2;  // accumulator floats a thread
  static_assert(NWG == 1 || DV == 128, "two warpgroups split Dv at column 128");
  extern __shared__ uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* KV0 = base + ND * kAtom;
  const int stage_bytes = (ND + NV) * kAtom;
  uint64_t* bars = reinterpret_cast<uint64_t*>(KV0 + kWgStages * stage_bytes);
  uint64_t* qbar = bars + kWgStages;

  const int tid = threadIdx.x;
  const int wg = NWG > 1 ? tid / kWgThreads : 0;   // this thread's warpgroup
  const int t = NWG > 1 ? tid % kWgThreads : tid;  // and its thread in it
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int cq = lane & 3;                 // and its column pair in each 8 columns
  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int kvh = h / (H / Kv);
  const int q0 = blockIdx.x * kWgRows;

  // keys [k_begin, k_end) can be valid for some row of this block
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kWgRows, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int t_first = (k_begin / kWgKeys) * kWgKeys;
  const int n_tiles = k_end > t_first ? (k_end - t_first + kWgKeys - 1) / kWgKeys : 0;

  float O[NO], S[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) O[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int s = 0; s <= kWgStages; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(qbar, ND * kAtom);
      for (int r = 0; r < ND; ++r) tma_load_4d(Qs + r * kAtom, tm_q, 64 * r, h, q0, b, qbar);
      for (int s = 0; s < min(n_tiles, kWgStages); ++s)
        load_kv(KV0 + s * stage_bytes, &bars[s], tm_k, tm_v, ND, NV, kvh, t_first + s * kWgKeys,
                b);
    }
    __syncthreads();  // the barriers are initialised before anyone waits on them
    mbar_wait(qbar, 0);
    __syncwarp();

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kWgStages;
      const uint8_t* Ks = KV0 + st * stage_bytes;
      const uint8_t* Vs = Ks + ND * kAtom;
      const int t0 = t_first + it * kWgKeys;
      mbar_wait(&bars[st], (it / kWgStages) & 1);
      __syncwarp();

      // S = Q . K^T: 4 ND steps of k16, each 32 bytes further into a
      // region's swizzled 128-byte rows (columns past D are zeros in both)
      pin<32>(S);  // the last tile's writes of S land before the fence
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * ND; ++kk) {
        const int off = (kk >> 2) * kAtom + (kk & 3) * 32;
        wgmma_ss_n64(S, desc_kmajor(Qs + off), desc_kmajor(Ks + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<32>(S);

      // the scale on the fp32 scores, softcap, masks and the online
      // softmax of blockwise_attention, on this thread's 2 rows x 16 keys;
      // each option's branch is taken once a tile, not once a score
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) S[i] = softcap * tanhf(S[i] * scale / softcap);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) S[i] *= scale;
      }
      const bool full = t0 + kWgKeys <= Sk && (!causal || t0 + kWgKeys - 1 <= q_first) &&
                        (window <= 0 || t0 > q_last - window);
      if (!full) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qpos = q_first + r0 + 8 * ((i >> 1) & 1);
          const int key = t0 + 8 * (i >> 2) + 2 * cq + (i & 1);
          const bool ok =
              key < Sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
          if (!ok) S[i] = kNegInf;
        }
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(S[4 * j + 2 * rr], S[4 * j + 2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
        const float ms = m_safe * kLog2e;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * rr + e;
            // a masked score (-1e30) gives exactly 0, as the mask would
            const float p = fast_exp2(fmaf(S[idx], kLog2e, -ms));
            S[idx] = p;
            rs += p;
          }
        // 0 while m is -1e30 (m_safe is then 0 or a real score)
        corr[rr] = fast_exp2(fmaf(m[rr], kLog2e, -ms));
        l[rr] = l[rr] * corr[rr] + rs;  // this thread's share of the row; summed at the end
        m[rr] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        O[4 * j] *= corr[0];
        O[4 * j + 1] *= corr[0];
        O[4 * j + 2] *= corr[1];
        O[4 * j + 3] *= corr[1];
      }

      // p in fp32 as p_hi + p_lo, both bf16: the accumulator layout of
      // m64n64 is the A-fragment layout of four k16 steps, so Ph[4 kk ..
      // 4 kk + 3] is step kk's fragment with no shuffle
      uint32_t Ph[16], Pl[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float p0 = S[4 * j + 2 * rr], p1 = S[4 * j + 2 * rr + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
          Ph[2 * j + rr] = *reinterpret_cast<const uint32_t*>(&hi);
          Pl[2 * j + rr] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      pin<NO>(O);  // the rescaled O and the fragments are defined before the fence
      pin<16>(Ph);
      pin<16>(Pl);
      wgmma_fence();
      if (wg == 0) {
#pragma unroll
        for (int kk = 0; kk < kWgKeys / 16; ++kk) {
          rs_step<DV>(O, Ph + 4 * kk, Vs, kk);
          rs_step<DV>(O, Pl + 4 * kk, Vs, kk);
        }
      } else if constexpr (NWG > 1) {  // columns from 128 on: V's regions from 2 on
#pragma unroll
        for (int kk = 0; kk < kWgKeys / 16; ++kk) {
          rs_step<DV1>(O, Ph + 4 * kk, Vs + 2 * kAtom, kk);
          rs_step<DV1>(O, Pl + 4 * kk, Vs + 2 * kAtom, kk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<NO>(O);
      pin<16>(Ph);
      pin<16>(Pl);

      __syncthreads();  // every warp's products are done with this stage
      if (tid == 0 && it + kWgStages < n_tiles)
        load_kv(KV0 + st * stage_bytes, &bars[st], tm_k, tm_v, ND, NV, kvh,
                t0 + kWgStages * kWgKeys, b);
      __syncwarp();
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  // a row of o is Dv columns; with two warpgroups, warpgroup 1's from 128 on
  const int ld = NWG > 1 ? Dv : DV;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    if (row >= Sq) continue;
    if (lse != nullptr && cq == 0 && wg == 0) store_lse(lse, b, h, H, Sq, row, m[rr], l[rr]);
    const float denom = fmaxf(l[rr], 1e-30f);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * Sq + row) * H + h) * ld + DV * wg + 2 * cq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      if (NWG == 1 || DV * wg + 8 * j < Dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(O[4 * j + 2 * rr] / denom, O[4 * j + 2 * rr + 1] / denom);
  }
}

// K10 on tensor cores at Dv <= 128: one warpgroup a block (the body above).
template <int ND, int DV>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                             int Sk, int H, int Kv, float scale, int causal, int window,
                             float softcap, int q_offset) {
  fa_wgmma_body<ND, DV, 0>(&tm_q, &tm_k, &tm_v, o, lse, Sq, Sk, H, Kv, DV, scale, causal, window,
                           softcap, q_offset);
}

// K10 on tensor cores at 128 < Dv <= 256: two warpgroups a block, columns
// [0, 128) and [128, 128 + DV1) (the body above).
template <int ND, int DV1>
__global__ void __launch_bounds__(2 * kWgThreads)
flash_attention_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                                  int Sk, int H, int Kv, int Dv, float scale, int causal,
                                  int window, float softcap, int q_offset) {
  fa_wgmma_body<ND, 128, DV1>(&tm_q, &tm_k, &tm_v, o, lse, Sq, Sk, H, Kv, Dv, scale, causal,
                              window, softcap, q_offset);
}

// ------------------------------------------------------------------ K11

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxG = 16;     // query heads a kv head
constexpr int kMaxDim = 256;  // D and Dv

// CH = 16 / sizeof(T) elements of a cache row from `d0`, as fp32: one
// 16-byte load when the rows allow it (`vec`), else element by element;
// zeros past `n`.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int d0, int n, bool vec, float* out);
template <>
__device__ __forceinline__ void load_chunk<float>(const float* row, int d0, int n, bool vec,
                                                  float* out) {
  if (vec && d0 < n) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row + d0));
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = d0 + e < n ? row[d0 + e] : 0.f;
}
template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16>(const __nv_bfloat16* row, int d0, int n,
                                                          bool vec, float* out) {
  if (vec && d0 < n) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + d0));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = d0 + e < n ? __bfloat162float(row[d0 + e]) : 0.f;
}

// the weight of a partial with max m under the common max m_safe
__device__ __forceinline__ float merge_weight(float m, float m_safe) {
  return m <= kNegInf / 2 ? 0.f : expf(m - m_safe);
}

// E: the elements of a cache row a lane of K11 holds (E / CH 16-byte chunks)
template <typename T, int DM>
__host__ __device__ constexpr int dec_lane_elems() {
  constexpr int CH = 16 / sizeof(T);
  return DM / (32 * CH) > 1 ? DM / 32 : CH;
}

// flash_decode (K11), split over S. Grid (B * Kv, n_split): block (bkv,
// sp) takes slots [sp * split, (sp + 1) * split) of kv head bkv and its G
// query heads. DM, the widths' bound (128 or 256), sizes the scaled
// queries and the warps' partial sums in dynamic shared memory ((1 +
// kDecWarps) GM DM floats: 80 KB at GM = 16, DM = 256). A lane group of
// `lps` lanes (a power of two, at most 32) holds one slot's k and v rows,
// E = NC CH elements a lane (NC = 2 16-byte chunks for fp32 at DM = 256,
// else 1, so a row of 256 fits one warp); the block's 128 / lps groups
// each walk every (128 / lps)-th slot of the split with their own online
// softmax (m, l and acc in fp32 for each of the GM <= 16 rows), are merged
// within the warp by shuffles and across warps in shared memory, and the
// block writes its partial (m, l, acc[Dv]) for each row. A block with no
// valid slot writes the neutral partial (m = -1e30, l = 0, acc = 0) and
// reads nothing of the cache. The block that takes the last ticket of its
// (b, kv head) merges the n_split partials in split order (no float
// atomics: the same inputs give the same bits) into o, and resets the
// ticket to 0 for the next launch.
template <typename T, int GM, int DM>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    T* __restrict__ o, const int* __restrict__ pos_ptr, float* __restrict__ part,
                    int* __restrict__ tickets, int S, int Kv, int G, int D, int Dv, float scale,
                    int window, int ring, float softcap, int split, int lps, int vec) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int E = dec_lane_elems<T, DM>();
  extern __shared__ __align__(16) float dec_smem[];
  float* Qs = dec_smem;           // [GM][DM], scaled
  float* Wacc = Qs + GM * DM;     // [kDecWarps][GM][DM]
  __shared__ float Wm[kDecWarps][GM], Wl[kDecWarps][GM];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bkv = blockIdx.x, b = bkv / Kv, kvh = bkv % Kv, H = Kv * G;
  const int n_split = gridDim.y, sp = blockIdx.y;
  const int Dp = Dv + 2;  // a partial: m, l, acc[Dv]
  float* parts = part + static_cast<long long>(bkv) * G * n_split * Dp;  // [G][n_split][Dp]
  const int pos = *pos_ptr;

  // this split's slots that can be valid: all of a ring; else (pos - window, pos]
  int lo = sp * split, hi = min(S, lo + split) - 1;
  if (!ring) {
    hi = min(hi, pos);
    if (window > 0) lo = max(lo, pos - window + 1);
  }

  if (lo > hi) {
    for (int idx = tid; idx < G * Dp; idx += kDecThreads) {
      const int g = idx / Dp, e = idx % Dp;
      parts[(static_cast<long long>(g) * n_split + sp) * Dp + e] = e == 0 ? kNegInf : 0.f;
    }
  } else {
    for (int idx = tid; idx < GM * DM; idx += kDecThreads) {
      const int g = idx / DM, d = idx % DM;
      float val = 0.f;
      if (g < G && d < D)
        val = load_f(q + (static_cast<long long>(b) * H + kvh * G + g) * D + d) * scale;
      Qs[g * DM + d] = val;
    }
    __syncthreads();

    const int per_warp = 32 / lps;
    const int sub = lane % lps, d0 = sub * E;
    const int gid = warp * per_warp + lane / lps, n_groups = kDecWarps * per_warp;
    float m[GM], l[GM], acc[GM][E];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }

    const T* kb = kc + (static_cast<long long>(b) * S * Kv + kvh) * D;
    const T* vb = vc + (static_cast<long long>(b) * S * Kv + kvh) * Dv;
    const int n_iter = (hi - lo + n_groups) / n_groups;  // the same for every lane of the block
    for (int it = 0; it < n_iter; ++it) {
      const int j = lo + it * n_groups + gid;
      bool valid = j <= hi;
      if (valid && ring) {
        int back = (pos - j) % S;
        if (back < 0) back += S;
        const int a = pos - back;
        valid = a >= 0 && a <= pos && (window <= 0 || a > pos - window);
      }
      float kf[E], vf[E];
      if (valid) {
#pragma unroll
        for (int c = 0; c < E / CH; ++c) {
          load_chunk(kb + static_cast<long long>(j) * Kv * D, d0 + c * CH, D, vec, kf + c * CH);
          load_chunk(vb + static_cast<long long>(j) * Kv * Dv, d0 + c * CH, Dv, vec, vf + c * CH);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] = vf[e] = 0.f;
      }
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        s[g] = 0.f;
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < E; ++e) s[g] = fmaf(Qs[g * DM + d0 + e], kf[e], s[g]);
      }
      for (int off = lps / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
        }
      if (!valid) continue;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float sg = softcap_f(s[g], softcap);
        const float m_new = fmaxf(m[g], sg);
        const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
        const float p = expf(sg - m_safe);
        const float corr = merge_weight(m[g], m_safe);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e] * corr);
        m[g] = m_new;
      }
    }

    // merge the warp's groups (lanes with the same `sub` hold the same columns)
    for (int off = lps; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float M = fmaxf(m[g], m_o);
        const float Ms = M <= kNegInf / 2 ? 0.f : M;
        const float wa = merge_weight(m[g], Ms), wb = merge_weight(m_o, Ms);
        l[g] = wa * l[g] + wb * l_o;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = wa * acc[g][e] + wb * a_o;
        }
        m[g] = M;
      }
    if (lane < lps) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        if (sub == 0) {
          Wm[warp][g] = m[g];
          Wl[warp][g] = l[g];
        }
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (d0 + e < Dv) Wacc[(warp * GM + g) * DM + d0 + e] = acc[g][e];
      }
    }
    __syncthreads();

    // merge the warps, in warp order, into the block's partial
    for (int idx = tid; idx < G * Dv; idx += kDecThreads) {
      const int g = idx / Dv, dv = idx % Dv;
      float M = kNegInf;
      for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, Wm[w][g]);
      const float Ms = M <= kNegInf / 2 ? 0.f : M;
      float L = 0.f, A = 0.f;
      for (int w = 0; w < kDecWarps; ++w) {
        const float wt = merge_weight(Wm[w][g], Ms);
        L += wt * Wl[w][g];
        A += wt * Wacc[(w * GM + g) * DM + dv];
      }
      float* dst = parts + (static_cast<long long>(g) * n_split + sp) * Dp;
      dst[2 + dv] = A;
      if (dv == 0) {
        dst[0] = M;
        dst[1] = L;
      }
    }
  }

  // the last block of this (b, kv head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[bkv], 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < G * Dv; idx += kDecThreads) {
    const int g = idx / Dv, dv = idx % Dv;
    const float* src = parts + static_cast<long long>(g) * n_split * Dp;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, __ldcg(src + s * Dp));
    const float Ms = M <= kNegInf / 2 ? 0.f : M;
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float wt = merge_weight(__ldcg(src + s * Dp), Ms);
      L += wt * __ldcg(src + s * Dp + 1);
      A += wt * __ldcg(src + s * Dp + 2 + dv);
    }
    store_f(o + (static_cast<long long>(b) * H + kvh * G + g) * Dv + dv, A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) tickets[bkv] = 0;
}


template <typename T, int DT>
int launch_fa(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
              int Sk, int H, int Kv, int D, int Dv, float scale, int causal, int window,
              float softcap, int q_offset, cudaStream_t s) {
  static bool ready = false;
  auto kernel = flash_attention_kernel<T, DT>;
  cudaError_t err = allow_smem(kernel, FaSmem<DT>::bytes, &ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kTQ - 1) / kTQ, B * H);
  kernel<<<grid, kFaThreads, FaSmem<DT>::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H, Kv, D, Dv, scale, causal, window,
      softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}


template <int ND, int DV>
int launch_fa_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
                    void* lse, int B, int Sq, int Sk, int H, int Kv, int Dv, float scale,
                    int causal, int window, float softcap, int q_offset, cudaStream_t s) {
  static bool ready = false;
  auto kernel = flash_attention_wgmma_kernel<ND, DV>;
  cudaError_t err = allow_smem(kernel, wg_smem_bytes(ND, DV), &ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kWgRows - 1) / kWgRows, B * H);
  kernel<<<grid, kWgThreads, wg_smem_bytes(ND, DV), s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq, Sk, H, Kv, scale,
      causal, window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// Dv in (128, 128 + DV1]: two warpgroups a block
template <int ND, int DV1>
int launch_fa_wgmma_wide(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         void* o, void* lse, int B, int Sq, int Sk, int H, int Kv, int Dv,
                         float scale, int causal, int window, float softcap, int q_offset,
                         cudaStream_t s) {
  static bool ready = false;
  auto kernel = flash_attention_wgmma_wide_kernel<ND, DV1>;
  constexpr size_t smem = wg_smem_bytes(ND, 128 + DV1);
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kWgRows - 1) / kWgRows, B * H);
  kernel<<<grid, 2 * kWgThreads, smem, s>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                             static_cast<float*>(lse), Sq, Sk, H, Kv, Dv, scale,
                                             causal, window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GM, int DM>
int launch_decode(const void* q, const void* kc, const void* vc, void* o, const void* pos,
                  void* part, void* tickets, int B, int S, int Kv, int G, int D, int Dv,
                  float scale, int window, int ring, float softcap, int split, cudaStream_t s) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int E = dec_lane_elems<T, DM>();
  const int need = (std::max(D, Dv) + E - 1) / E;
  int lps = 1;
  while (lps < need) lps *= 2;
  const bool aligned = reinterpret_cast<uintptr_t>(kc) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vc) % 16 == 0;
  const int vec = aligned && D % CH == 0 && Dv % CH == 0;
  static bool ready = false;
  auto kernel = flash_decode_kernel<T, GM, DM>;
  constexpr size_t smem = (1 + kDecWarps) * GM * DM * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * Kv, (S + split - 1) / split);
  kernel<<<grid, kDecThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(o), static_cast<const int*>(pos), static_cast<float*>(part),
      static_cast<int*>(tickets), S, Kv, G, D, Dv, scale, window, ring, softcap, split, lps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DM>
int launch_decode_g(const void* q, const void* kc, const void* vc, void* o, const void* pos,
                    void* part, void* tickets, int B, int S, int Kv, int G, int D, int Dv,
                    float scale, int window, int ring, float softcap, int split, cudaStream_t s) {
  const auto run = [&](auto launch) {
    return launch(q, kc, vc, o, pos, part, tickets, B, S, Kv, G, D, Dv, scale, window, ring,
                  softcap, split, s);
  };
  if (G == 1) return run(launch_decode<T, 1, DM>);
  if (G <= 4) return run(launch_decode<T, 4, DM>);
  if (G <= 8) return run(launch_decode<T, 8, DM>);
  return run(launch_decode<T, kMaxG, DM>);
}

}  // namespace

// The instantiations for heads past the widths of 192 and 128 that a launch
// at widths D, Dv takes, each test the one its dispatch below branches on:
// the wrappers count those launches apart. The CUDA-core forward's tiles of
// 256; the tensor-core forward's two warpgroups a block; K11 sized for 256
// columns.
extern "C" int flash_attention_simt_wide(int D, int Dv) { return std::max(D, Dv) > 192; }
extern "C" int flash_attention_wgmma_wide(int, int Dv) { return Dv > 128; }
extern "C" int flash_decode_wide(int D, int Dv) { return std::max(D, Dv) > 128; }

// K10 on CUDA cores. dtype: 0 = float32, 1 = bfloat16 (q, k, v and o
// alike). D and Dv at most 256; H a multiple of Kv; B * H at most 65,535.
// window 0 = none; softcap 0 = none. Returns a cudaError_t as int (0 =
// success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Sk, int H, int Kv, int D,
                                   int Dv, float scale, int causal, int window, float softcap,
                                   int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Kv <= 0 || H % Kv || D <= 0 || Dv <= 0 || D > 256 ||
      Dv > 256 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = std::max(D, Dv);  // the tiles' width: 64, 128, 192 or 256
  const auto run = [&](auto launch) {
    return launch(q, k, v, o, lse, B, Sq, Sk, H, Kv, D, Dv, scale, causal, window, softcap,
                  q_offset, s);
  };
  const bool wide = flash_attention_simt_wide(D, Dv);
  if (dtype == 0)
    return wide           ? run(launch_fa<float, 256>)
           : width <= 64  ? run(launch_fa<float, 64>)
           : width <= 128 ? run(launch_fa<float, 128>)
                          : run(launch_fa<float, 192>);
  if (dtype == 1)
    return wide           ? run(launch_fa<__nv_bfloat16, 256>)
           : width <= 64  ? run(launch_fa<__nv_bfloat16, 64>)
           : width <= 128 ? run(launch_fa<__nv_bfloat16, 128>)
                          : run(launch_fa<__nv_bfloat16, 192>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10 on tensor cores: bf16 q, k, v and o, contiguous, 16-byte aligned; D
// and Dv multiples of 16 up to 256; H a multiple of Kv; B * H at most
// 65,535. Dv <= 128 takes flash_attention_wgmma_kernel<ceil(D / 64), Dv>,
// Dv > 128 flash_attention_wgmma_wide_kernel<ceil(D / 64), 64 or 128>. Returns a cudaError_t as int (0 = success), or a negated
// CUresult if a tensor map could not be encoded.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int B, int Sq, int Sk, int H, int Kv, int D,
                                         int Dv, float scale, int causal, int window,
                                         float softcap, int q_offset, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Kv <= 0 || H % Kv || D <= 0 || Dv <= 0 || D > 256 ||
      Dv > 256 || D % 16 || Dv % 16 || static_cast<long long>(B) * H > 65535 || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, Sq, H, D);
  if (err == 0) err = make_map(&tk, k, B, Sk, Kv, D);
  if (err == 0) err = make_map(&tv, v, B, Sk, Kv, Dv);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launch) {
    return launch(tq, tk, tv, o, lse, B, Sq, Sk, H, Kv, Dv, scale, causal, window, softcap,
                  q_offset, s);
  };
  const int nd = (D + 63) / 64;
  if (!flash_attention_wgmma_wide(D, Dv)) switch (Dv) {
#define K10_DV(n)                                                                            \
  case n:                                                                                    \
    return nd == 1 ? run(launch_fa_wgmma<1, n>)                                              \
         : nd == 2 ? run(launch_fa_wgmma<2, n>)                                              \
         : nd == 3 ? run(launch_fa_wgmma<3, n>)                                              \
                   : run(launch_fa_wgmma<4, n>);
    K10_DV(16) K10_DV(32) K10_DV(48) K10_DV(64) K10_DV(80) K10_DV(96) K10_DV(112) K10_DV(128)
#undef K10_DV
  }
  // Dv in (128, 256]: warpgroup 1's columns from 128 on, 64 or 128 of them
#define K10_WIDE(n)                                                                          \
  (nd == 1 ? run(launch_fa_wgmma_wide<1, n>)                                                 \
   : nd == 2 ? run(launch_fa_wgmma_wide<2, n>)                                               \
   : nd == 3 ? run(launch_fa_wgmma_wide<3, n>)                                               \
             : run(launch_fa_wgmma_wide<4, n>))
  return Dv <= 192 ? K10_WIDE(64) : K10_WIDE(128);
#undef K10_WIDE
}

// K11. pos: one int32 on the device. G = H / Kv at most 16; D and Dv at
// most 256 (max(D, Dv) <= 128 takes DM = 128, else 256). part: B * H *
// ceil(S / split) * (Dv + 2) fp32 of scratch; tickets: B * Kv int32, 0
// before the launch (the launch leaves them 0).
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, void* o, const void* pos, void* part,
                                void* tickets, int B, int S, int Kv, int G, int D, int Dv,
                                float scale, int window, int ring, float softcap, int split,
                                void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || G <= 0 || G > kMaxG || D <= 0 || Dv <= 0 ||
      D > kMaxDim || Dv > kMaxDim || split <= 0 || (S + split - 1) / split > 65535 ||
      static_cast<long long>(B) * Kv > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = !flash_decode_wide(D, Dv);
  const auto run = [&](auto launch) {
    return launch(q, k_cache, v_cache, o, pos, part, tickets, B, S, Kv, G, D, Dv, scale, window,
                  ring, softcap, split, s);
  };
  if (dtype == 0)
    return narrow ? run(launch_decode_g<float, 128>) : run(launch_decode_g<float, 256>);
  if (dtype == 1)
    return narrow ? run(launch_decode_g<__nv_bfloat16, 128>)
                  : run(launch_decode_g<__nv_bfloat16, 256>);
  return static_cast<int>(cudaErrorInvalidValue);
}
