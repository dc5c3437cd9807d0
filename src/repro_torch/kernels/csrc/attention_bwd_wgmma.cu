// K10's backward on Hopper's tensor cores: dq, dk and dv of the forward's
// attention in bf16 at head widths of 16 n (the CUDA-core design for
// every other input stays in csrc/attention_bwd.cu).
//
// Replaces no Pallas kernel: the JAX package differentiates the model's
// jnp attention (src/repro/models/attention.py:84 blockwise_attention)
// with jax.grad, and the Pallas K10 (src/repro/kernels/flash_attention.py
// :103) has no backward. It computes what csrc/attention_bwd.cu computes,
// over the forward's whole contract: causal or not, the query offset, the
// scale, a sliding window, the tanh softcap (its derivative from the
// recomputed raw score), GQA with H a multiple of Kv, Sq != Sk, ragged
// tiles, D != Dv (multiples of 16 up to 256), rows with no valid key
// (lse +inf, so P = 0 and their gradients are 0). FlashAttention-2's equations
// from the forward's row log-sum-exp:
//   s_raw = scale (q . k),  t = tanh(s_raw / cap),  s = cap t (s_raw
//   without a softcap),  P = exp(s - lse) on valid keys (0 elsewhere),
//   di = rowsum(dO o),  dV = P^T dO,  dP = dO V^T,  dS = P (dP - di)
//   (1 - t^2),  dQ = scale dS K,  dK = scale dS^T q.
//
// Three launches a call on the caller's stream, no atomics, each sum in
// one fixed order (a second call gives the first call's bits):
//   fa_bwd_prep_kernel: 8 lanes a (b, i, h) row: di = rowsum(dO o) and
//     lse2 = lse log2(e), both padded to whole tiles of 64 rows (lse2 +inf
//     and di 0 past Sq, so TMA's zero fill never stands in for them);
//   fa_bwd_dkdv_wgmma_kernel: grid (ceil(Sk / 64), B Kv), one warpgroup
//     owns 64 keys of one kv head. Its K and V tiles are loaded once by
//     TMA (csrc/wgmma_tma.cuh: 4-d tensor maps over the (B, S, heads, D)
//     layouts, 128-byte swizzle); it walks its G = H / Kv query heads in
//     order and each head's query tiles of 64 rows in order (only those
//     the causal mask and the window leave), Q, dO and the tile's lse2 and
//     di streaming through a ring of 2 stages (TMA and 1-d bulk copies on
//     mbarriers). Per tile: S^T = K Q^T and dP^T = V dO^T by wgmma
//     m64n64k16 from shared memory (both K-major), committed as two
//     groups, so that without a softcap P^T's exponentials run while dP^T's
//     products are in flight; P^T and dS^T in registers from the fp32
//     accumulators (lse2 and di broadcast along a column, ex2 on the
//     special-function unit); then dV += P^T dO and dK
//     += dS^T Q by register-A wgmma (the accumulator layout of S^T is the
//     A-fragment layout, dO and Q read from the same tiles MN-major). The
//     scale goes on the fp32 dK at the end, never on bf16 q;
//   fa_bwd_dkdv_split_kernel, the dK/dV pass at ND or NV = 3: one
//     warpgroup's registers cannot hold dK (96 floats a thread), dV (64),
//     S^T and dP^T (32 each) at once, so two warpgroups a block share its
//     64 keys and the same streamed stages: warpgroup 0 accumulates dV from
//     S^T alone (P^T . dO), warpgroup 1 dK from S^T and dP^T (dS^T . Q);
//     each computes S^T from the shared tiles (S^T's product twice a tile);
//   fa_bwd_dkdv_halves_kernel, the dK/dV pass at ND or NV = 4 (gemma3's
//     heads of 256): the split kernel's two warpgroups over two column
//     blocks on the grid's z, block z accumulating dV's and dK's 128-wide
//     half z (64 floats a thread instead of 128), each block computing S^T
//     and dP^T whole;
//   fa_bwd_dq_wgmma_kernel: grid (ceil(Sq / 64), B H), one warpgroup owns
//     64 query rows of one head (Q and dO loaded once) and walks the kv
//     tiles of 64 keys the forward visits, K and V through the same ring:
//     S = Q K^T and dP = dO V^T from shared memory (P's exponentials again
//     beside dP's products), dQ += dS K by register-A wgmma with K
//     MN-major; at ND = 4 fa_bwd_dq_halves_kernel, two column blocks on
//     the grid's z, each dQ's 128-wide half from S and dP computed whole.
// P and dS stay fp32 as two bf16 terms, hi + lo, each a register-A product
// into the same fp32 sums, as the forward keeps p (csrc/attention.cu: one
// bf16 term would change 42 % of its bf16 outputs at 1,500 keys): 10
// products a tile pair instead of 5.
//
// What bounds it: at whisper-base's training encoder (B=4, Sq=Sk=384, H=8,
// D=64, bf16) the function's 3.02 GFLOP of products take 3.05 us at the
// bf16 tensor rate, its 12.6 MB 3.77 us at the memory rate, and the hi/lo
// terms double the register-A products (about 6.1 us of tensor work). What
// the design leaves: within a warpgroup, but for P beside dP, a tile's
// products, its elementwise work and its conversions run one after the
// other (2 to 4 blocks an SM overlap each other's); the dK/dV grid is
// ceil(Sk / 64) B Kv blocks (192 at the encoder, 1.45 an SM; 64 at
// qwen3-8b's head layout B=4, S=128, Kv=8, on 132 SMs); S and dP are
// recomputed in both passes. Registers (ptxas): dK/dV 184 at D = Dv = 64,
// 247 at 128, dQ 126 and 158; no spills. At D = 192, Dv = 128 a block takes
// bwd_smem_bytes(3, 2) = 124,952 B, at D = Dv = 256 bwd_smem_bytes(4, 4) =
// 198,680 B: one block an SM, in both passes. The halves kernels recompute
// S and dP once more for each column block (the products of S^T and dP^T
// of a key tile run in two blocks of dK/dV and two of dQ).
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes
// (kernels/flash_attention.py). The entry point allocates nothing: the
// wrapper passes the padded lse2 and di scratch. It returns the first
// cudaError_t of its launches, or a negated CUresult if a tensor map could
// not be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tma.cuh"  // TMA, mbarriers, wgmma descriptors and products, tensor maps

namespace {

constexpr int kRows = 64;         // keys a dK/dV block, query rows a dQ block, rows of every tile
constexpr int kThreads = 128;     // one warpgroup
constexpr int kStages = 2;        // streamed tiles in flight
constexpr int kPrepThreads = 256;  // 32 rows of di a block
static_assert(kRows == kTmaRows, "a tile is one tensor-map box");

// Eight lanes a (b, i, h) row, 16-byte loads of 8 values (Dv is a
// multiple of 16, so a row is whole 16-byte chunks), the row's sum over
// its lanes by a xor tree; rows i over Sq_pad, the padded rows written as
// +inf and 0.
__global__ void __launch_bounds__(kPrepThreads)
fa_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ lse2,
                   float* __restrict__ di, long long rows, int Sq, int Sq_pad, int H, int Dv) {
  const long long row = (static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x) / 8;
  const int sub = threadIdx.x % 8;
  if (row >= rows) return;  // whole warps leave: rows is a multiple of 64
  const int h = static_cast<int>(row % H);
  const int i = static_cast<int>((row / H) % Sq_pad);
  const long long b = row / (static_cast<long long>(H) * Sq_pad);
  const long long at = (b * H + h) * Sq_pad + i;
  float acc = 0.f;
  if (i < Sq) {
    const long long src = ((b * Sq + i) * H + h) * Dv;
    const uint4* dr = reinterpret_cast<const uint4*>(dout + src);
    const uint4* orow = reinterpret_cast<const uint4*>(o + src);
    for (int c = sub; c < Dv / 8; c += 8) {
      const uint4 x = dr[c], y = orow[c];
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
        const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
        acc = fmaf(a.x, p.x, acc);
        acc = fmaf(a.y, p.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0) {
    di[at] = acc;  // 0 past Sq
    // lse log2(e): +inf stays +inf, and +inf past Sq, so P = 0 on those rows
    lse2[at] = i < Sq ? lse[(b * H + h) * Sq + i] * kLog2e : __int_as_float(0x7f800000);
  }
}

// Shared memory of both passes, each operand region 1,024-byte aligned as
// the 128-byte swizzle needs: the block's fixed tiles (ND + NV regions),
// kStages stages of streamed tiles (ND + NV regions each), the stages'
// lse2 and di rows (the dK/dV pass), then the mbarriers.
constexpr size_t bwd_smem_bytes(int nd, int nv) {
  return 1024 + static_cast<size_t>(kAtom) * (nd + nv) * (1 + kStages) +
         2 * kStages * kRows * sizeof(float) + 8 * (kStages + 1);
}

// P of one score without a softcap: s the raw fp32 product (q . k), l2
// the row's lse2, ok whether the key is valid for the row. dS = P (dp -
// di) is the caller's, once dp has landed.
__device__ __forceinline__ float prob(float s, float l2, float scale, bool ok) {
  return ok ? fast_exp2(fmaf(s * scale, kLog2e, -l2)) : 0.f;
}

// One score's P and dS in place under a softcap: dp the row's dO . v, dd
// its di; dS takes the softcap's derivative 1 - t^2 from the raw score.
__device__ __forceinline__ void p_and_ds_softcap(float& s, float& dp, float l2, float dd,
                                                 float scale, float softcap, bool ok) {
  const float t = tanhf(s * scale / softcap);
  const float p = ok ? fast_exp2(fmaf(softcap * t, kLog2e, -l2)) : 0.f;
  s = p;
  dp = p * (dp - dd) * (1.f - t * t);
}

// P of one score under a softcap, without dS (the dV warpgroup's).
__device__ __forceinline__ float prob_softcap(float s, float l2, float scale, float softcap,
                                              bool ok) {
  return ok ? fast_exp2(fmaf(softcap * tanhf(s * scale / softcap), kLog2e, -l2)) : 0.f;
}

__device__ __forceinline__ bool key_valid(int key, int qpos, int Sk, int causal, int window) {
  return key < Sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// An m64n64 fp32 accumulator as bf16 A fragments for four k16 steps, x =
// hi + lo: hi = bf16(x), lo = bf16(x - hi) (x - hi is exact in fp32).
__device__ __forceinline__ void split_bf16(const float* x, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float x0 = x[4 * j + 2 * rr], x1 = x[4 * j + 2 * rr + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      hi[2 * j + rr] = *reinterpret_cast<const uint32_t*>(&h);
      lo[2 * j + rr] = *reinterpret_cast<const uint32_t*>(&l);
    }
}

// C (m64 x n64) = A . B^T over the ND 64-column regions of two K-major
// tiles (columns past the width are zeros in both).
template <int ND>
__device__ __forceinline__ void product_ss(float* C, const uint8_t* A, const uint8_t* B) {
#pragma unroll
  for (int kk = 0; kk < 4 * ND; ++kk) {
    const int off = (kk >> 2) * kAtom + (kk & 3) * 32;
    wgmma_ss_n64(C, desc_kmajor(A + off), desc_kmajor(B + off), kk > 0);
  }
}

// Rows r0 and r0 + 8 of a 64-row accumulator (N / 2 floats a thread) into
// row-major bf16 rows `ld` elements apart, columns below `width`, times
// `mul`; rows at or past `n_rows` are not written.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long stride, int row0,
                                           int n_rows, int width, const float* acc, float mul,
                                           int r0, int cq) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + r0 + 8 * rr;
    if (row >= n_rows) continue;
    __nv_bfloat16* dst = out + row * stride + 2 * cq;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (8 * j < width)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * rr] * mul, acc[4 * j + 2 * rr + 1] * mul);
  }
}

// Rows [r0, r0 + 64) of head `head`, batch b, of two tensors that share
// their rows (K and V, Q and dO): ND regions of the first, then NV of the
// second, completing on `bar` (the phase's one arrival, with its bytes).
template <int ND, int NV>
__device__ __forceinline__ void load_tiles(uint8_t* dst, uint64_t* bar, const CUtensorMap* tm_a,
                                           const CUtensorMap* tm_b, int head, int r0, int b,
                                           uint32_t extra_bytes = 0) {
  mbar_expect_tx(bar, (ND + NV) * kAtom + extra_bytes);
  for (int r = 0; r < ND; ++r) tma_load_4d(dst + r * kAtom, tm_a, 64 * r, head, r0, b, bar);
  for (int c = 0; c < NV; ++c) tma_load_4d(dst + (ND + c) * kAtom, tm_b, 64 * c, head, r0, b, bar);
}

// A dK/dV stage: the Q and dO tiles of rows [q0, q0 + 64) of head h, and
// the same rows' lse2 and di (padded: `at` indexes row q0 of the head)
// into rs[0, 64) and rs[64, 128), completing on `bar`.
template <int ND, int NV>
__device__ __forceinline__ void load_rows_stage(uint8_t* dst, float* rs, uint64_t* bar,
                                                const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                                const float* lse2, const float* di, long long at,
                                                int h, int q0, int b) {
  load_tiles<ND, NV>(dst, bar, tm_q, tm_do, h, q0, b, 2 * kRows * sizeof(float));
  bulk_load(rs, lse2 + at, kRows * sizeof(float), bar);
  bulk_load(rs + kRows, di + at, kRows * sizeof(float), bar);
}

__device__ __forceinline__ void init_bars(uint64_t* bars, int n) {
  for (int s = 0; s < n; ++s) mbar_init(&bars[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dK and dV of 64 keys of one kv head (ND = ceil(D / 64), NV = ceil(Dv /
// 64); the accumulators are 64 ND and 64 NV wide, columns past D and Dv
// zeros). Thread 0 issues every copy.
template <int ND, int NV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse2,
                         const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Sq_pad, int Sk, int H,
                         int Kv, int D, int Dv, float scale, int causal, int window,
                         float softcap, int q_offset) {
  constexpr int stage_bytes = (ND + NV) * kAtom;  // Q, then dO
  extern __shared__ uint8_t bwd_smem[];
  uint8_t* base = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  uint8_t* Ks = base;
  uint8_t* Vs = Ks + ND * kAtom;
  uint8_t* stage0 = Vs + NV * kAtom;
  float* rows_s = reinterpret_cast<float*>(stage0 + kStages * stage_bytes);  // [stage][lse2, di]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows_s + 2 * kStages * kRows);
  uint64_t* kvbar = bars + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's keys: r0 and r0 + 8
  const int cq = lane & 3;                 // and its query pair in each 8 columns
  const int kvh = blockIdx.y % Kv;
  const int b = blockIdx.y / Kv;
  const int G = H / Kv;
  const int k0 = blockIdx.x * kRows;
  const CUtensorMap* tm_q_ptr = &tm_q;
  const CUtensorMap* tm_do_ptr = &tm_do;

  // query rows [i_lo, i_hi) can see some key of this block
  const int k_last = min(k0 + kRows, Sk) - 1;
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - q_offset);
  if (window > 0) i_hi = min(Sq, max(0, k_last + window - q_offset));
  const int q_first_tile = (i_lo / kRows) * kRows;
  const int n_qt = i_hi > q_first_tile ? (i_hi - q_first_tile + kRows - 1) / kRows : 0;
  const int n_tiles = G * n_qt;  // head g's tiles, then head g + 1's

  // tile `it`: rows q0.. of head kvh G + it / n_qt into its stage
  const auto load_stage = [=](int it) {
    const int st = it % kStages;
    const int h = kvh * G + it / n_qt;
    const int q0 = q_first_tile + (it % n_qt) * kRows;
    load_rows_stage<ND, NV>(stage0 + st * stage_bytes, rows_s + st * 2 * kRows, &bars[st],
                            tm_q_ptr, tm_do_ptr, lse2, di,
                            (static_cast<long long>(b) * H + h) * Sq_pad + q0, h, q0, b);
  };

  float dK[32 * ND], dV[32 * NV];
#pragma unroll
  for (int i = 0; i < 32 * ND; ++i) dK[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32 * NV; ++i) dV[i] = 0.f;

  if (n_tiles > 0) {
    if (tid == 0) {
      init_bars(bars, kStages + 1);
      load_tiles<ND, NV>(Ks, kvbar, &tm_k, &tm_v, kvh, k0, b);  // Vs follows Ks
      for (int s = 0; s < min(n_tiles, kStages); ++s) load_stage(s);
    }
    __syncthreads();  // the barriers are initialised before anyone waits on them
    mbar_wait(kvbar, 0);
    __syncwarp();

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint8_t* Qs = stage0 + st * stage_bytes;
      const uint8_t* dOs = Qs + ND * kAtom;
      const float* rs = rows_s + st * 2 * kRows;
      const int q0 = q_first_tile + (it % n_qt) * kRows;
      mbar_wait(&bars[st], (it / kStages) & 1);
      __syncwarp();

      // S^T = K . Q^T and dP^T = V . dO^T (a fresh pair each tile: nothing
      // carries over, so neither holds registers across the products below)
      float S[32], dP[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] = dP[i] = 0.f;
      pin<32>(S);
      pin<32>(dP);
      wgmma_fence();
      product_ss<ND>(S, Ks, Qs);
      wgmma_commit();
      product_ss<NV>(dP, Vs, dOs);
      wgmma_commit();

      // P^T and dS^T: rows are keys, columns query rows (their lse2 and di
      // from the stage); every mask term is checked only on a tile that
      // some pair of it fails. Without a softcap P's exponentials run while
      // dP^T's products are in flight; with one, dS needs the raw score's
      // tanh, so both wait.
      const int qpos0 = q_offset + q0;
      const bool full = k0 + kRows <= Sk && (!causal || k0 + kRows - 1 <= qpos0) &&
                        (window <= 0 || k0 > qpos0 + kRows - 1 - window);
      const auto ok = [&](int idx) {
        return full || key_valid(k0 + r0 + 8 * ((idx >> 1) & 1), qpos0 + 8 * (idx >> 2) +
                                 2 * cq + (idx & 1), Sk, causal, window);
      };
      if (softcap > 0.f) {
        wgmma_wait_all();
        pin<32>(S);
        pin<32>(dP);
#pragma unroll
        for (int idx = 0; idx < 32; ++idx) {
          const int col = 8 * (idx >> 2) + 2 * cq + (idx & 1);
          p_and_ds_softcap(S[idx], dP[idx], rs[col], rs[kRows + col], scale, softcap, ok(idx));
        }
      } else {
        wgmma_wait<1>();
        pin<32>(S);
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          S[idx] = prob(S[idx], rs[8 * (idx >> 2) + 2 * cq + (idx & 1)], scale, ok(idx));
        wgmma_wait_all();
        pin<32>(dP);
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          dP[idx] = S[idx] * (dP[idx] - rs[kRows + 8 * (idx >> 2) + 2 * cq + (idx & 1)]);
      }

      // dV += P^T . dO and dK += dS^T . Q, each left operand as hi + lo
      uint32_t Ph[16], Pl[16], Dh[16], Dl[16];
      split_bf16(S, Ph, Pl);
      split_bf16(dP, Dh, Dl);
      pin<32 * ND>(dK);
      pin<32 * NV>(dV);
      pin<16>(Ph);
      pin<16>(Pl);
      pin<16>(Dh);
      pin<16>(Dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        rs_step<64 * NV>(dV, Ph + 4 * kk, dOs, kk);
        rs_step<64 * NV>(dV, Pl + 4 * kk, dOs, kk);
        rs_step<64 * ND>(dK, Dh + 4 * kk, Qs, kk);
        rs_step<64 * ND>(dK, Dl + 4 * kk, Qs, kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<32 * ND>(dK);
      pin<32 * NV>(dV);
      pin<16>(Ph);
      pin<16>(Pl);
      pin<16>(Dh);
      pin<16>(Dl);

      __syncthreads();  // every warp is done with this stage
      if (tid == 0 && it + kStages < n_tiles) load_stage(it + kStages);
      __syncwarp();
    }
  }

  const long long row0 = static_cast<long long>(b) * Sk * Kv + kvh;  // key 0 of this kv head
  store_rows<64 * ND>(dk + row0 * D, static_cast<long long>(Kv) * D, k0, Sk, D, dK, scale, r0,
                      cq);
  store_rows<64 * NV>(dv + row0 * Dv, static_cast<long long>(Kv) * Dv, k0, Sk, Dv, dV, 1.f, r0,
                      cq);
}

// One k16 step of a column block's product, acc += a . tile over the block's
// 64-column regions of a tile of N regions: the whole tile where C = N (one
// block); else block 0 regions [0, C), block 1 the N - C after them.
template <int N, int C>
__device__ __forceinline__ void rs_block(float* acc, const uint32_t* a, const uint8_t* tile,
                                         int z, int kk) {
  if constexpr (C == N)
    rs_step<64 * N>(acc, a, tile, kk);
  else if (z == 0)
    rs_step<64 * C>(acc, a, tile, kk);
  else
    rs_step<64 * (N - C)>(acc, a, tile + C * kAtom, kk);
}

// dK and dV of 64 keys of one kv head on two warpgroups (the split and the
// halves kernels in the header): 256 threads, warpgroup 0 for dV, warpgroup
// 1 for dK, over the stages and in the tile order of
// fa_bwd_dkdv_wgmma_kernel, each sum in the same order (dV += P_hi^T dO +
// P_lo^T dO, dK += dS_hi^T Q + dS_lo^T Q, k16 step by k16 step). One
// accumulator array a thread, so that neither warpgroup holds the other's.
// NZ column blocks over the grid's z: block z accumulates dV's regions and
// dK's regions of rs_block (CV = ceil(NV / NZ) and CK = ceil(ND / NZ) of
// them; a warpgroup whose output has none in its block idles), so at NZ =
// 2 a thread holds 64 floats where one block would hold 128; each block
// computes S^T and dP^T whole. Thread 0 issues every copy; both warpgroups
// finish a stage before it is refilled.
template <int ND, int NV, int NZ>
__device__ __forceinline__ void dkdv_split_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse2, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sq_pad, int Sk,
    int H, int Kv, int D, int Dv, float scale, int causal, int window, float softcap,
    int q_offset) {
  constexpr int CK = (ND + NZ - 1) / NZ, CV = (NV + NZ - 1) / NZ;  // a block's regions
  constexpr int stage_bytes = (ND + NV) * kAtom;  // Q, then dO
  constexpr int NA = 32 * (CK > CV ? CK : CV);    // dK's floats a thread (dV uses 32 CV)
  extern __shared__ uint8_t bwd_smem[];
  uint8_t* base = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  uint8_t* Ks = base;
  uint8_t* Vs = Ks + ND * kAtom;
  uint8_t* stage0 = Vs + NV * kAtom;
  float* rows_s = reinterpret_cast<float*>(stage0 + kStages * stage_bytes);  // [stage][lse2, di]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows_s + 2 * kStages * kRows);
  uint64_t* kvbar = bars + kStages;

  const int tid = threadIdx.x, wg = tid / kThreads;  // 0: dV, 1: dK
  const int warp = (tid % kThreads) >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's keys: r0 and r0 + 8
  const int cq = lane & 3;                 // and its query pair in each 8 columns
  const int kvh = blockIdx.y % Kv;
  const int b = blockIdx.y / Kv;
  const int G = H / Kv;
  const int k0 = blockIdx.x * kRows;
  const int z = NZ > 1 ? static_cast<int>(blockIdx.z) : 0;  // this block's columns
  const bool cols = wg == 0 ? z * CV < NV : z * CK < ND;     // this warpgroup has some

  // query rows [i_lo, i_hi) can see some key of this block
  const int k_last = min(k0 + kRows, Sk) - 1;
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - q_offset);
  if (window > 0) i_hi = min(Sq, max(0, k_last + window - q_offset));
  const int q_first_tile = (i_lo / kRows) * kRows;
  const int n_qt = i_hi > q_first_tile ? (i_hi - q_first_tile + kRows - 1) / kRows : 0;
  const int n_tiles = G * n_qt;  // head g's tiles, then head g + 1's

  const auto load_stage = [=](int it) {
    const int st = it % kStages;
    const int h = kvh * G + it / n_qt;
    const int q0 = q_first_tile + (it % n_qt) * kRows;
    load_rows_stage<ND, NV>(stage0 + st * stage_bytes, rows_s + st * 2 * kRows, &bars[st], tm_q,
                            tm_do, lse2, di, (static_cast<long long>(b) * H + h) * Sq_pad + q0, h,
                            q0, b);
  };

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  if (n_tiles > 0) {
    if (tid == 0) {
      init_bars(bars, kStages + 1);
      load_tiles<ND, NV>(Ks, kvbar, tm_k, tm_v, kvh, k0, b);  // Vs follows Ks
      for (int s = 0; s < min(n_tiles, kStages); ++s) load_stage(s);
    }
    __syncthreads();  // the barriers are initialised before anyone waits on them
    mbar_wait(kvbar, 0);
    __syncwarp();

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint8_t* Qs = stage0 + st * stage_bytes;
      const uint8_t* dOs = Qs + ND * kAtom;
      const float* rs = rows_s + st * 2 * kRows;
      const int q0 = q_first_tile + (it % n_qt) * kRows;
      mbar_wait(&bars[st], (it / kStages) & 1);
      __syncwarp();

      const int qpos0 = q_offset + q0;
      const bool full = k0 + kRows <= Sk && (!causal || k0 + kRows - 1 <= qpos0) &&
                        (window <= 0 || k0 > qpos0 + kRows - 1 - window);
      const auto ok = [&](int idx) {
        return full || key_valid(k0 + r0 + 8 * ((idx >> 1) & 1), qpos0 + 8 * (idx >> 2) +
                                 2 * cq + (idx & 1), Sk, causal, window);
      };
      float S[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] = 0.f;
      if (!cols) {
        // no columns of this warpgroup's output in this block
      } else if (wg == 0) {
        // dV += P^T . dO, P^T from S^T = K . Q^T
        pin<32>(S);
        wgmma_fence();
        product_ss<ND>(S, Ks, Qs);
        wgmma_commit();
        wgmma_wait_all();
        pin<32>(S);
        if (softcap > 0.f) {
#pragma unroll
          for (int idx = 0; idx < 32; ++idx)
            S[idx] = prob_softcap(S[idx], rs[8 * (idx >> 2) + 2 * cq + (idx & 1)], scale, softcap,
                                  ok(idx));
        } else {
#pragma unroll
          for (int idx = 0; idx < 32; ++idx)
            S[idx] = prob(S[idx], rs[8 * (idx >> 2) + 2 * cq + (idx & 1)], scale, ok(idx));
        }
        uint32_t Ph[16], Pl[16];
        split_bf16(S, Ph, Pl);
        pin<32 * CV>(acc);
        pin<16>(Ph);
        pin<16>(Pl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          rs_block<NV, CV>(acc, Ph + 4 * kk, dOs, z, kk);
          rs_block<NV, CV>(acc, Pl + 4 * kk, dOs, z, kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin<32 * CV>(acc);
        pin<16>(Ph);
        pin<16>(Pl);
      } else {
        // dK += dS^T . Q, dS^T from S^T and dP^T = V . dO^T, as the one-warpgroup pass
        float dP[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dP[i] = 0.f;
        pin<32>(S);
        pin<32>(dP);
        wgmma_fence();
        product_ss<ND>(S, Ks, Qs);
        wgmma_commit();
        product_ss<NV>(dP, Vs, dOs);
        wgmma_commit();
        if (softcap > 0.f) {
          wgmma_wait_all();
          pin<32>(S);
          pin<32>(dP);
#pragma unroll
          for (int idx = 0; idx < 32; ++idx) {
            const int col = 8 * (idx >> 2) + 2 * cq + (idx & 1);
            p_and_ds_softcap(S[idx], dP[idx], rs[col], rs[kRows + col], scale, softcap, ok(idx));
          }
        } else {
          wgmma_wait<1>();
          pin<32>(S);
#pragma unroll
          for (int idx = 0; idx < 32; ++idx)
            S[idx] = prob(S[idx], rs[8 * (idx >> 2) + 2 * cq + (idx & 1)], scale, ok(idx));
          wgmma_wait_all();
          pin<32>(dP);
#pragma unroll
          for (int idx = 0; idx < 32; ++idx)
            dP[idx] = S[idx] * (dP[idx] - rs[kRows + 8 * (idx >> 2) + 2 * cq + (idx & 1)]);
        }
        uint32_t Dh[16], Dl[16];
        split_bf16(dP, Dh, Dl);
        pin<32 * CK>(acc);
        pin<16>(Dh);
        pin<16>(Dl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          rs_block<ND, CK>(acc, Dh + 4 * kk, Qs, z, kk);
          rs_block<ND, CK>(acc, Dl + 4 * kk, Qs, z, kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin<32 * CK>(acc);
        pin<16>(Dh);
        pin<16>(Dl);
      }

      __syncthreads();  // both warpgroups are done with this stage
      if (tid == 0 && it + kStages < n_tiles) load_stage(it + kStages);
      __syncwarp();
    }
  }

  const long long row0 = static_cast<long long>(b) * Sk * Kv + kvh;  // key 0 of this kv head
  if (wg == 0)
    store_rows<64 * CV>(dv + row0 * Dv + 64 * CV * z, static_cast<long long>(Kv) * Dv, k0, Sk,
                        Dv - 64 * CV * z, acc, 1.f, r0, cq);
  else
    store_rows<64 * CK>(dk + row0 * D + 64 * CK * z, static_cast<long long>(Kv) * D, k0, Sk,
                        D - 64 * CK * z, acc, scale, r0, cq);
}

#define K10_DKDV_PARAMS                                                                     \
  const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,       \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float *__restrict__ lse2, const float *__restrict__ di,                         \
      __nv_bfloat16 *__restrict__ dk, __nv_bfloat16 *__restrict__ dv, int Sq, int Sq_pad,   \
      int Sk, int H, int Kv, int D, int Dv, float scale, int causal, int window,            \
      float softcap, int q_offset
#define K10_DKDV_ARGS                                                                       \
  &tm_q, &tm_k, &tm_v, &tm_do, lse2, di, dk, dv, Sq, Sq_pad, Sk, H, Kv, D, Dv, scale, causal, \
      window, softcap, q_offset

// dK and dV at ND = 3 or NV = 3 (the split kernel): one column block.
template <int ND, int NV>
__global__ void __launch_bounds__(2 * kThreads, 1)
fa_bwd_dkdv_split_kernel(K10_DKDV_PARAMS) {
  dkdv_split_body<ND, NV, 1>(K10_DKDV_ARGS);
}

// dK and dV at ND = 4 or NV = 4 (the halves kernel): two column blocks.
template <int ND, int NV>
__global__ void __launch_bounds__(2 * kThreads, 1)
fa_bwd_dkdv_halves_kernel(K10_DKDV_PARAMS) {
  dkdv_split_body<ND, NV, 2>(K10_DKDV_ARGS);
}

// dQ of 64 query rows of one head, NZ column blocks over the grid's z
// (block z's regions of K are rs_block's: at NZ = 2, ND = 4, 64 floats a
// thread where one block would hold 128; S and dP are computed whole in
// each).
template <int ND, int NV, int NZ>
__device__ __forceinline__ void dq_body(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                        const float* __restrict__ lse2,
                                        const float* __restrict__ di,
                                        __nv_bfloat16* __restrict__ dq, int Sq, int Sq_pad,
                                        int Sk, int H, int Kv, int D, float scale, int causal,
                                        int window, float softcap, int q_offset) {
  constexpr int CK = (ND + NZ - 1) / NZ;  // a block's regions of dQ
  static_assert(NZ == 1 || ND > CK, "every column block has columns");
  constexpr int stage_bytes = (ND + NV) * kAtom;  // K, then V
  extern __shared__ uint8_t bwd_smem[];
  uint8_t* base = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* dOs = Qs + ND * kAtom;
  uint8_t* stage0 = dOs + NV * kAtom;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage0 + kStages * stage_bytes +
                                               2 * kStages * kRows * sizeof(float));
  uint64_t* qbar = bars + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int cq = lane & 3;                 // and its key pair in each 8 columns
  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int kvh = h / (H / Kv);
  const int q0 = blockIdx.x * kRows;
  const int z = NZ > 1 ? static_cast<int>(blockIdx.z) : 0;  // this block's columns

  // keys [k_begin, k_end) can be valid for some row of this block
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kRows, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int t_first = (k_begin / kRows) * kRows;
  const int n_tiles = k_end > t_first ? (k_end - t_first + kRows - 1) / kRows : 0;

  const auto load_stage = [=](int it) {
    const int st = it % kStages;
    load_tiles<ND, NV>(stage0 + st * stage_bytes, &bars[st], tm_k, tm_v, kvh,
                       t_first + it * kRows, b);
  };

  // this thread's rows' lse2 and di (padded: rows past Sq read +inf and 0)
  const long long at = (static_cast<long long>(b) * H + h) * Sq_pad + q0 + r0;
  const float l2[2] = {lse2[at], lse2[at + 8]};
  const float dd[2] = {di[at], di[at + 8]};

  float dQ[32 * CK];
#pragma unroll
  for (int i = 0; i < 32 * CK; ++i) dQ[i] = 0.f;

  if (n_tiles > 0) {
    if (tid == 0) {
      init_bars(bars, kStages + 1);
      load_tiles<ND, NV>(Qs, qbar, tm_q, tm_do, h, q0, b);  // dOs follows Qs
      for (int s = 0; s < min(n_tiles, kStages); ++s) load_stage(s);
    }
    __syncthreads();  // the barriers are initialised before anyone waits on them
    mbar_wait(qbar, 0);
    __syncwarp();

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint8_t* Ks = stage0 + st * stage_bytes;
      const uint8_t* Vs = Ks + ND * kAtom;
      const int t0 = t_first + it * kRows;
      mbar_wait(&bars[st], (it / kStages) & 1);
      __syncwarp();

      float S[32], dP[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] = dP[i] = 0.f;
      pin<32>(S);
      pin<32>(dP);
      wgmma_fence();
      product_ss<ND>(S, Qs, Ks);
      wgmma_commit();
      product_ss<NV>(dP, dOs, Vs);
      wgmma_commit();

      // P and dS, as in the dK/dV pass (rows are query rows here)
      const bool full = t0 + kRows <= Sk && (!causal || t0 + kRows - 1 <= q_first) &&
                        (window <= 0 || t0 > q_last - window);
      const auto ok = [&](int idx) {
        return full || key_valid(t0 + 8 * (idx >> 2) + 2 * cq + (idx & 1),
                                 q_first + r0 + 8 * ((idx >> 1) & 1), Sk, causal, window);
      };
      if (softcap > 0.f) {
        wgmma_wait_all();
        pin<32>(S);
        pin<32>(dP);
#pragma unroll
        for (int idx = 0; idx < 32; ++idx) {
          const int rr = (idx >> 1) & 1;
          p_and_ds_softcap(S[idx], dP[idx], l2[rr], dd[rr], scale, softcap, ok(idx));
        }
      } else {
        wgmma_wait<1>();
        pin<32>(S);
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          S[idx] = prob(S[idx], l2[(idx >> 1) & 1], scale, ok(idx));
        wgmma_wait_all();
        pin<32>(dP);
#pragma unroll
        for (int idx = 0; idx < 32; ++idx) dP[idx] = S[idx] * (dP[idx] - dd[(idx >> 1) & 1]);
      }

      // dQ += dS . K, dS as hi + lo
      uint32_t Dh[16], Dl[16];
      split_bf16(dP, Dh, Dl);
      pin<32 * CK>(dQ);
      pin<16>(Dh);
      pin<16>(Dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        rs_block<ND, CK>(dQ, Dh + 4 * kk, Ks, z, kk);
        rs_block<ND, CK>(dQ, Dl + 4 * kk, Ks, z, kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<32 * CK>(dQ);
      pin<16>(Dh);
      pin<16>(Dl);

      __syncthreads();  // every warp is done with this stage
      if (tid == 0 && it + kStages < n_tiles) load_stage(it + kStages);
      __syncwarp();
    }
  }

  store_rows<64 * CK>(dq + (static_cast<long long>(b) * Sq * H + h) * D + 64 * CK * z,
                      static_cast<long long>(H) * D, q0, Sq, D - 64 * CK * z, dQ, scale, r0, cq);
}

#define K10_DQ_PARAMS                                                                       \
  const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,       \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float *__restrict__ lse2, const float *__restrict__ di,                         \
      __nv_bfloat16 *__restrict__ dq, int Sq, int Sq_pad, int Sk, int H, int Kv, int D,     \
      float scale, int causal, int window, float softcap, int q_offset
#define K10_DQ_ARGS                                                                         \
  &tm_q, &tm_k, &tm_v, &tm_do, lse2, di, dq, Sq, Sq_pad, Sk, H, Kv, D, scale, causal, window, \
      softcap, q_offset

// dQ at ND <= 3: one column block.
template <int ND, int NV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_wgmma_kernel(K10_DQ_PARAMS) {
  dq_body<ND, NV, 1>(K10_DQ_ARGS);
}

// dQ at ND = 4: two column blocks.
template <int ND, int NV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_halves_kernel(K10_DQ_PARAMS) {
  dq_body<ND, NV, 2>(K10_DQ_ARGS);
}

#undef K10_DKDV_PARAMS
#undef K10_DKDV_ARGS
#undef K10_DQ_PARAMS
#undef K10_DQ_ARGS

// The dK/dV pass's kernel: from max(ND, NV) = FA_BWD_SPLIT_FROM_ND on, two
// warpgroups a block (the split kernel; the halves kernel, two column
// blocks, at max(ND, NV) = 4); only the one chosen is instantiated.
// tools/k10_bwd_split_ab.py builds this file again with the macro at 1: at
// ND <= 2 the split kernel gives the one-warpgroup kernel's bits and takes 3
// to 21 % longer (NVIDIA H100 80GB HBM3, 700 W: 20.97 against 20.43 us at
// qwen3-8b's head layout, 19.10 against 15.79 at zamba2-7b's), so it starts
// at 3. The dQ pass takes two column blocks at ND = 4.
#ifndef FA_BWD_SPLIT_FROM_ND
#define FA_BWD_SPLIT_FROM_ND 3
#endif
constexpr bool halves(int nd, int nv) { return (nd > nv ? nd : nv) == 4; }
template <int ND, int NV>
constexpr int kDkdvBlocks = halves(ND, NV) ? 2 : 1;
template <int ND, int NV>
constexpr bool kSplit = (ND > NV ? ND : NV) >= FA_BWD_SPLIT_FROM_ND;
template <int ND>
constexpr int kDqBlocks = ND == 4 ? 2 : 1;

template <int ND, int NV>
constexpr auto dkdv_kernel() {
  if constexpr (kDkdvBlocks<ND, NV> == 2)
    return fa_bwd_dkdv_halves_kernel<ND, NV>;
  else if constexpr (kSplit<ND, NV>)
    return fa_bwd_dkdv_split_kernel<ND, NV>;
  else
    return fa_bwd_dkdv_wgmma_kernel<ND, NV>;
}

template <int ND, int NV>
constexpr auto dq_kernel() {
  if constexpr (kDqBlocks<ND> == 2)
    return fa_bwd_dq_halves_kernel<ND, NV>;
  else
    return fa_bwd_dq_wgmma_kernel<ND, NV>;
}

template <int ND, int NV>
int launch_bwd_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                     const CUtensorMap& tdo, const void* o, const void* dout, const void* lse,
                     void* dq, void* dk, void* dv, void* scratch, int B, int Sq, int Sk, int H,
                     int Kv, int D, int Dv, float scale, int causal, int window, float softcap,
                     int q_offset, cudaStream_t s) {
  static bool ready_kv = false, ready_q = false;
  constexpr size_t smem = bwd_smem_bytes(ND, NV);
  constexpr bool two_wg = kSplit<ND, NV> || kDkdvBlocks<ND, NV> == 2;
  auto kdkdv = dkdv_kernel<ND, NV>();
  auto kdq = dq_kernel<ND, NV>();
  cudaError_t err = allow_smem(kdkdv, smem, &ready_kv);
  if (err == cudaSuccess) err = allow_smem(kdq, smem, &ready_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Sq_pad = (Sq + kRows - 1) / kRows * kRows;
  float* lse2 = static_cast<float*>(scratch);
  float* di = lse2 + static_cast<long long>(B) * H * Sq_pad;
  const long long rows = static_cast<long long>(B) * Sq_pad * H;
  constexpr int per_block = kPrepThreads / 8;
  fa_bwd_prep_kernel<<<static_cast<unsigned>((rows + per_block - 1) / per_block), kPrepThreads, 0,
                       s>>>(static_cast<const __nv_bfloat16*>(o),
                            static_cast<const __nv_bfloat16*>(dout),
                            static_cast<const float*>(lse), lse2, di, rows, Sq, Sq_pad, H, Dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkdv<<<dim3((Sk + kRows - 1) / kRows, B * Kv, kDkdvBlocks<ND, NV>),
          two_wg ? 2 * kThreads : kThreads, smem, s>>>(
      tq, tk, tv, tdo, lse2, di, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      Sq, Sq_pad, Sk, H, Kv, D, Dv, scale, causal, window, softcap, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdq<<<dim3((Sq + kRows - 1) / kRows, B * H, kDqBlocks<ND>), kThreads, smem, s>>>(
      tq, tk, tv, tdo, lse2, di, static_cast<__nv_bfloat16*>(dq), Sq, Sq_pad, Sk, H, Kv, D, scale,
      causal, window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Whether a launch at widths D, Dv takes the dK/dV pass's halves kernel (ND
// or NV = 4; the dQ pass's at ND = 4), the test its choice above makes: the
// wrapper counts those launches apart. At D <= 192 with Dv in (128, 192] it
// takes the split kernel at NV = 3 and the one-warpgroup dQ kernel.
extern "C" int flash_attention_bwd_wgmma_wide(int D, int Dv) {
  return halves((D + 63) / 64, (Dv + 63) / 64);
}

// K10's backward on tensor cores: bf16 q, k, v, o, dout, dq, dk and dv,
// contiguous, 16-byte aligned; lse (B, H, Sq) fp32 from the forward; D and
// Dv multiples of 16 up to 256; H a multiple of Kv; B * H at most 65,535.
// scratch: 2 B H ceil(Sq / 64) 64 fp32, 16-byte aligned (the padded lse2
// and di). Returns a cudaError_t as int (0 = success), or a negated
// CUresult if a tensor map could not be encoded.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* scratch, int B,
                                         int Sq, int Sk, int H, int Kv, int D, int Dv,
                                         float scale, int causal, int window, float softcap,
                                         int q_offset, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Kv <= 0 || H % Kv || D <= 0 || Dv <= 0 || D > 256 ||
      Dv > 256 || D % 16 || Dv % 16 || static_cast<long long>(B) * H > 65535 || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o) || misaligned(dout) || misaligned(dq) ||
      misaligned(dk) || misaligned(dv) || misaligned(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, B, Sq, H, D);
  if (err == 0) err = make_map(&tk, k, B, Sk, Kv, D);
  if (err == 0) err = make_map(&tv, v, B, Sk, Kv, Dv);
  if (err == 0) err = make_map(&tdo, dout, B, Sq, H, Dv);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launch) {
    return launch(tq, tk, tv, tdo, o, dout, lse, dq, dk, dv, scratch, B, Sq, Sk, H, Kv, D, Dv,
                  scale, causal, window, softcap, q_offset, s);
  };
  const int nd = (D + 63) / 64, nv = (Dv + 63) / 64;
#define K10_BWD(ND)                                                                          \
  if (nd == ND)                                                                              \
    return nv == 1   ? run(launch_bwd_wgmma<ND, 1>)                                          \
           : nv == 2 ? run(launch_bwd_wgmma<ND, 2>)                                          \
           : nv == 3 ? run(launch_bwd_wgmma<ND, 3>)                                          \
                     : run(launch_bwd_wgmma<ND, 4>);
  K10_BWD(1) K10_BWD(2) K10_BWD(3) K10_BWD(4)
#undef K10_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
