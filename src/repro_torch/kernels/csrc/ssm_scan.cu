// K13: the Mamba2 recurrence (scalar decay per head), forward and backward.
//
// Replaces no Pallas kernel: the reference runs it as a lax.scan of
// checkpointed 64-step chunks in mamba_forward (repro/models/ssm.py:102-127,
// its step :110-116, through repro/models/layers.py:155 chunked_scan) and as
// one jnp step in mamba_step (:147-166), both compiled by XLA. In the port
// that scan was a Python loop of several launches a step; this kernel runs a
// layer's recurrence in one launch, and the same launch at S = 1 is the
// decode step.
//
// Per (batch row b, head h), with the state h (P x N):
//     h_t = a_t h_{t-1} + (dt_t x_t) (x) B_t      y_t = h_t C_t
// in the reference's order of products; a_t = exp(dt_t A_h) is computed
// outside, and so is the D x_t skip. Inputs are fp32: x (B, S, H, P), dt
// and a (B, S, H), Bm and Cm (B, S, N), shared by the heads, h0 and h_T
// (B, H, P, N). The forward writes the state at the start of every `chunk`
// steps (the checkpoints, (B, H, n, P, N)) when asked; the backward walks
// each chunk back from its checkpoint.
//
// Forward (csrc/scan.cuh, FwdGeom<P, N, 4>): a line is a row p of h, since
// y_t[p] reads row p alone. A row's N columns lie over N/8 lanes, 8 a
// thread (two 16-byte pieces of the row, so the state, the checkpoints and
// h_T move as 16-byte loads and stores from registers, a warp's covering
// whole rows), and a thread holds 4 rows 8 apart: the 16 values of B and C
// it reads from shared memory a step serve all four. A block holds 32 rows:
// a (b, h) is P/32 blocks that share nothing (896 blocks of 64 threads at
// zamba2-7b's B·H = 448). x for the block's rows, B and C come a sub-chunk
// of 8 steps at a time as TMA boxes on mbarriers, 3 sub-chunks ahead (a
// call of at most 8 steps, the decode step, copies its rows with the
// state's loads instead); a and dt a chunk at a time, loaded into
// registers a chunk ahead. A step is, for each entry, a h + (dt x) B
// (ssm_update, the backward's replay's form) and h C into the row's sum;
// the sums wait for the sub-chunk's end, one reduce-scatter of its 8 steps
// over each row's lanes, then y through a shared tile as 16-byte stores
// after the sub-chunk's one barrier. No scratch, no atomics. Bound on the
// card: its operations (5 flops a state entry a step), 1.17 GFLOP at
// zamba2-7b's training shape; the design issues 3 fp32 instructions an
// entry a step (the product (dt x) B kept for the plain version's order)
// and about 22 shared-memory loads a warp a step, at 14 warps an SM (143
// registers a thread); the decode step is the state's read and write
// (14.7 MB).
//
// Backward (csrc/scan.cuh): one block per (b, h), N·P/8 threads,
// thread (column n, lane g of the column's P/8 lanes) holding h[p][n] and
// G[p][n] for 8 rows p. A chunk is replayed from its checkpoint in
// sub-chunks of 8 steps: a forward pass keeps the state at each sub-chunk's
// start in shared memory (the last one in registers), then each sub-chunk,
// last first, is replayed into registers (with the state after its last
// step) and walked back. No state leaves the chip. x, dy, B and C come a
// sub-chunk at a time as TMA boxes on mbarriers, two sub-chunks ahead; a
// and dt a chunk at a time. The column sums Gᵀ x, G ∘ h_{t-1} and
// dC = h_tᵀ dy are added over the column's lanes, s = G B over the warp's
// columns, by shuffle reduce-scatters; s's warp parts go through a shared
// tile, added over the warps in a fixed order after each sub-chunk (one barrier a
// sub-chunk), giving dx = dt s; dB = dt Gᵀ x, ddt = B·(Gᵀ x) and da are
// the column sums' sums over n. dB and dC per head are added over the
// heads in a fixed order by a second launch: no atomics, the same bits for the
// same inputs. Bound on the card: its operations (14 flops a state entry
// a step), 3.29 GFLOP at zamba2-7b's training shape against 53 MB. Its 448
// blocks of 512 threads take 210,080 B of shared memory each, one an SM:
// four rounds of the card's 132 SMs, the last 52 blocks long; each block
// waits, as K12's, on its steps' shuffle chains.

#include <type_traits>

#include "scan.cuh"  // geometry, the update, sums, slabs, the backward's sub-chunk order

namespace {

// The forward's geometry: FwdGeom<P, N, kSsmRows>, a line a row p of the
// state. Shared memory: the input slabs (x for the block's rows, B and C a
// sub-chunk), two sub-chunks' y tiles, two chunks' a and dt, the
// mbarriers.
constexpr int kSsmRows = 4;  // rows a thread: B and C from shared memory serve them all
template <int P, int N>
struct SsmFwd {
  using F = FwdGeom<P, N, kSsmRows>;
  static constexpr int LB = F::LB, T = F::T, LG = F::LG, YS = F::YS;
  static constexpr int kSlabFloats = kSub * (LB + 2 * N);  // x [kSub][LB]; B, C [kSub][N]
  static constexpr size_t smem_bytes() {
    return kSmemSlack + sizeof(float) * ((size_t)kFwdSlabs * kSlabFloats + 2 * kSub * YS +
                                         4 * kChunk) +
           sizeof(uint64_t) * kFwdSlabs;
  }
};

template <int P, int N>
__global__ void __launch_bounds__(SsmFwd<P, N>::T) ssm_scan_fwd_lanes_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_B,
    const __grid_constant__ CUtensorMap tm_C, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ a, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, float* __restrict__ ckpt, int S, int H) {
  using K = SsmFwd<P, N>;
  using F = typename K::F;
  constexpr int LB = K::LB, T = K::T, LG = K::LG, YS = K::YS, LPT = F::LPT, SL = F::SL;
  constexpr int kSubs = kChunk / kSub;
  using Sy = Scatter<LPT * kSub, 1, LG / 2>;  // a sub-chunk's y sums over each row's lanes
  static_assert(Sy::dup_mask == 0, "every lane keeps sums of its own");
  extern __shared__ unsigned char smem_raw[];
  float* slabs = smem_base(smem_raw);
  float* ytile = slabs + kFwdSlabs * K::kSlabFloats;  // [2][kSub][YS]
  float* sadt = ytile + 2 * kSub * YS;                // [2][2][kChunk]: a chunk's a, its dt
  uint64_t* full = reinterpret_cast<uint64_t*>(sadt + 4 * kChunk);

  const int tid = threadIdx.x, lane = tid & 31;
  // the thread's rows in the block: slot, slot + SL, ...
  const int g = lane % LG, slot = (tid >> 5) * F::LPW + lane / LG;
  const int bh = blockIdx.x / F::BLOCKS, p0 = (blockIdx.x % F::BLOCKS) * LB;
  const int b = bh / H, hd = bh % H;
  const int n_ck = (S + kChunk - 1) / kChunk, n_sub = (S + kSub - 1) / kSub;
  auto at_t = [&](int t) { return ((size_t)b * S + t) * H + hd; };  // (b, t, h): dt, a, y's row
  // row m of the thread's in a (P, N) state of this (b, h): h0, h_T, checkpoint c
  auto state_row = [&](int m) { return ((size_t)bh * P + p0 + slot + m * SL) * N; };
  auto ck_row = [&](int c, int m) {
    return (((size_t)bh * n_ck + c) * P + p0 + slot + m * SL) * N;
  };

  auto issue = [&](int it) {
    const int slab = it % kFwdSlabs, t0 = it * kSub;
    float* dst = slabs + slab * K::kSlabFloats;
    mbar_expect_tx(&full[slab], K::kSlabFloats * sizeof(float));
    tma_load_4d(dst, &tm_x, p0, hd, t0, b, &full[slab]);
    tma_load_4d(dst + kSub * LB, &tm_B, 0, 0, t0, b, &full[slab]);
    tma_load_4d(dst + kSub * (LB + N), &tm_C, 0, 0, t0, b, &full[slab]);
  };
  // a call of one sub-chunk (a decode step) copies its rows with the
  // threads, beside the state's loads: no tensor map to encode on the host,
  // no TMA round trip after the loads
  const bool direct = n_sub == 1;
  if (tid == 0) {  // the first sub-chunks' loads go out before anything else
    for (int s = 0; s < kFwdSlabs; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; !direct && it < kFwdSlabs - 1 && it < n_sub; ++it) issue(it);
  }
  // a and dt come a chunk at a time: each thread loads its share of the
  // next chunk's at a chunk's start and stores it before the chunk's last
  // barrier
  constexpr int kPre = (2 * kChunk + T - 1) / T;
  float pre[kPre];
  auto fetch = [&](int c) {
#pragma unroll
    for (int m = 0; m < kPre; ++m) {
      const int j = tid + m * T, t = c * kChunk + j % kChunk;
      pre[m] = j < 2 * kChunk && t < S ? (j < kChunk ? a : dt)[at_t(t)] : 0.f;
    }
  };
  auto stash = [&](int c) {
#pragma unroll
    for (int m = 0; m < kPre; ++m)
      if (tid + m * T < 2 * kChunk) sadt[(c & 1) * 2 * kChunk + tid + m * T] = pre[m];
  };
  // Every global load of the prologue goes out before its first store: a
  // decode step's rows (x for the block's rows, B, C), chunk 0's a and dt,
  // the state, which then go to the slab, sadt and the first checkpoint.
  constexpr int X4 = LB / 4, N4 = N / 4, R4 = X4 + 2 * N4;  // float4s of a step's row
  constexpr int kRowPieces = (kSub * R4 + T - 1) / T;
  auto row_piece = [&](int i, const float*& src, float*& dst) {
    const int l = i / R4, c4 = i % R4;
    if (c4 < X4) {
      src = x + at_t(l) * P + p0 + 4 * c4;
      dst = slabs + l * LB + 4 * c4;
    } else {
      const int bc = (c4 - X4) / N4;  // 0: B, 1: C
      src = (bc ? Cm : Bm) + ((size_t)b * S + l) * N + 4 * ((c4 - X4) % N4);
      dst = slabs + kSub * (LB + bc * N) + l * N + 4 * ((c4 - X4) % N4);
    }
  };
  float4 rowp[kRowPieces];
  if (direct) {
#pragma unroll
    for (int m = 0; m < kRowPieces; ++m) {
      const float* src;
      float* dst;
      if (tid + m * T < S * R4) {
        row_piece(tid + m * T, src, dst);
        rowp[m] = *reinterpret_cast<const float4*>(src);
      }
    }
  }
  fetch(0);

  float hs[LPT][kSpan];  // h[p][pos(g, e)] of the thread's rows p
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    if (h0) {
      load_span<LG>(hs[m], h0 + state_row(m), g);
    } else {
#pragma unroll
      for (int e = 0; e < kSpan; ++e) hs[m][e] = 0.f;
    }
  }
#pragma unroll
  for (int m = 0; m < LPT && ckpt; ++m) store_span<LG>(ckpt + ck_row(0, m), g, hs[m]);
  if (direct) {
#pragma unroll
    for (int m = 0; m < kRowPieces; ++m) {
      const float* src;
      float* dst;
      if (tid + m * T < S * R4) {
        row_piece(tid + m * T, src, dst);
        *reinterpret_cast<float4*>(dst) = rowp[m];
      }
    }
  }
  stash(0);
  fetch(1);
  __syncthreads();

  for (int it = 0; it < n_sub; ++it) {
    // slab (it - 1) % kFwdSlabs is free: every thread passed the last barrier
    if (tid == 0 && it + kFwdSlabs - 1 < n_sub) issue(it + kFwdSlabs - 1);
    const int c = it / kSubs, q = it % kSubs, t0 = it * kSub, n = min(kSub, S - t0);
    if (q == 0 && c > 0) fetch(c + 1);
    if (!direct) mbar_wait(&full[it % kFwdSlabs], (it / kFwdSlabs) & 1);
    const float* sx = slabs + (it % kFwdSlabs) * K::kSlabFloats;  // x [kSub][LB]
    const float* sB = sx + kSub * LB;                               // B [kSub][N]
    const float* sC = sB + kSub * N;                                // C
    const float* ca = sadt + (c & 1) * 2 * kChunk + q * kSub;
    const float* cdt = ca + kChunk;
    float* yt = ytile + (it & 1) * kSub * YS;
    float yp[LPT * kSub];  // y[p] of row m at step l over the thread's entries: [m][l]
    auto steps = [&](auto whole) {
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        if (decltype(whole)::value || l < n) {
          const float at = ca[l], dtl = cdt[l];
          float Bv[kSpan], Cv[kSpan];
          load_span<LG>(Bv, sB + l * N, g);
          load_span<LG>(Cv, sC + l * N, g);
#pragma unroll
          for (int m = 0; m < LPT; ++m) {
            const float dtx = dtl * sx[l * LB + slot + m * SL];
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < kSpan; ++e) {
              hs[m][e] = ssm_update(hs[m][e], at, dtx, Bv[e]);
              acc = fmaf(hs[m][e], Cv[e], acc);
            }
            yp[m * kSub + l] = acc;
          }
        } else {
#pragma unroll
          for (int m = 0; m < LPT; ++m) yp[m * kSub + l] = 0.f;
        }
      }
    };
    if (n == kSub)
      steps(std::true_type{});
    else
      steps(std::false_type{});
    bool writes;
    const int off = Sy::run(yp, lane, writes);
#pragma unroll
    for (int i = 0; i < Sy::kept; ++i)
      yt[((off + i) % kSub) * YS + slot + (off + i) / kSub * SL] = yp[i];
    if (q == kSubs - 1) {  // a chunk's end: the next one's checkpoint, a and dt
      if (ckpt && it + 1 < n_sub) {
#pragma unroll
        for (int m = 0; m < LPT; ++m)
          store_span<LG>(ckpt + ck_row(c + 1, m), g, hs[m]);
      }
      stash(c + 1);
    }
    __syncthreads();
    for (int i = tid; i < n * (LB / 4); i += T) {
      const int l = i / (LB / 4), c4 = i % (LB / 4);
      *reinterpret_cast<float4*>(y + at_t(t0 + l) * P + p0 + 4 * c4) =
          *reinterpret_cast<const float4*>(yt + l * YS + 4 * c4);
    }
  }
#pragma unroll
  for (int m = 0; m < LPT; ++m) store_span<LG>(hT + state_row(m), g, hs[m]);
}

// The backward's geometry: one block a (b, h), Geom<N, P>: thread (column
// n, lane g of the column) holds h[p][n] and G[p][n] for its kSpan rows p.
// Shared memory: the input slabs (x, dy, B, C a sub-chunk), the
// sub-checkpoints, two sub-chunks' partial tiles (s = G B a warp; the
// column sums Gᵀ x, da's part and dC), and a chunk's a and dt twice.
template <int P, int N>
struct SsmBwd {
  using Gm = Geom<N, P>;
  static constexpr int T = Gm::T, W = Gm::W, LG = Gm::LG;
  static constexpr int kSlabFloats = 2 * kSub * (P + N);  // x, dy [kSub][P]; B, C [kSub][N]
  static constexpr int kXTile = kSub * W * P;             // [kSub][W][P]: s a warp
  static constexpr int kLTile = kSub * 3 * N;             // [kSub][3][N]: Gᵀ x, da's part, dC
  static constexpr size_t smem_bytes() {
    return kSmemSlack + sizeof(float) * ((size_t)kSlabs * kSlabFloats +
                                         (size_t)kSubSlots * kSpan * T + 2 * kXTile +
                                         2 * kLTile + 4 * kChunk) +
           sizeof(uint64_t) * kSlabs;
  }
};

template <int P, int N>
__global__ void __launch_bounds__(SsmBwd<P, N>::T, 1) ssm_scan_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
    const __grid_constant__ CUtensorMap tm_B, const __grid_constant__ CUtensorMap tm_C,
    const float* __restrict__ dt, const float* __restrict__ a, const float* __restrict__ ckpt,
    const float* __restrict__ dhT, float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ da, float* __restrict__ dB_heads, float* __restrict__ dC_heads,
    float* __restrict__ dh0, int S, int H) {
  using K = SsmBwd<P, N>;
  using Gm = typename K::Gm;
  constexpr int T = K::T, W = K::W, LG = K::LG;
  using Sl = Scatter<4, 1, LG / 2>;   // Gᵀ x, da's part, dC (and a zero) over the column's lanes
  using Sx = Scatter<kSpan, LG, 16>;  // s over the warp's columns
  extern __shared__ unsigned char smem_raw[];
  float* slabs = smem_base(smem_raw);
  float4* subck = reinterpret_cast<float4*>(slabs + kSlabs * K::kSlabFloats);
  float* xtile = reinterpret_cast<float*>(subck + kSubSlots * 2 * T);
  float* ltile = xtile + 2 * K::kXTile;
  float* sa = ltile + 2 * K::kLTile;  // [2][kChunk]: a chunk's a, by the chunk's parity
  float* sdt = sa + 2 * kChunk;       // [2][kChunk]: its dt
  uint64_t* full = reinterpret_cast<uint64_t*>(sdt + 2 * kChunk);

  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;
  const int g = lane % LG, n = wid * Gm::LPW + lane / LG;
  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int n_ck = (S + kChunk - 1) / kChunk;
  auto at_t = [&](int t) { return ((size_t)b * S + t) * H + hd; };  // (b, t, h): dt, a, ddt, da

  if (tid == 0) {
    for (int s = 0; s < kSlabs; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float gs[kSpan];  // G[pos(g, e)][n], the cotangent of the state
#pragma unroll
  for (int e = 0; e < kSpan; ++e)
    gs[e] = dhT ? dhT[((size_t)bh * P + Gm::pos(g, e)) * N + n] : 0.f;

  Cursor cur{n_ck - 1, 0, 0};
  cur.start(S);
  int issued = 0;
  // a sub-chunk's boxes into a slab: x and B for the pass that writes the
  // sub-checkpoints, x, dy, B and C for the walk
  auto issue = [&](const Cursor& cu, int slab) {
    const int t0 = cu.c * kChunk + cu.q * kSub;
    constexpr uint32_t box_p = kSub * P * sizeof(float), box_n = kSub * N * sizeof(float);
    float* dst = slabs + slab * K::kSlabFloats;
    mbar_expect_tx(&full[slab], (cu.walk ? 2 : 1) * (box_p + box_n));
    tma_load_4d(dst, &tm_x, 0, hd, t0, b, &full[slab]);
    if (cu.walk) tma_load_4d(dst + kSub * P, &tm_dy, 0, hd, t0, b, &full[slab]);
    tma_load_4d(dst + 2 * kSub * P, &tm_B, 0, 0, t0, b, &full[slab]);
    if (cu.walk) tma_load_4d(dst + 2 * kSub * P + kSub * N, &tm_C, 0, 0, t0, b, &full[slab]);
  };

  int item = 0;  // sub-chunks consumed
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0), nq = (len + kSub - 1) / kSub;
    float* ca = sa + (c & 1) * kChunk;
    float* cdt = sdt + (c & 1) * kChunk;
    for (int j = tid; j < 2 * kChunk; j += T) {
      const int tt = j % kChunk;
      const float val = tt < len ? (j < kChunk ? a : dt)[at_t(t0 + tt)] : 0.f;
      (j < kChunk ? ca : cdt)[tt] = val;
    }
    __syncthreads();
    const float* ck = ckpt + ((size_t)bh * n_ck + c) * P * N + n;  // [p][n] at ck[p N]
    float run[kSpan];
#pragma unroll
    for (int e = 0; e < kSpan; ++e) run[e] = ck[(size_t)Gm::pos(g, e) * N];
    // forward over sub-chunks 0 .. nq - 2: the state at the start of each
    // later one into its slot, the last one's in run
    for (int q = 0; q + 1 < nq; ++q, ++item) {
      if (tid == 0) produce(cur, issued, item + kAhead, S, issue);
      wait_slab(full, item);
      const float* sl = slabs + (item % kSlabs) * K::kSlabFloats;
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        const float at = ca[q * kSub + l], dtl = cdt[q * kSub + l];
        const float Bn = sl[2 * kSub * P + l * N + n];
        float xv[kSpan];
        load_span<LG>(xv, sl + l * P, g);
#pragma unroll
        for (int e = 0; e < kSpan; ++e) run[e] = ssm_update(run[e], at, dtl * xv[e], Bn);
      }
      if (q + 2 < nq) store_slot<T>(subck + q * 2 * T, tid, run);
      __syncthreads();
    }

    // one sub-chunk walked back from the state at its start
    auto walk = [&](int q, const float(&st0)[kSpan]) {
      if (tid == 0) produce(cur, issued, item + kAhead, S, issue);
      const int tq = q * kSub, ns = min(kSub, len - tq), buf = item & 1;
      float* xt = xtile + buf * K::kXTile;
      float* lt = ltile + buf * K::kLTile;
      wait_slab(full, item);
      const float* sl = slabs + (item % kSlabs) * K::kSlabFloats;
      const float* sx = sl;                 // x [kSub][P]
      const float* sy = sl + kSub * P;      // dy
      const float* sB = sl + 2 * kSub * P;  // B [kSub][N]
      const float* sC = sB + kSub * N;      // C
      // replay: st[l] = h_{t-1} at t = t0 + tq + l, in registers, and hl the
      // state after the sub-chunk's last step
      float st[kSub][kSpan], hl[kSpan];
#pragma unroll
      for (int e = 0; e < kSpan; ++e) st[0][e] = st0[e];
      auto replay = [&](int l) {
        const float at = ca[tq + l], dtl = cdt[tq + l], Bn = sB[l * N + n];
        float xv[kSpan];
        load_span<LG>(xv, sx + l * P, g);
#pragma unroll
        for (int e = 0; e < kSpan; ++e) {
          const float hn = ssm_update(st[l][e], at, dtl * xv[e], Bn);
          if (l + 1 < kSub)
            st[l + 1][e] = hn;
          else
            hl[e] = hn;
        }
      };
      // one step of the walk: Gᵀ x, da's part and dC over the column's lanes
      // into lt, s = G B over the warp's columns into xt
      auto back = [&](int l) {
        const float at = ca[tq + l], Bn = sB[l * N + n], Cn = sC[l * N + n];
        float xv[kSpan], yy[kSpan];
        load_span<LG>(xv, sx + l * P, g);
        load_span<LG>(yy, sy + l * P, g);
        float ls[4] = {0.f, 0.f, 0.f, 0.f}, cr[kSpan];
#pragma unroll
        for (int e = 0; e < kSpan; ++e) {
          const float ht = l + 1 < kSub ? st[l + 1][e] : hl[e];
          ls[2] = fmaf(ht, yy[e], ls[2]);        // dC: h_tᵀ dy
          gs[e] = fmaf(yy[e], Cn, gs[e]);        // G += dy ⊗ C
          ls[0] = fmaf(gs[e], xv[e], ls[0]);     // Gᵀ x: dB = dt Gᵀ x, ddt = B·Gᵀ x
          ls[1] = fmaf(gs[e], st[l][e], ls[1]);  // da: G ∘ h_{t-1}
          cr[e] = gs[e] * Bn;                    // s: G B
          gs[e] *= at;                           // G <- a G
        }
        bool wl, wx;
        const int ol = Sl::run(ls, lane, wl);
        if (wl) {
#pragma unroll
          for (int m = 0; m < Sl::kept; ++m)
            if (ol + m < 3) lt[(l * 3 + ol + m) * N + n] = ls[m];
        }
        const int ox = Sx::run(cr, lane, wx);
        if (wx) {
#pragma unroll
          for (int m = 0; m < Sx::kept; ++m) xt[(l * W + wid) * P + Gm::pos(g, ox + m)] = cr[m];
        }
      };
#pragma unroll
      for (int l = 0; l < kSub; ++l)
        if (l < ns) replay(l);
#pragma unroll
      for (int l = kSub - 1; l >= 0; --l)
        if (l < ns) back(l);
      __syncthreads();
      // a (step, row) a thread: s over the warps in a fixed order, dx = dt s
      for (int j = tid; j < ns * P; j += T) {
        const int l = j / P, p = j % P;
        dx[at_t(t0 + tq + l) * P + p] = cdt[tq + l] * tree_sum<W>(xt + l * W * P + p, P);
      }
      // a (step, column) a thread: the head's dC and dB
      for (int j = tid; j < ns * N; j += T) {
        const int l = j / N, m = j % N;
        const size_t o = at_t(t0 + tq + l) * N + m;
        dB_heads[o] = cdt[tq + l] * lt[(l * 3) * N + m];
        dC_heads[o] = lt[(l * 3 + 2) * N + m];
      }
      // a warp a step, the last warps first (warp 0 issues the most boxes):
      // ddt = B·Gᵀ x and da over the columns (every lane of a warp reaches
      // the sums, so the shuffles need no divergence)
#pragma unroll
      for (int k = 0; k < (kSub + W - 1) / W; ++k) {
        const int l = W - 1 - wid + k * W;
        float dd = 0.f, dap = 0.f;
        if (l < ns) {
          for (int m = lane; m < N; m += 32) {
            dd = fmaf(sB[l * N + m], lt[(l * 3) * N + m], dd);
            dap += lt[(l * 3 + 1) * N + m];
          }
        }
        dd = warp_sum(dd);
        dap = warp_sum(dap);
        if (l < ns && lane == 0) {
          ddt[at_t(t0 + tq + l)] = dd;
          da[at_t(t0 + tq + l)] = dap;
        }
      }
      ++item;
    };

    walk(nq - 1, run);
    for (int q = nq - 2; q >= 0; --q) {
      float st0[kSpan];
      if (q == 0) {
#pragma unroll
        for (int e = 0; e < kSpan; ++e) st0[e] = ck[(size_t)Gm::pos(g, e) * N];
      } else {
        load_slot<T>(st0, subck + (q - 1) * 2 * T, tid);
      }
      walk(q, st0);
    }
  }
  if (dh0) {
#pragma unroll
    for (int e = 0; e < kSpan; ++e) dh0[((size_t)bh * P + Gm::pos(g, e)) * N + n] = gs[e];
  }
}

// dB, dC (B, S, N) = the per-head parts (B, S, H, N) added over the heads
// in a fixed order. One block a (b, t), kBcThreads threads: thread (k =
// its lane's low two bits, c = the rest) sums, as float4s, four columns
// of dB (c < N / 4) or dC of heads k, k + 4, k + 8, ...; the four head
// groups are then added over their lanes, (g0 + g1) + (g2 + g3) in every
// lane. Every lane reaches the shuffles.
constexpr int kBcThreads = 128;
__global__ void __launch_bounds__(kBcThreads) ssm_scan_bc_sum_kernel(
    const float* __restrict__ dB_heads, const float* __restrict__ dC_heads,
    float* __restrict__ dB, float* __restrict__ dC, int H, int N) {
  const size_t bt = blockIdx.x;
  const int k = threadIdx.x & 3, groups = N / 4;
  for (int c0 = 0; c0 < 2 * groups; c0 += kBcThreads / 4) {
    const int c = c0 + (threadIdx.x >> 2), q = c / groups, n0 = (c % groups) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < 2 * groups) {
      const float4* src = reinterpret_cast<const float4*>((q ? dC_heads : dB_heads) +
                                                          (bt * H * N + n0));
      for (int h = k; h < H; h += 4) {
        const float4 v = src[(size_t)h * groups];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, m);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, m);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, m);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, m);
    }
    if (c < 2 * groups && k == 0)
      *reinterpret_cast<float4*>((q ? dC : dB) + bt * N + n0) = s;
  }
}

template <int P, int N>
int launch_fwd(const float* x, const float* dt, const float* a, const float* Bm, const float* Cm,
               const float* h0, float* y, float* hT, float* ckpt, int B, int S, int H,
               cudaStream_t stream) {
  using K = SsmFwd<P, N>;
  CUtensorMap tm[3] = {};  // not read when S fits one sub-chunk
  int bad = 0;
  if (S > kSub) {
    bad = make_context_current();
    if (bad == 0) bad = make_step_map(&tm[0], x, B, S, H, P, K::LB);
    if (bad == 0) bad = make_step_map(&tm[1], Bm, B, S, 1, N);
    if (bad == 0) bad = make_step_map(&tm[2], Cm, B, S, 1, N);
  }
  if (bad != 0) return bad;
  static bool smem_set = false;
  cudaError_t err = allow_smem(ssm_scan_fwd_lanes_kernel<P, N>, K::smem_bytes(), &smem_set);
  if (err != cudaSuccess) return err;
  ssm_scan_fwd_lanes_kernel<P, N><<<B * H * K::F::BLOCKS, K::T, K::smem_bytes(), stream>>>(
      tm[0], tm[1], tm[2], x, dt, a, Bm, Cm, h0, y, hT, ckpt, S, H);
  return cudaGetLastError();
}

template <int P, int N>
int launch_bwd(const float* x, const float* dt, const float* a, const float* Bm, const float* Cm,
               const float* ckpt, const float* dy, const float* dhT, float* dx, float* ddt,
               float* da, float* dB_heads, float* dC_heads, float* dB, float* dC, float* dh0,
               int B, int S, int H, cudaStream_t stream) {
  using K = SsmBwd<P, N>;
  CUtensorMap tm[4];
  int bad = make_context_current();
  if (bad == 0) bad = make_step_map(&tm[0], x, B, S, H, P);
  if (bad == 0) bad = make_step_map(&tm[1], dy, B, S, H, P);
  if (bad == 0) bad = make_step_map(&tm[2], Bm, B, S, 1, N);
  if (bad == 0) bad = make_step_map(&tm[3], Cm, B, S, 1, N);
  if (bad != 0) return bad;
  static bool smem_set = false;
  cudaError_t err = allow_smem(ssm_scan_bwd_kernel<P, N>, K::smem_bytes(), &smem_set);
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<P, N><<<B * H, K::T, K::smem_bytes(), stream>>>(
      tm[0], tm[1], tm[2], tm[3], dt, a, ckpt, dhT, dx, ddt, da, dB_heads, dC_heads, dh0, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssm_scan_bc_sum_kernel<<<B * S, kBcThreads, 0, stream>>>(dB_heads, dC_heads, dB, dC, H, N);
  return cudaGetLastError();
}

template <int P, int N>
int bwd_info(int* out) {
  using K = SsmBwd<P, N>;
  return kernel_info(ssm_scan_bwd_kernel<P, N>, K::T, K::smem_bytes(), out);
}

template <int P, int N>
int fwd_info(int* out) {
  using K = SsmFwd<P, N>;
  out[5] = K::F::BLOCKS;
  return kernel_info(ssm_scan_fwd_lanes_kernel<P, N>, K::T, K::smem_bytes(), out);
}

// the instantiation of a launch or an info for P and N (16, 32 or 64)
template <int P, typename F>
int by_n(int N, F f) {
  switch (N) {
    case 16: return f(std::integral_constant<int, P>{}, std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, P>{}, std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, P>{}, std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
int by_widths(int P, int N, F f) {
  switch (P) {
    case 16: return by_n<16>(N, f);
    case 32: return by_n<32>(N, f);
    case 64: return by_n<64>(N, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One launch: y (B, S, H, P), h_T (B, H, P, N) and, when ckpt is not null,
// the checkpoints (B, H, ceil(S / chunk), P, N). h0 null is a zero state.
// P and N are 16, 32 or 64; chunk must be 64; x, B, C and h0 16-byte
// aligned.
int ssm_scan_fwd(const float* x, const float* dt, const float* a, const float* Bm,
                 const float* Cm, const float* h0, float* y, float* hT, float* ckpt, int B,
                 int S, int H, int P, int N, int chunk, cudaStream_t stream) {
  if (chunk != kChunk) return cudaErrorInvalidValue;
  return by_widths(P, N, [&](auto p, auto n) {
    return launch_fwd<decltype(p)::value, decltype(n)::value>(x, dt, a, Bm, Cm, h0, y, hT,
                                                                ckpt, B, S, H, stream);
  });
}

// Two launches: the recurrence backward (dx (B, S, H, P), ddt and da
// (B, S, H), the per-head dB and dC parts (B, S, H, N), dh0 when not
// null), then dB and dC (B, S, N). dhT null is a zero cotangent. P and N
// are 16, 32 or 64; chunk must be 64, x, dy, B and C 16-byte aligned.
int ssm_scan_bwd(const float* x, const float* dt, const float* a, const float* Bm,
                 const float* Cm, const float* ckpt, const float* dy, const float* dhT,
                 float* dx, float* ddt, float* da, float* dB_heads, float* dC_heads, float* dB,
                 float* dC, float* dh0, int B, int S, int H, int P, int N, int chunk,
                 cudaStream_t stream) {
  if (chunk != kChunk) return cudaErrorInvalidValue;
  return by_widths(P, N, [&](auto p, auto n) {
    return launch_bwd<decltype(p)::value, decltype(n)::value>(
        x, dt, a, Bm, Cm, ckpt, dy, dhT, dx, ddt, da, dB_heads, dC_heads, dB, dC, dh0, B, S, H,
        stream);
  });
}

// The backward kernel at widths P and N on the current card: out[0..4] =
// threads a block, dynamic shared bytes, registers a thread, blocks an SM,
// local (spilled) bytes a thread.
int ssm_scan_bwd_info(int P, int N, int* out) {
  return by_widths(P, N, [&](auto p, auto n) {
    return bwd_info<decltype(p)::value, decltype(n)::value>(out);
  });
}

// The forward kernel at widths P and N on the current card: out[0..5] =
// threads a block, dynamic shared bytes, registers a thread, blocks an SM,
// local (spilled) bytes a thread, blocks a (batch row, head).
int ssm_scan_fwd_info(int P, int N, int* out) {
  return by_widths(P, N, [&](auto p, auto n) {
    return fwd_info<decltype(p)::value, decltype(n)::value>(out);
  });
}

}  // extern "C"
