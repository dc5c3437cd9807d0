// K12: the WKV-6 recurrence of RWKV-6 ("Finch"), forward and backward.
//
// Replaces no Pallas kernel: the reference runs the recurrence as a
// lax.scan of checkpointed 64-step chunks (repro/models/rwkv.py:111-145,
// its step :126-131, through repro/models/layers.py:155 chunked_scan),
// which XLA compiles to a loop on the device. In the port that scan was a
// Python loop of several launches a step, recorded step by step by
// autograd; this kernel runs a layer's whole recurrence in one launch.
//
// Per (batch row b, head h), with the state S (P x P, rows the key dim i,
// columns the value dim j):
//     y_t[j] = sum_i r_t[i] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//     S_t    = diag(w_t) S_{t-1} + k_t v_t^T
// The same launch serves training (S0 = 0), prefill and the one-token
// decode step. Inputs r, k, v, w are fp32 (B, S, H, P), u (H, P), S0 and
// S_T (B, H, P, P); the forward writes the state at the start of every
// `chunk` steps (the checkpoints, (B, H, n, P, P)) when asked, and the
// backward walks each chunk back from its checkpoint.
//
// Forward (csrc/scan.cuh, FwdGeom<P, P, 2>): a line is a column j of S,
// since y_t[j] reads column j alone. A column's P rows lie over P/8 lanes,
// 8 a thread, and a thread holds 2 columns 16 apart: the 24 values of r, k
// and w it reads from shared memory a step serve both. A block holds 32
// columns, so a (b, h) is P/32 blocks that share nothing (256 blocks of 128
// threads at rwkv6-1.6b's B·H = 128, P = 64). r, k, w and the block's v
// come a sub-chunk of 8 steps at a time as TMA boxes on mbarriers, 3
// sub-chunks ahead (a call of at most 8 steps, the decode step, copies its
// rows with the state's loads instead). A step is, for each entry, r (S +
// u k v) into the column's sum and w S + k v (wkv6_update, the backward's
// replay's form); the sums wait for the sub-chunk's end, one reduce-scatter
// of its 8 steps over each column's lanes, then y through a shared tile as
// 16-byte stores after the sub-chunk's one barrier. The state, the
// checkpoints (every 64 steps) and S_T cross device memory through a
// shared tile of the block's columns, as 16-byte pieces of rows. No
// scratch, no atomics. Bound on the card: its bytes (each input read once,
// each output written once), 23.1 MB at the training shape against 0.34
// GFLOP at 5 flops an entry a step; the design issues 4 fp32 instructions
// an entry a step and reads 26 floats a thread a step from shared memory
// (about one shared-memory cycle a float a warp): at 8 warps an SM the
// shared-memory reads bind it at the training shape, and at the decode
// step its fixed passes (the state through the tile each way, three
// barriers) cost more than the state's 4.2 MB.
//
// Backward (csrc/scan.cuh): one block per (b, h), P·P/8 threads, thread
// (row i, lane g of the row's P/8 lanes) holding S[i][j] and G[i][j] for 8
// columns j. A chunk is replayed from its checkpoint in sub-chunks of 8
// steps: a forward pass keeps the state at each sub-chunk's start in shared
// memory (the last one in registers), then each sub-chunk, last first, is
// replayed into registers and walked back. No state leaves the chip. The
// inputs come a sub-chunk at a time as TMA boxes on mbarriers, two
// sub-chunks ahead. The row sums dr' = S dy, dk' = G v, dw = G ∘ S and dy·v
// are added over the row's lanes, dv = (G + r u dyᵀ)ᵀ k over the warp's
// rows, by shuffle reduce-scatters; dv's warp parts go through a shared
// tile, added over the warps in a fixed order after each sub-chunk (one barrier a
// sub-chunk), with the terms u k (dy·v) and r u (dy·v) of dr and dk; du
// (r k (dy·v), summed in the lane that holds the row's dy·v) is added over
// b in order by a second launch. No atomics: the same bits for the same
// inputs. Bound on the card: its operations (14 fp32 flops a state entry a
// step, the replay included), about 0.94 GFLOP at rwkv6-1.6b's training
// shape against 40 MB. At one block an SM (221,600 B of shared memory, 16
// warps at 128 registers) the design issues about twice that work (the
// replay twice, the sums' shuffles) and waits on each step's chains of
// shuffles.

#include <type_traits>

#include "scan.cuh"  // geometry, the update, sums, slabs, the backward's sub-chunk order

namespace {

// The forward's geometry: FwdGeom<P, P, kWkv6Cols>, a line a column j of
// the state. Shared memory: the input slabs (r, k, w a sub-chunk, v for the
// block's columns), the block's columns of a state (rows i; its 16-byte
// pieces swizzled by row, so that a warp's scattered writes land in
// distinct banks), two sub-chunks' y tiles, the mbarriers.
constexpr int kWkv6Cols = 2;  // columns a thread: r, k, w from shared memory serve them all
template <int P>
struct Wkv6Fwd {
  using F = FwdGeom<P, P, kWkv6Cols>;
  static constexpr int LB = F::LB, T = F::T, LG = F::LG, YS = F::YS;
  static constexpr int kSlabFloats = kSub * (3 * P + LB);  // r, k, w [kSub][P]; v [kSub][LB]
  static constexpr size_t smem_bytes() {
    return kSmemSlack + sizeof(float) * ((size_t)kFwdSlabs * kSlabFloats + P * LB +
                                         2 * kSub * YS) +
           sizeof(uint64_t) * kFwdSlabs;
  }
  // the float of state entry (row i, block column jl) in the state tile
  __device__ static __forceinline__ int tile_at(int i, int jl) {
    const int swz = ((i >> 2) * (8 / LG)) & (LB / 4 - 1);
    return i * LB + 4 * ((jl >> 2) ^ swz) + (jl & 3);
  }
};

template <int P>
__global__ void __launch_bounds__(Wkv6Fwd<P>::T) wkv6_fwd_lanes_kernel(
    const __grid_constant__ CUtensorMap tm_r, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ w,
    const float* __restrict__ v, const float* __restrict__ u, const float* __restrict__ S0,
    float* __restrict__ y, float* __restrict__ ST, float* __restrict__ ckpt, int S, int H) {
  using K = Wkv6Fwd<P>;
  using F = typename K::F;
  using Gm = typename F::Gm;
  constexpr int LB = K::LB, T = K::T, LG = K::LG, YS = K::YS, LPT = F::LPT, SL = F::SL;
  constexpr int kSubs = kChunk / kSub;
  using Sy = Scatter<LPT * kSub, 1, LG / 2>;  // a sub-chunk's y sums over each column's lanes
  static_assert(Sy::dup_mask == 0, "every lane keeps sums of its own");
  extern __shared__ unsigned char smem_raw[];
  float* slabs = smem_base(smem_raw);
  float* stile = slabs + kFwdSlabs * K::kSlabFloats;  // [P][LB], swizzled: tile_at
  float* ytile = stile + P * LB;                      // [2][kSub][YS]
  uint64_t* full = reinterpret_cast<uint64_t*>(ytile + 2 * kSub * YS);

  const int tid = threadIdx.x, lane = tid & 31;
  // the thread's columns in the block: slot, slot + SL, ...
  const int g = lane % LG, slot = (tid >> 5) * F::LPW + lane / LG;
  const int bh = blockIdx.x / F::BLOCKS, j0 = (blockIdx.x % F::BLOCKS) * LB;
  const int b = bh / H, h = bh % H;
  const int n_ck = (S + kChunk - 1) / kChunk, n_sub = (S + kSub - 1) / kSub;
  auto row = [&](int t) { return (((size_t)b * S + t) * H + h) * P; };  // (b, t, h)
  // the thread's entries into the tile
  auto to_tile = [&](const float(&s)[LPT][kSpan]) {
#pragma unroll
    for (int m = 0; m < LPT; ++m)
#pragma unroll
      for (int e = 0; e < kSpan; ++e) stile[K::tile_at(Gm::pos(g, e), slot + m * SL)] = s[m][e];
  };
  // the tile -> the block's columns of a (P, P) state in device memory, as
  // float4s along the rows
  auto tile_out = [&](float* dst) {
#pragma unroll
    for (int x = tid; x < P * LB / 4; x += T) {
      const int i = x / (LB / 4), c4 = x % (LB / 4);
      *reinterpret_cast<float4*>(dst + (size_t)i * P + j0 + 4 * c4) =
          *reinterpret_cast<const float4*>(stile + K::tile_at(i, 4 * c4));
    }
  };

  auto issue = [&](int it) {
    const int slab = it % kFwdSlabs, t0 = it * kSub;
    float* dst = slabs + slab * K::kSlabFloats;
    mbar_expect_tx(&full[slab], K::kSlabFloats * sizeof(float));
    tma_load_4d(dst, &tm_r, 0, h, t0, b, &full[slab]);
    tma_load_4d(dst + kSub * P, &tm_k, 0, h, t0, b, &full[slab]);
    tma_load_4d(dst + 2 * kSub * P, &tm_w, 0, h, t0, b, &full[slab]);
    tma_load_4d(dst + 3 * kSub * P, &tm_v, j0, h, t0, b, &full[slab]);
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
  // Every global load of the prologue goes out before its first store: a
  // decode step's rows, u, the block's columns of S0 (zeros without one),
  // which then go to the slab, the tile and the first checkpoint.
  constexpr int P4 = P / 4, R4 = 3 * P4 + LB / 4;  // float4s of a step's row: r, k, w, v
  constexpr int kRowPieces = (kSub * R4 + T - 1) / T, kPieces = P * LB / 4 / T;
  auto row_piece = [&](int i, const float*& src, float*& dst) {
    const int l = i / R4, c4 = i % R4, a = c4 / P4;  // a: r, k, w, then v
    src = (a == 0 ? r : a == 1 ? k : a == 2 ? w : v) + row(l) +
          (a < 3 ? 4 * (c4 % P4) : j0 + 4 * (c4 - 3 * P4));
    dst = slabs + (a < 3 ? (a * kSub + l) * P + 4 * (c4 % P4)
                         : 3 * kSub * P + l * LB + 4 * (c4 - 3 * P4));
  };
  auto s0_at = [&](int m, int& i, int& c4) {  // piece m of a thread: row i, float4 c4
    const int x = tid + m * T;
    i = x / (LB / 4);
    c4 = x % (LB / 4);
  };
  float4 rowp[kRowPieces], piece[kPieces];
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
  float uu[kSpan], s[LPT][kSpan];  // u[pos(g, e)]; S[pos(g, e)][j0 + slot + m SL]
  load_span<LG>(uu, u + (size_t)h * P, g);
#pragma unroll
  for (int m = 0; m < kPieces; ++m) {
    int i, c4;
    s0_at(m, i, c4);
    piece[m] = S0 ? *reinterpret_cast<const float4*>(S0 + ((size_t)bh * P + i) * P + j0 + 4 * c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
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
  float* ck0 = ckpt ? ckpt + (size_t)bh * n_ck * P * P : nullptr;
#pragma unroll
  for (int m = 0; m < kPieces; ++m) {
    int i, c4;
    s0_at(m, i, c4);
    if (S0) *reinterpret_cast<float4*>(stile + K::tile_at(i, 4 * c4)) = piece[m];
    if (ck0) *reinterpret_cast<float4*>(ck0 + (size_t)i * P + j0 + 4 * c4) = piece[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < LPT; ++m)
#pragma unroll
    for (int e = 0; e < kSpan; ++e)
      s[m][e] = S0 ? stile[K::tile_at(Gm::pos(g, e), slot + m * SL)] : 0.f;

  for (int it = 0; it < n_sub; ++it) {
    // slab (it - 1) % kFwdSlabs is free: every thread passed the last barrier
    if (tid == 0 && it + kFwdSlabs - 1 < n_sub) issue(it + kFwdSlabs - 1);
    const int c = it / kSubs, q = it % kSubs, t0 = it * kSub, n = min(kSub, S - t0);
    if (!direct) mbar_wait(&full[it % kFwdSlabs], (it / kFwdSlabs) & 1);
    const float* sr = slabs + (it % kFwdSlabs) * K::kSlabFloats;  // r [kSub][P]
    const float* sk = sr + kSub * P;                                // k
    const float* sw = sk + kSub * P;                                // w
    const float* sv = sw + kSub * P;                                // v [kSub][LB]
    float* yt = ytile + (it & 1) * kSub * YS;
    float yp[LPT * kSub];  // y[j] of column m at step l over the thread's rows: [m][l]
    auto steps = [&](auto whole) {
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        if (decltype(whole)::value || l < n) {
          float rv[kSpan], kv[kSpan], wv[kSpan];
          load_span<LG>(rv, sr + l * P, g);
          load_span<LG>(kv, sk + l * P, g);
          load_span<LG>(wv, sw + l * P, g);
#pragma unroll
          for (int m = 0; m < LPT; ++m) {
            const float vj = sv[l * LB + slot + m * SL];
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < kSpan; ++e) {
              const float kvj = kv[e] * vj;
              acc = fmaf(rv[e], fmaf(uu[e], kvj, s[m][e]), acc);  // r (S + u k v)
              s[m][e] = wkv6_update(s[m][e], wv[e], kvj);
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
    // a chunk's end: the next one's checkpoint through the tile
    const bool ck_next = ckpt && q == kSubs - 1 && it + 1 < n_sub;
    if (ck_next) to_tile(s);
    __syncthreads();
    for (int x = tid; x < n * (LB / 4); x += T) {
      const int l = x / (LB / 4), c4 = x % (LB / 4);
      *reinterpret_cast<float4*>(y + row(t0 + l) + j0 + 4 * c4) =
          *reinterpret_cast<const float4*>(yt + l * YS + 4 * c4);
    }
    if (ck_next) tile_out(ck0 + (size_t)(c + 1) * P * P);
  }
  // the tile's last reads were before the last barrier
  to_tile(s);
  __syncthreads();
  tile_out(ST + (size_t)bh * P * P);
}

// The backward's geometry: one block a (b, h), Geom<P, P>: thread (row i,
// lane g of the row) holds S[i][j] and G[i][j] for its kSpan columns j.
// Shared memory: the input slabs (r, k, w, v, dy a sub-chunk), the
// sub-checkpoints, two sub-chunks' partial tiles (dv's per warp; the row
// sums dr', dk', dw and each step's dy·v) and u.
template <int P>
struct Wkv6Bwd {
  using Gm = Geom<P, P>;
  static constexpr int T = Gm::T, W = Gm::W, LG = Gm::LG;
  static constexpr int kSlabFloats = 5 * kSub * P;  // r, k, w, v, dy: [5][kSub][P]
  static constexpr int kXTile = kSub * W * P;       // [kSub][W][P]: dv a warp
  static constexpr int kLTile = kSub * 4 * P;       // [kSub][4][P]: dr', dk', dw, dy·v
  static constexpr size_t smem_bytes() {
    return kSmemSlack + sizeof(float) * ((size_t)kSlabs * kSlabFloats +
                                         (size_t)kSubSlots * kSpan * T + 2 * kXTile +
                                         2 * kLTile + P) +
           sizeof(uint64_t) * kSlabs;
  }
};

template <int P>
__global__ void __launch_bounds__(Wkv6Bwd<P>::T, 1) wkv6_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_r, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_dy, const float* __restrict__ u,
    const float* __restrict__ ckpt, const float* __restrict__ dST, float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du_rows, float* __restrict__ dS0, int S, int H) {
  using K = Wkv6Bwd<P>;
  using Gm = typename K::Gm;
  constexpr int T = K::T, W = K::W, LG = K::LG;
  using Sl = Scatter<4, 1, LG / 2>;  // a row's dr', dk', dw, dy·v over its lanes
  using Sx = Scatter<kSpan, LG, 16>;  // dv over the warp's rows
  extern __shared__ unsigned char smem_raw[];
  float* slabs = smem_base(smem_raw);
  float4* subck = reinterpret_cast<float4*>(slabs + kSlabs * K::kSlabFloats);
  float* xtile = reinterpret_cast<float*>(subck + kSubSlots * 2 * T);
  float* ltile = xtile + 2 * K::kXTile;
  float* su = ltile + 2 * K::kLTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(su + P);

  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;
  const int g = lane % LG, i = wid * Gm::LPW + lane / LG;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_ck = (S + kChunk - 1) / kChunk;
  auto row = [&](int t) { return (((size_t)b * S + t) * H + h) * P; };  // (b, t, h)

  if (tid == 0) {
    for (int s = 0; s < kSlabs; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int x = tid; x < P; x += T) su[x] = u[h * P + x];
  const float ui = u[h * P + i];
  __syncthreads();

  float gs[kSpan];  // G[i][pos(g, e)], the cotangent of the state
  if (dST) {
    load_span<LG>(gs, dST + ((size_t)bh * P + i) * P, g);
  } else {
#pragma unroll
    for (int e = 0; e < kSpan; ++e) gs[e] = 0.f;
  }
  // du's sum for row i, in the lane that ends each step with the row's dy·v
  const bool holds_dyv = Sl::offset(lane) == 4 - Sl::kept && (lane & Sl::dup_mask) == 0;
  float du_acc = 0.f;

  Cursor cur{n_ck - 1, 0, 0};
  cur.start(S);
  int issued = 0;
  // a sub-chunk's boxes into a slab: k, w, v for the pass that writes the
  // sub-checkpoints, all five for the walk
  auto issue = [&](const Cursor& cu, int slab) {
    const int t0 = cu.c * kChunk + cu.q * kSub;
    constexpr uint32_t box = kSub * P * sizeof(float);
    float* dst = slabs + slab * K::kSlabFloats;
    mbar_expect_tx(&full[slab], (cu.walk ? 5 : 3) * box);
    if (cu.walk) tma_load_4d(dst, &tm_r, 0, h, t0, b, &full[slab]);
    tma_load_4d(dst + 1 * kSub * P, &tm_k, 0, h, t0, b, &full[slab]);
    tma_load_4d(dst + 2 * kSub * P, &tm_w, 0, h, t0, b, &full[slab]);
    tma_load_4d(dst + 3 * kSub * P, &tm_v, 0, h, t0, b, &full[slab]);
    if (cu.walk) tma_load_4d(dst + 4 * kSub * P, &tm_dy, 0, h, t0, b, &full[slab]);
  };

  int item = 0;  // sub-chunks consumed
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0), nq = (len + kSub - 1) / kSub;
    const float* ck = ckpt + (((size_t)bh * n_ck + c) * P + i) * P;
    float run[kSpan];
    load_span<LG>(run, ck, g);
    // forward over sub-chunks 0 .. nq - 2: the state at the start of each
    // later one into its slot, the last one's in run
    for (int q = 0; q + 1 < nq; ++q, ++item) {
      if (tid == 0) produce(cur, issued, item + kAhead, S, issue);
      wait_slab(full, item);
      const float* sl = slabs + (item % kSlabs) * K::kSlabFloats;
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        const float ki = sl[(1 * kSub + l) * P + i], wi = sl[(2 * kSub + l) * P + i];
        float vv[kSpan];
        load_span<LG>(vv, sl + (3 * kSub + l) * P, g);
#pragma unroll
        for (int e = 0; e < kSpan; ++e) run[e] = wkv6_update(run[e], wi, ki * vv[e]);
      }
      if (q + 2 < nq) store_slot<T>(subck + q * 2 * T, tid, run);
      __syncthreads();
    }

    // one sub-chunk walked back from the state at its start
    auto walk = [&](int q, const float(&st0)[kSpan]) {
      if (tid == 0) produce(cur, issued, item + kAhead, S, issue);
      const int tb = t0 + q * kSub, n = min(kSub, len - q * kSub), buf = item & 1;
      float* xt = xtile + buf * K::kXTile;
      float* lt = ltile + buf * K::kLTile;
      wait_slab(full, item);
      const float* sl = slabs + (item % kSlabs) * K::kSlabFloats;
      auto in = [&](int a, int l) { return sl + (a * kSub + l) * P; };  // r k w v dy
      // replay: st[l] = S_{tb + l - 1}, in registers
      float st[kSub][kSpan];
#pragma unroll
      for (int e = 0; e < kSpan; ++e) st[0][e] = st0[e];
      auto replay = [&](int l) {
        const float ki = in(1, l)[i], wi = in(2, l)[i];
        float vv[kSpan];
        load_span<LG>(vv, in(3, l), g);
#pragma unroll
        for (int e = 0; e < kSpan; ++e) st[l + 1][e] = wkv6_update(st[l][e], wi, ki * vv[e]);
      };
      // one step of the walk: the row sums over the row's lanes into lt, dv
      // over the warp's rows into xt
      auto back = [&](int l) {
        const float ri = in(0, l)[i], ki = in(1, l)[i], wi = in(2, l)[i], rui = ri * ui;
        float vv[kSpan], yy[kSpan];
        load_span<LG>(vv, in(3, l), g);
        load_span<LG>(yy, in(4, l), g);
        float ls[4] = {0.f, 0.f, 0.f, 0.f}, xs[kSpan];
#pragma unroll
        for (int e = 0; e < kSpan; ++e) {
          const float s = st[l][e];
          ls[0] = fmaf(s, yy[e], ls[0]);          // dr': S_{t-1} dy
          ls[1] = fmaf(gs[e], vv[e], ls[1]);      // dk': G v
          ls[2] = fmaf(gs[e], s, ls[2]);          // dw: G ∘ S_{t-1}
          ls[3] = fmaf(yy[e], vv[e], ls[3]);      // dy·v
          xs[e] = fmaf(rui, yy[e], gs[e]) * ki;   // dv: (G + r u dyᵀ)ᵀ k
          gs[e] = fmaf(wi, gs[e], ri * yy[e]);    // G <- diag(w) G + r dyᵀ
        }
        bool wl, wx;
        const int ol = Sl::run(ls, lane, wl);
        if (wl) {
#pragma unroll
          for (int m = 0; m < Sl::kept; ++m) lt[(l * 4 + ol + m) * P + i] = ls[m];
        }
        if (holds_dyv) du_acc = fmaf(ri * ki, ls[Sl::kept - 1], du_acc);  // du += r k (dy·v)
        const int ox = Sx::run(xs, lane, wx);
        if (wx) {
#pragma unroll
          for (int m = 0; m < Sx::kept; ++m) xt[(l * W + wid) * P + Gm::pos(g, ox + m)] = xs[m];
        }
      };
#pragma unroll
      for (int l = 0; l + 1 < kSub; ++l)
        if (l + 1 < n) replay(l);
#pragma unroll
      for (int l = kSub - 1; l >= 0; --l)
        if (l < n) back(l);
      __syncthreads();
      // a (step, column) a thread: dv over the warps in a fixed order; dr, dk, dw of
      // row col with the terms in dy·v (row 0's copy)
      for (int x = tid; x < n * P; x += T) {
        const int l = x / P, col = x % P;
        const size_t o = row(tb + l) + col;
        const float dyv = lt[(l * 4 + 3) * P];
        dv[o] = tree_sum<W>(xt + l * W * P + col, P);
        dr[o] = fmaf(su[col] * in(1, l)[col], dyv, lt[(l * 4) * P + col]);
        dk[o] = fmaf(in(0, l)[col] * su[col], dyv, lt[(l * 4 + 1) * P + col]);
        dw[o] = lt[(l * 4 + 2) * P + col];
      }
      ++item;
    };

    walk(nq - 1, run);
    for (int q = nq - 2; q >= 0; --q) {
      float st0[kSpan];
      if (q == 0)
        load_span<LG>(st0, ck, g);
      else
        load_slot<T>(st0, subck + (q - 1) * 2 * T, tid);
      walk(q, st0);
    }
  }
  if (dS0) {
    float* o = dS0 + ((size_t)bh * P + i) * P;
    *reinterpret_cast<float4*>(o + 4 * g) = make_float4(gs[0], gs[1], gs[2], gs[3]);
    *reinterpret_cast<float4*>(o + 4 * LG + 4 * g) = make_float4(gs[4], gs[5], gs[6], gs[7]);
  }
  if (holds_dyv) du_rows[(size_t)bh * P + i] = du_acc;
}

// du (H, P) = the per-(b, h) sums added over b = 0, 1, ... in order
__global__ void wkv6_du_sum_kernel(const float* __restrict__ du_rows, float* __restrict__ du,
                                   int B, int H, int P) {
  const int h = blockIdx.x, i = threadIdx.x;
  float acc = du_rows[(size_t)h * P + i];
  for (int b = 1; b < B; ++b) acc += du_rows[((size_t)b * H + h) * P + i];
  du[(size_t)h * P + i] = acc;
}

template <int P>
int launch_fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
               const float* S0, float* y, float* ST, float* ckpt, int B, int S, int H,
               cudaStream_t stream) {
  using K = Wkv6Fwd<P>;
  CUtensorMap tm[4] = {};  // not read when S fits one sub-chunk
  const float* src[4] = {r, k, w, v};
  int bad = S > kSub ? make_context_current() : 0;
  for (int a = 0; S > kSub && a < 4 && bad == 0; ++a)
    bad = make_step_map(&tm[a], src[a], B, S, H, P, a == 3 ? K::LB : P);
  if (bad != 0) return bad;
  static bool smem_set = false;
  cudaError_t err = allow_smem(wkv6_fwd_lanes_kernel<P>, K::smem_bytes(), &smem_set);
  if (err != cudaSuccess) return err;
  wkv6_fwd_lanes_kernel<P><<<B * H * K::F::BLOCKS, K::T, K::smem_bytes(), stream>>>(
      tm[0], tm[1], tm[2], tm[3], r, k, w, v, u, S0, y, ST, ckpt, S, H);
  return cudaGetLastError();
}

template <int P>
int launch_bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
               const float* ckpt, const float* dy, const float* dST, float* dr, float* dk,
               float* dv, float* dw, float* du_rows, float* du, float* dS0, int B, int S, int H,
               cudaStream_t stream) {
  using K = Wkv6Bwd<P>;
  CUtensorMap tm[5];
  const float* src[5] = {r, k, w, v, dy};
  int bad = make_context_current();
  for (int a = 0; a < 5 && bad == 0; ++a) bad = make_step_map(&tm[a], src[a], B, S, H, P);
  if (bad != 0) return bad;
  static bool smem_set = false;
  cudaError_t err = allow_smem(wkv6_bwd_kernel<P>, K::smem_bytes(), &smem_set);
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<P><<<B * H, K::T, K::smem_bytes(), stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], u, ckpt, dST, dr, dk, dv, dw, du_rows, dS0, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_du_sum_kernel<<<H, P, 0, stream>>>(du_rows, du, B, H, P);
  return cudaGetLastError();
}

template <int P>
int bwd_info(int* out) {
  using K = Wkv6Bwd<P>;
  return kernel_info(wkv6_bwd_kernel<P>, K::T, K::smem_bytes(), out);
}

template <int P>
int fwd_info(int* out) {
  using K = Wkv6Fwd<P>;
  out[5] = K::F::BLOCKS;
  return kernel_info(wkv6_fwd_lanes_kernel<P>, K::T, K::smem_bytes(), out);
}

}  // namespace

extern "C" {

// One launch: y (B, S, H, P), S_T (B, H, P, P) and, when ckpt is not null,
// the checkpoints (B, H, ceil(S / chunk), P, P). S0 null is a zero state.
// P is 16, 32 or 64; chunk must be 64; r, k, v, w, u and S0 16-byte
// aligned. Returns the cudaError of the launch, or the negated CUresult of
// a tensor map's encoding.
int wkv6_fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* S0, float* y, float* ST, float* ckpt, int B, int S, int H, int P,
             int chunk, cudaStream_t stream) {
  if (chunk != kChunk) return cudaErrorInvalidValue;
  switch (P) {
    case 16: return launch_fwd<16>(r, k, v, w, u, S0, y, ST, ckpt, B, S, H, stream);
    case 32: return launch_fwd<32>(r, k, v, w, u, S0, y, ST, ckpt, B, S, H, stream);
    case 64: return launch_fwd<64>(r, k, v, w, u, S0, y, ST, ckpt, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Two launches: the recurrence backward (dr, dk, dv, dw (B, S, H, P), the
// per-(b, h) du sums du_rows (B, H, P), dS0 (B, H, P, P) when not null),
// then du (H, P). dST null is a zero cotangent. chunk must be 64, the
// inputs 16-byte aligned.
int wkv6_bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* ckpt, const float* dy, const float* dST, float* dr, float* dk,
             float* dv, float* dw, float* du_rows, float* du, float* dS0, int B, int S, int H,
             int P, int chunk, cudaStream_t stream) {
  if (chunk != kChunk) return cudaErrorInvalidValue;
  switch (P) {
    case 16: return launch_bwd<16>(r, k, v, w, u, ckpt, dy, dST, dr, dk, dv, dw, du_rows, du,
                                   dS0, B, S, H, stream);
    case 32: return launch_bwd<32>(r, k, v, w, u, ckpt, dy, dST, dr, dk, dv, dw, du_rows, du,
                                   dS0, B, S, H, stream);
    case 64: return launch_bwd<64>(r, k, v, w, u, ckpt, dy, dST, dr, dk, dv, dw, du_rows, du,
                                   dS0, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The backward kernel at head size P on the current card: out[0..4] =
// threads a block, dynamic shared bytes, registers a thread, blocks an SM,
// local (spilled) bytes a thread.
int wkv6_bwd_info(int P, int* out) {
  switch (P) {
    case 16: return bwd_info<16>(out);
    case 32: return bwd_info<32>(out);
    case 64: return bwd_info<64>(out);
    default: return cudaErrorInvalidValue;
  }
}

// The forward kernel at head size P on the current card: out[0..5] =
// threads a block, dynamic shared bytes, registers a thread, blocks an SM,
// local (spilled) bytes a thread, blocks a (batch row, head).
int wkv6_fwd_info(int P, int* out) {
  switch (P) {
    case 16: return fwd_info<16>(out);
    case 32: return fwd_info<32>(out);
    case 64: return fwd_info<64>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
