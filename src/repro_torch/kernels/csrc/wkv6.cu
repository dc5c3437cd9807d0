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
// Forward: one block per (b, h), P threads, thread j holding column j of S
// in registers, so y_t[j] is a sum over i in the thread, in the reference's
// order of products; r_t, k_t and w_t are staged in shared memory a step at
// a time (the next step's loads issued before the current step's
// arithmetic). Bound on the card: the bytes (each input read once, each
// output written once), a few MB a layer, against 5 P^2 flops a step per
// (b, h); at B·H = 128 blocks of 64 threads each step's latency (shared-
// memory round trips, two barriers) binds it instead.
//
// Backward (csrc/scan_bwd.cuh): one block per (b, h), P·P/8 threads, thread
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

#include "scan_bwd.cuh"  // the backward's geometry, sums, slabs and sub-chunk order

namespace {

template <int P>
__global__ void __launch_bounds__(P) wkv6_fwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ S0,
    float* __restrict__ y, float* __restrict__ ST, float* __restrict__ ckpt,
    int S, int H, int chunk) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const int n_ck = (S + chunk - 1) / chunk;
  __shared__ float sr[P], sk[P], sw[P], su[P];
  float s[P];
  su[j] = u[h * P + j];
#pragma unroll
  for (int i = 0; i < P; ++i) s[i] = S0 ? S0[((size_t)bh * P + i) * P + j] : 0.f;
  size_t off = ((size_t)b * S * H + h) * P + j;  // element j of (b, t = 0, h)
  const size_t step = (size_t)H * P;
  float nr = 0.f, nk = 0.f, nw = 0.f, nv = 0.f;
  if (S > 0) { nr = r[off]; nk = k[off]; nw = w[off]; nv = v[off]; }
  for (int t = 0; t < S; ++t, off += step) {
    if (ckpt && t % chunk == 0) {
      float* c = ckpt + ((size_t)bh * n_ck + t / chunk) * P * P + j;
#pragma unroll
      for (int i = 0; i < P; ++i) c[i * P] = s[i];
    }
    __syncthreads();  // the last step's reads of the staged vectors are done
    sr[j] = nr; sk[j] = nk; sw[j] = nw;
    const float vj = nv;
    __syncthreads();
    if (t + 1 < S) { nr = r[off + step]; nk = k[off + step]; nw = w[off + step]; nv = v[off + step]; }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float kv = sk[i] * vj;
      acc += sr[i] * (s[i] + su[i] * kv);
      s[i] = sw[i] * s[i] + kv;
    }
    y[off] = acc;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) ST[((size_t)bh * P + i) * P + j] = s[i];
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
        for (int e = 0; e < kSpan; ++e) run[e] = fmaf(wi, run[e], ki * vv[e]);
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
        for (int e = 0; e < kSpan; ++e) st[l + 1][e] = fmaf(wi, st[l][e], ki * vv[e]);
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
cudaError_t launch_fwd(const float* r, const float* k, const float* v, const float* w,
                       const float* u, const float* S0, float* y, float* ST, float* ckpt,
                       int B, int S, int H, int chunk, cudaStream_t stream) {
  wkv6_fwd_kernel<P><<<B * H, P, 0, stream>>>(r, k, v, w, u, S0, y, ST, ckpt, S, H, chunk);
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

// {threads, dynamic shared bytes, registers, blocks an SM, local bytes}
template <int P>
int bwd_info(int* out) {
  using K = Wkv6Bwd<P>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(wkv6_bwd_kernel<P>, K::smem_bytes(), &smem_set);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, wkv6_bwd_kernel<P>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_bwd_kernel<P>, K::T,
                                                        K::smem_bytes());
  if (err != cudaSuccess) return err;
  out[0] = K::T;
  out[1] = static_cast<int>(K::smem_bytes());
  out[2] = attr.numRegs;
  out[3] = blocks;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// One launch: y (B, S, H, P), S_T (B, H, P, P) and, when ckpt is not null,
// the checkpoints (B, H, ceil(S / chunk), P, P). S0 null is a zero state.
// P is 16, 32 or 64. Returns the cudaError of the launch.
int wkv6_fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* S0, float* y, float* ST, float* ckpt, int B, int S, int H, int P,
             int chunk, cudaStream_t stream) {
  switch (P) {
    case 16: return launch_fwd<16>(r, k, v, w, u, S0, y, ST, ckpt, B, S, H, chunk, stream);
    case 32: return launch_fwd<32>(r, k, v, w, u, S0, y, ST, ckpt, B, S, H, chunk, stream);
    case 64: return launch_fwd<64>(r, k, v, w, u, S0, y, ST, ckpt, B, S, H, chunk, stream);
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

}  // extern "C"
