// Full-sequence LSTM recurrence kernels (K2) for Hopper: the forward
// scan, the backward recurrence and the w_hh gradient product.
//
// Replaces the Pallas TPU kernels src/repro/kernels/lstm_gates.py:202
// lstm_scan_fused (_scan_kernel, :178) and :295 lstm_scan_bwd_fused
// (_scan_bwd_kernel, :235). Time-major, as there:
//
//   xg (S, B, 4H) = x @ w_ih + b, gate order [i | f | g | o], +1 on the
//   forget gate; w_hh (H, 4H) fp32; h0, c0 (B, H) fp32.
//   forward : gates_t = xg_t + h_{t-1} @ w_hh (fp32, w_hh not cast),
//             c_t = f c_{t-1} + i g, h_t = o tanh(c_t); the h carry stays
//             fp32 -> ys (S, B, H) in xg's dtype, cs (S, B, H) fp32.
//   backward: t = S-1..0 with h_prev = the stored ys[t-1] (h0 at t = 0),
//             the gates recomputed -> dxg (S, B, 4H), dh0, dc0 fp32;
//             then dw_hh = sum over (t, b) of h_prev^T dgates, fp32.
//
// Bound on an H100 SXM: the operations. At the paper's encoder layer
// (S = 64, B = 4, H = 1152) the forward's recurrent products are
// 2·S·B·H·4H = 2.72 GFLOP, 40.6 us at the 67 TFLOP/s fp32 rate, while its
// bytes (21.2 MB of w_hh read once, about 4 MB of sequences) take 7.6 us
// at 3.35 TB/s. The backward recurrence does twice the forward's
// products (the gates recomputed, and dh = dgates @ w_hh^T), the dw
// product once. The products are fp32 FMA on the CUDA cores: TF32 or
// bf16 tensor cores would change the numbers.
//
// Design. The TPU kernel walks a grid of S steps in order on one core,
// with w_hh resident in VMEM and the carry in scratch. Here a step needs
// the whole card, and blocks run in parallel:
//
// - One cooperative launch runs all S steps. Block j owns U consecutive
//   hidden units with all four gates of each, so the cell update needs
//   no exchange, and keeps its 4U columns of w_hh in shared memory for
//   the whole sequence (U = ceil(H / SMs): 9 units, 166 KB at H = 1152,
//   128 blocks, one per SM). Rows are padded to a pitch P with P/4 odd,
//   so the float4 reads of 8 lanes on 8 columns hit distinct banks.
// - The forward (512 threads) publishes h_t (fp32) in a double-buffered
//   global buffer, and all blocks meet at a grid-wide barrier each step.
//   After it, a block stages the B rows of h_{t-1}, BB rows at a time (B
//   = 64 in decoding does not fit beside the weight), in one round of
//   float4 loads that bypass L1 (__ldcg: other blocks wrote them, and L1
//   is not coherent). Each gate column's dot product is split over KS
//   slices of k, KS and the slice length Kc fixed by make_plan for every
//   kernel of this file (the bits depend on them): one fmaf chain for
//   each (slice, column, row), a thread a (slice, column) with the chunk's
//   rows, neighbouring lanes on neighbouring columns, so a warp's loads of
//   h are broadcasts. Then one thread for
//   each (row, unit, gate) sums its slices in order and applies the
//   activation; the four gates of a unit meet by warp shuffles for the
//   cell update, whose c_{t-1} stays in shared memory. The next step's xg
//   loads before the barrier.
// - The backward keeps the same partition and weight slice. Its gate
//   recompute depends only on the saved (xg, ys, h0), so two kernels do it
//   for every step before the recurrence (lstm_scan_gates_kernel: one
//   slice of k of a tile a block; lstm_scan_gates_sum_kernel: the slices
//   summed in order, the activations) and leave the activations in dxg,
//   where step t reads them and writes dgates over them. The steps' chain
//   is then the cell update, the block's share of dh_prev for all H from
//   its own dgates and weight columns (share_product), and the exchange:
//   each block stores its shares where their owner reads them, one
//   contiguous region a chunk of rows, and after the grid barrier the
//   owner stages its region with float4 loads and sums the shares in
//   block order. A step's own operands load before the barrier. The
//   result is bitwise repeatable, and has the bits of the step-wise
//   design before it (PERF.md), which recomputed the gates inside each
//   step.
// - The dw product and the gate recompute's slices share one
//   register-blocked fp32 tile product on the CUDA cores
//   (csrc/tile_product.cuh, which K4's products use too; no tensor cores:
//   TF32 or bf16 would change the numbers): a 64 x 128 tile per block of
//   128 threads, 8 x 8 outputs a thread, slabs of 16 values of k in a
//   2-stage ring of shared memory (cp.async for fp32 rows, register loads
//   widened for bf16 ys) whose next slab loads while this one's FMAs run;
//   3 blocks an SM, dw's 648 blocks at the encoder in 1.64 waves of 396.
//   Each kernel brings its own loader of the left operand. Each output is
//   one fmaf chain over k in order, without atomics: bitwise repeatable,
//   and its bits do not depend on the tiling.
//
// The grid barrier needs every block resident: the launch is
// cooperative, and an occupancy check refuses a grid that cannot be
// co-resident (return code -2) or a weight slice that shared memory
// cannot hold (-1); nothing shrinks the grid silently. Any H and B are
// taken; the ragged edges are masked (the TPU's H % 128 rule does not
// apply). Math is fp32 with expf/tanhf (no fast math).
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches its kernels on the caller's stream (one, but two
// for the backward's gate recompute), allocates nothing, and returns a
// cudaError_t as int (or the codes above).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "tile_product.cuh"

namespace cg = cooperative_groups;

namespace {

// The slices of k of every gate column's dot product (Plan::KS) are
// derived from this count, the forward's block size when it was first
// written; every kernel here keeps those slices, since the bits depend on
// them.
constexpr int kSliceThreads = 256;
constexpr int kErrSharedMemory = -1;  // the weight slice does not fit shared memory
constexpr int kErrNotResident = -2;   // the grid cannot be co-resident

struct Plan {
  int S, B, H;
  int U;   // hidden units per block
  int P;   // row pitch of the staged weight columns and h rows, in floats
  int KS;  // k slices of each gate column's dot product
  int Kc;  // length of one k slice, a multiple of 4
  int Bp;  // B rounded up to the staging chunk
};

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The backward recurrence's phases, as its timed instantiation counts
// them: the prologue (the weight slice) and the epilogue once (row S of a
// block's table), the others each step (row t).
enum Phase {
  kPrologue,
  kOperands,
  kStageShares,
  kCell,
  kProduct,
  kStores,
  kBarrier,
  kEpilogue,
  kPhases
};

// The forward's phases, counted the same way: the prologue (the weight
// slice and the first xg) once, in row S, the others each step.
enum FwdPhase {
  kFwdPrologue,
  kFwdOperands,
  kFwdBarrier,
  kFwdStage,
  kFwdDots,
  kFwdCell,
  kFwdStores,
  kFwdPhases
};

// The timed instantiation's clock: thread 0 of the block adds the
// nanoseconds (%globaltimer) since its last mark to the phase that ends
// at the mark, in registers, and stores a row of its table when a step
// ends (no load of device memory on the way). Compiled out when kOn is
// false.
template <bool kOn, int kPhases>
struct PhaseClock {
  unsigned long long* table;  // (S + 1, kPhases) of this block
  unsigned long long last = 0, sums[kPhases] = {};
  __device__ explicit PhaseClock(unsigned long long* t) : table(t) {
    if constexpr (kOn) last = now();
  }
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void mark(int phase) {
    if constexpr (kOn) {
      if (threadIdx.x == 0) {
        const unsigned long long t = now();
        sums[phase] += t - last;
        last = t;
      }
    }
  }
  // stores the sums of a step's phases into its row, and restarts them
  __device__ void store(int row) {
    if constexpr (kOn) {
      if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < kPhases; ++i) {
          table[row * kPhases + i] = sums[i];
          sums[i] = 0;
        }
      }
    }
  }
  // the same for one phase (the prologue's and the epilogue's row)
  __device__ void store(int row, int phase) {
    if constexpr (kOn) {
      if (threadIdx.x == 0) {
        table[row * kPhases + phase] = sums[phase];
        sums[phase] = 0;
      }
    }
  }
};

// For idx < n, store(idx, load(idx)) over the block, each thread issuing
// kBatch loads before any store: a store through a generic pointer may
// alias a later load, so a plain loop would wait out each load's latency
// in turn.
template <int kBatch = 8, typename Load, typename Store>
__device__ __forceinline__ void copy_batched(int n, Load load, Store store) {
  for (int base = threadIdx.x; base < n; base += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * blockDim.x;
      v[i] = idx < n ? load(idx) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * blockDim.x;
      if (idx < n) store(idx, v[i]);
    }
  }
}

// w_s[col * P + k] = w_hh[k, g * H + j0 + u] for col = g * U + u; zero
// past H (rows) and past the last unit (columns).
template <int kBatch = 8>
__device__ void load_weight(float* w_s, const float* __restrict__ w_hh, const Plan& p, int j0) {
  const int ncol = 4 * p.U;
  copy_batched<kBatch>(
      ncol * p.P,
      [&](int idx) {
        const int k = idx / ncol, col = idx - k * ncol;
        const int g = col / p.U, j = j0 + col - g * p.U;
        return (k < p.H && j < p.H) ? w_hh[static_cast<size_t>(k) * 4 * p.H + g * p.H + j]
                                    : 0.0f;
      },
      [&](int idx, float v) {
        const int k = idx / ncol;
        w_s[(idx - k * ncol) * p.P + k] = v;
      });
}

// ---- The forward ----

// The forward's block: 16 warps an SM, as the backward's.
constexpr int kFwdThreads = 512;

// The forward's row pitch of the weight columns and h rows: KS slices of
// Kc, so that every slice's chain runs over Kc values (zeros past H), with
// P/4 odd as make_plan's pitch.
inline int fwd_pitch(const Plan& p) {
  int P = p.KS * p.Kc;  // >= make_plan's pitch, a multiple of 4
  if ((P / 4) % 2 == 0) P += 4;
  return P;
}

// Rows b0 .. b0 + nb of h (B, H) fp32 into h_s (pitch P): VEC (H % 4 == 0
// and src 16-byte aligned) a float4 a row for each thread in one round,
// every load issued before any store; ``coherent`` loads bypass L1, for rows
// other blocks wrote this launch. Columns past H keep their zeros.
template <int BB>
__device__ __forceinline__ void stage_h(float* h_s, const float* src, int b0, int nb, int H,
                                        int P, bool vec, bool coherent) {
  const size_t base = static_cast<size_t>(b0) * H;
  if (vec) {
    const int q4 = H / 4;
    for (int k4 = threadIdx.x; k4 < q4; k4 += kFwdThreads) {
      float4 v[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        if (r < nb) {
          const float4* q =
              reinterpret_cast<const float4*>(src + base + static_cast<size_t>(r) * H) + k4;
          v[r] = coherent ? __ldcg(q) : *q;
        }
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        if (r < nb) *reinterpret_cast<float4*>(h_s + r * P + 4 * k4) = v[r];
      }
    }
  } else {
    for (int k = threadIdx.x; k < H; k += kFwdThreads) {
      float v[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        if (r < nb) {
          const float* q = src + base + static_cast<size_t>(r) * H + k;
          v[r] = coherent ? __ldcg(q) : *q;
        }
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        if (r < nb) h_s[r * P + k] = v[r];
      }
    }
  }
}

// red[(r * 4U + col) * KS + ks] = the ks-th slice of sum_k h_s[r, k] w_s[col,
// k]: one fmaf chain over the slice's Kc values of k in order for each
// (slice, column, row). A thread takes a (slice, column) and the chunk's BB
// rows, item = ks * 4U + col: neighbouring lanes take neighbouring
// columns, so a warp's loads of h are broadcasts and a weight loaded from
// shared memory feeds BB chains. (Items of fewer rows, more of them, ran
// slower on the card: PERF.md.)
template <int BB>
__device__ __forceinline__ void fwd_gate_dots(const float* w_s, const float* h_s, float* red,
                                              int ncol, int KS, int Kc, int P) {
  for (int item = threadIdx.x; item < ncol * KS; item += kFwdThreads) {
    const int col = item % ncol, ks = item / ncol;
    const float* wp = w_s + col * P + ks * Kc;
    const float* hp = h_s + ks * Kc;
    float acc[BB];
#pragma unroll
    for (int r = 0; r < BB; ++r) acc[r] = 0.0f;
    for (int k = 0; k < Kc; k += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wp + k);
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hp + r * P + k);
        acc[r] = fmaf(h4.x, w4.x, acc[r]);
        acc[r] = fmaf(h4.y, w4.y, acc[r]);
        acc[r] = fmaf(h4.z, w4.z, acc[r]);
        acc[r] = fmaf(h4.w, w4.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BB; ++r) red[(r * ncol + col) * KS + ks] = acc[r];
  }
}

// The forward recurrence. Block j owns U units as the backward does and
// keeps their 4U columns of w_hh in shared memory (pitch P = fwd_pitch).
// For each step t and each chunk of BB rows: stage h_{t-1} (h0 at t = 0,
// then hbuf's parity t & 1), the slices' dot products (fwd_gate_dots), then
// one thread for each (row cr, unit cu, gate cg): its gate's pre-activation,
// xg + the KS slices summed in order from 0, and its activation; the four
// gates of a unit sit on neighbouring lanes and meet by shuffles for the
// cell update (c_{t-1} in shared memory c_s). Gate cg = 0 stores c, 1 ys, 2
// h_t into hbuf's parity (t + 1) & 1. The next step's xg (chunk 0) loads
// before the grid barrier. With kTimed, thread 0 records the phases
// (PhaseClock, FwdPhase).
template <typename T, int BB, bool kTimed>
__global__ void __launch_bounds__(kFwdThreads)
    lstm_scan_fwd_kernel(const T* __restrict__ xg, const float* __restrict__ w_hh,
                         const float* __restrict__ h0, const float* __restrict__ c0,
                         T* __restrict__ ys, float* __restrict__ cs, float* hbuf,
                         unsigned long long* times, Plan p) {
  cg::grid_group grid = cg::this_grid();
  PhaseClock<kTimed, kFwdPhases> timer(times + static_cast<size_t>(blockIdx.x) * (p.S + 1) *
                                                   kFwdPhases);
  extern __shared__ float4 smem4[];
  const int H = p.H, B = p.B, U = p.U, P = p.P, KS = p.KS, ncol = 4 * U, tid = threadIdx.x;
  const size_t BH = static_cast<size_t>(B) * H, H4 = 4 * static_cast<size_t>(H);
  const int j0 = blockIdx.x * U;
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + ncol * P;     // (BB, P) h_{t-1}, zero past H
  float* red = h_s + BB * P;       // (BB, 4U, KS) the slices' sums
  float* c_s = red + BB * ncol * KS;  // (B, U) c_{t-1}
  load_weight<32>(w_s, w_hh, p, j0);
  for (int idx = tid; idx < BB * P; idx += kFwdThreads) h_s[idx] = 0.0f;
  for (int idx = tid; idx < B * U; idx += kFwdThreads) {
    const int b = idx / U, j = j0 + idx - b * U;
    c_s[idx] = j < H ? c0[static_cast<size_t>(b) * H + j] : 0.0f;
  }
  // a cell thread's (row, unit, gate); its warp holds whole units
  const int cgate = tid & 3, cu = (tid >> 2) % U, cr = (tid >> 2) / U, cj = j0 + cu;
  const bool vec = H % 4 == 0;
  // the gate's xg of step t, row b0 + cr, as it is stored, so that no
  // conversion waits for the load before the barrier (0 off the cell threads)
  auto load_x = [&](int t, int b0) {
    return cr < min(BB, B - b0) && cj < H
               ? xg[(static_cast<size_t>(t) * B + b0 + cr) * H4 + cgate * H + cj]
               : T();
  };
  T x_next = load_x(0, 0);
  __syncthreads();
  timer.mark(kFwdPrologue);
  timer.store(p.S, kFwdPrologue);

  for (int t = 0; t < p.S; ++t) {
    float* hdst = hbuf + ((t + 1) & 1) * BH;
    for (int b0 = 0; b0 < B; b0 += BB) {
      const int nb = min(BB, B - b0);
      const T x = b0 == 0 ? x_next : load_x(t, b0);
      if (t == 0) {
        stage_h<BB>(h_s, h0, b0, nb, H, P, false, false);
      } else {
        stage_h<BB>(h_s, hbuf + (t & 1) * BH, b0, nb, H, P, vec, true);
      }
      __syncthreads();
      timer.mark(kFwdStage);
      fwd_gate_dots<BB>(w_s, h_s, red, ncol, KS, p.Kc, P);
      __syncthreads();
      timer.mark(kFwdDots);
      const bool cell = cr < nb && cj < H;
      const size_t bj = static_cast<size_t>(b0 + cr) * H + cj;
      float c_prev = 0.0f, act = 0.0f;
      if (cell) {
        c_prev = c_s[(b0 + cr) * U + cu];
        const float* q = red + (cr * ncol + cgate * U + cu) * KS;
        float s = 0.0f;
        for (int ks = 0; ks < KS; ++ks) s += q[ks];
        const float pre = to_f(x) + s;
        act = cgate == 2 ? tanhf(pre) : sigmoid(cgate == 1 ? pre + 1.0f : pre);
      }
      const int lane0 = (tid & 31) & ~3;
      const float i = __shfl_sync(0xffffffffu, act, lane0),
                  f = __shfl_sync(0xffffffffu, act, lane0 + 1),
                  g = __shfl_sync(0xffffffffu, act, lane0 + 2),
                  o = __shfl_sync(0xffffffffu, act, lane0 + 3);
      // f * c_prev + i * g contracted as nvcc compiled the design before
      // this one (whose bits this design keeps: PERF.md), written out so
      // that no compiler choice moves them
      const float c_new = fmaf(i, g, __fmul_rn(f, c_prev));
      const float h_new = o * tanhf(c_new);
      timer.mark(kFwdCell);
      if (cell) {
        if (cgate == 0) {
          cs[t * BH + bj] = c_new;
          c_s[(b0 + cr) * U + cu] = c_new;
        } else if (cgate == 1) {
          store_f(ys + t * BH + bj, h_new);
        } else if (cgate == 2) {
          hdst[bj] = h_new;
        }
      }
      timer.mark(kFwdStores);
      if (b0 + BB < B) __syncthreads();  // h_s and red are free for the next chunk
    }
    if (t + 1 < p.S) {
      x_next = load_x(t + 1, 0);  // in flight across the barrier
      timer.mark(kFwdOperands);
      grid.sync();  // h_t is published to every block
      timer.mark(kFwdBarrier);
    }
    timer.store(t);
  }
}

// ---- The backward recurrence ----

// The recurrence's block: 16 warps an SM (its registers allow them).
constexpr int kBwdThreads = 512;
// float4 loads of the staged shares a thread keeps in flight
constexpr int kStageBatch = 8;

// The exchange of dh shares: for each owner block, each chunk of BB rows
// and each sending block q, the (BB, U) shares of q for the owner's units,
// contiguous: q writes one run into each owner's region, and an owner
// reads one contiguous region for a chunk.
struct BwdPlan : Plan {
  int NC;  // chunks of BB rows, Bp / BB
  int QC;  // one (owner, chunk) region: blocks x BB x U floats, a multiple of 4
};

// Floats of the backward's exchange: two parities of (owner, chunk, QC).
inline size_t bwd_exchange_floats(const BwdPlan& p) {
  const size_t nblk = (p.H + p.U - 1) / p.U;
  return 2 * nblk * p.NC * static_cast<size_t>(p.QC);
}

// ---- The register-blocked fp32 tile product (csrc/tile_product.cuh) ----

constexpr int kTileM = tile::kM, kTileC = tile::kC, kTileK = tile::kK;
constexpr int kTileThreads = tile::kThreads, kTileBlocksPerSm = tile::kBlocksPerSm;
// float4 runs of an A slab a thread loads
constexpr int kRunsA = kTileK * kTileM / 4 / kTileThreads;
using tile::ASlab;

// out[m, c] = sum over k in [k_lo, k_hi), in order, of A[m, k] * Bm[k, c]
// for the block's tile: Bm row-major (k, H4) fp32, by 16-byte cp.async
// copies (VEC) or element loads; A through the caller's loader: stage_a(a,
// k0) starts the loads of A's slab k0 .. k0 + kTileK - 1 into a, land_a(a,
// k0) finishes them once this thread's cp.async copies have landed. out is
// row-major (M, H4); rows m0.. of it are the tile's.
template <bool VEC, typename StageA, typename LandA>
__device__ __forceinline__ void tile_product(StageA stage_a, LandA land_a,
                                             const float* __restrict__ bm, int k_lo, int k_hi,
                                             int H4, int c0, float* __restrict__ out, int m0,
                                             int M) {
  tile::RowSlab<kTileC, VEC> b;
  float acc[8][8];
  tile::mainloop<0>(
      [&](ASlab& a, tile::BSlab& bs, int s) {
        const int k0 = k_lo + s * kTileK;
        stage_a(a, k0);
        b.stage(bs, bm, H4, k0, k_hi, c0, H4);
      },
      [&](ASlab& a, tile::BSlab&, int s) { land_a(a, k_lo + s * kTileK); }, tile::NoSlabHook(),
      (k_hi - k_lo + kTileK - 1) / kTileK, acc, nullptr);
  tile::store<VEC>(acc, out, H4, m0, M, c0, H4);
}

// bf16 -> fp32 exactly, four values of an 8-byte run: the 16 bits on top
// of a zero mantissa tail
__device__ __forceinline__ float4 widen_bf16x4(uint2 w) {
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// The backward's gate recompute, hoisted out of the recurrence: for every
// row n = t * B + b < N = S * B of h_prev (h0 at t = 0, ys[t - 1] after)
// and column c = g * H + j, the gate activation of xg[n, c] + sum_k
// h_prev[n, k] w_hh[k, c], written into dxg[n, c], where step t of the
// recurrence reads it and writes dgates over it. It depends only on the
// saved tensors, so it runs at the card's throughput, not inside the
// steps' chain, and keeps the recurrence's bits before the hoist: the
// plan's KS slices of Kc values of k, each an fmaf chain over k in order,
// summed in slice order from 0, then added to xg. Two kernels: the
// slices' products (lstm_scan_gates_kernel, one slice of a tile a block,
// so the slices add parallelism), then their ordered sum with the
// activations (lstm_scan_gates_sum_kernel).
//
// part[ks, n, c] = sum over k in slice ks, in order, of h_prev[n, k] *
// w_hh[k, c]: the tile product with A = h_prev (n, k), whose rows run
// along k, so a thread loads runs of them into registers and stores them
// transposed into the slab. VEC: H % 4 == 0 and the pointers aligned, so
// each run is one 16-byte (fp32) or 8-byte (bf16 ys) load, and w_hh's rows
// come by cp.async.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
    lstm_scan_gates_kernel(const float* __restrict__ h0, const T* __restrict__ ys,
                           const float* __restrict__ w_hh, float* __restrict__ part, int S,
                           int B, int H, int Kc) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int N = S * B, H4 = 4 * H, n0 = blockIdx.y * kTileM;
  const int k_lo = blockIdx.z * Kc, k_hi = min(k_lo + Kc, H);  // this block's slice
  float a_reg[kRunsA][4];
  // h_prev[n0 + r, k0 + kq .. + 3] into registers, a run of 4 a load
  auto stage_a = [&](ASlab&, int k0) {
#pragma unroll
    for (int i = 0; i < kRunsA; ++i) {
      const int u = threadIdx.x + i * kTileThreads, r = u / (kTileK / 4);
      const int n = n0 + r, k = k0 + (u % (kTileK / 4)) * 4;
      if constexpr (VEC) {  // H % 4 == 0 and Kc % 4 == 0: a run is all in or all out
        a_reg[i][0] = a_reg[i][1] = a_reg[i][2] = a_reg[i][3] = 0.0f;
        if (n < N && k < k_hi) {
          if (n < B || !kBf16) {
            const float* src = n < B ? h0 + static_cast<size_t>(n) * H + k
                                     : reinterpret_cast<const float*>(ys) +
                                           static_cast<size_t>(n - B) * H + k;
            const float4 v = *reinterpret_cast<const float4*>(src);
            a_reg[i][0] = v.x, a_reg[i][1] = v.y, a_reg[i][2] = v.z, a_reg[i][3] = v.w;
          } else {
            const float4 v = widen_bf16x4(
                __ldg(reinterpret_cast<const uint2*>(ys + static_cast<size_t>(n - B) * H + k)));
            a_reg[i][0] = v.x, a_reg[i][1] = v.y, a_reg[i][2] = v.z, a_reg[i][3] = v.w;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_reg[i][e] = 0.0f;
          if (n < N && k + e < k_hi) {
            a_reg[i][e] = n < B ? h0[static_cast<size_t>(n) * H + k + e]
                                : load_f(ys + static_cast<size_t>(n - B) * H + k + e);
          }
        }
      }
    }
  };
  // the runs stored transposed: a[kq + e][r]
  auto land_a = [&](ASlab& a, int) {
#pragma unroll
    for (int i = 0; i < kRunsA; ++i) {
      const int u = threadIdx.x + i * kTileThreads, r = u / (kTileK / 4);
      const int kq = (u % (kTileK / 4)) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kq + e][r] = a_reg[i][e];
    }
  };
  tile_product<VEC>(stage_a, land_a, w_hh, k_lo, k_hi, H4, blockIdx.x * kTileC,
                    part + static_cast<size_t>(blockIdx.z) * N * H4, n0, N);
}

// dxg[n, c] = the gate activation of xg[n, c] + the KS slices of part[:,
// n, c] summed in slice order from 0; four columns a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    lstm_scan_gates_sum_kernel(const float* __restrict__ part, const T* __restrict__ xg,
                               float* __restrict__ dxg, int N, int H, int KS) {
  const size_t total4 = static_cast<size_t>(N) * H;  // float4s of (N, 4H)
  const size_t slice = static_cast<size_t>(N) * 4 * H;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < total4;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ks = 0; ks < KS; ++ks) {
      const float4 v = reinterpret_cast<const float4*>(part + ks * slice)[e];
      sum[0] += v.x, sum[1] += v.y, sum[2] += v.z, sum[3] += v.w;
    }
    float act[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t at = 4 * e + q;
      const int g = static_cast<int>(at % (4 * static_cast<size_t>(H))) / H;
      const float pre = load_f(xg + at) + sum[q];
      act[q] = g == 2 ? tanhf(pre) : sigmoid(g == 1 ? pre + 1.0f : pre);
    }
    reinterpret_cast<float4*>(dxg)[e] = make_float4(act[0], act[1], act[2], act[3]);
  }
}

// sh[0 .. n4 * 4) = src, the owner's region of one chunk (every block's
// shares of dh for this block's units), as float4 loads from L2 (other
// blocks wrote them: L1 is bypassed), kStageBatch in flight a thread.
__device__ void stage_own_shares(float* sh, const float* src, int n4) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* sh4 = reinterpret_cast<float4*>(sh);
  for (int base = threadIdx.x; base < n4; base += kStageBatch * kBwdThreads) {
    float4 v[kStageBatch];
#pragma unroll
    for (int i = 0; i < kStageBatch; ++i) {
      const int idx = base + i * kBwdThreads;
      if (idx < n4) v[i] = __ldcg(src4 + idx);
    }
#pragma unroll
    for (int i = 0; i < kStageBatch; ++i) {
      const int idx = base + i * kBwdThreads;
      if (idx < n4) sh4[idx] = v[i];
    }
  }
}

// The staged shares of one (row, unit), q[blk * stride], summed over the
// blocks in block order; loads go in batches ahead of their adds.
__device__ __forceinline__ float sum_own_shares(const float* q, int stride, int nblk) {
  constexpr int kBatch = 16;
  float s = 0.0f;
  int blk = 0;
  for (; blk + kBatch <= nblk; blk += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) v[i] = q[(blk + i) * stride];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) s += v[i];
  }
  for (; blk < nblk; ++blk) s += q[blk * stride];
  return s;
}

// This block's share of dh_prev for every k and the rows c0 .. c0 + BB of
// a chunk: the sum over its 4U columns, in order, of dgates[b, col] *
// w_hh[k, col], one fmaf chain an output, into so[(owner * BB + r) * U +
// u] for k = owner * U + u (shared memory, for store_shares). A thread
// takes 4 consecutive k: a column's 4 weights are one float4 (neighbouring
// lanes on neighbouring addresses) and its BB dgates BB / 4 broadcast
// float4s, for 4 x BB FMAs.
template <int BB>
__device__ void share_product(const float* w_s, const float* dg_s, float* so, const BwdPlan& p,
                              int c0) {
  const int H = p.H, U = p.U, ncol = 4 * U, quads = (H + 3) / 4;
  for (int kq = threadIdx.x; kq < quads; kq += kBwdThreads) {
    float acc[4][BB];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[e][r] = 0.0f;
    }
    const float* wp = w_s + 4 * kq;  // zero past H, within the pitch P
#pragma unroll 4
    for (int col = 0; col < ncol; ++col) {
      const float4 w4 = *reinterpret_cast<const float4*>(wp + col * p.P);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      float d[BB];
#pragma unroll
      for (int r = 0; r < BB; r += 4) {
        const float4 x = *reinterpret_cast<const float4*>(dg_s + col * p.Bp + c0 + r);
        d[r] = x.x, d[r + 1] = x.y, d[r + 2] = x.z, d[r + 3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < BB; ++r) acc[e][r] = fmaf(d[r], w[e], acc[e][r]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * kq + e;
      if (k >= H) continue;
      const int owner = k / U;
      float* dst = so + owner * BB * U + (k - owner * U);
#pragma unroll
      for (int r = 0; r < BB; ++r) dst[r * U] = acc[e][r];
    }
  }
}

// The chunk's shares from shared memory into the exchange: the (BB, U)
// run for each owner at its (owner, chunk) region, slot q (this block), in
// float4 stores that neighbouring threads make to neighbouring addresses.
template <int BB>
__device__ void store_shares(const float* so, float* out, const BwdPlan& p, int c, int q) {
  const int run4 = BB * p.U / 4, n4 = gridDim.x * run4;
  const float4* so4 = reinterpret_cast<const float4*>(so);
  for (int e = threadIdx.x; e < n4; e += kBwdThreads) {
    const int owner = e / run4;
    float* dst = out + (static_cast<size_t>(owner) * p.NC + c) * p.QC + q * BB * p.U;
    reinterpret_cast<float4*>(dst)[e - owner * run4] = so4[e];
  }
}

// The backward recurrence, after lstm_scan_gates_kernel has left every
// step's gate activations in dxg. Block j owns U units as in the forward
// and keeps their 4U columns of w_hh in shared memory. For t = S-1..0:
// the step's own operands (its activations, c_{t-1}, dys[t]) load before
// the wait; after it, the block stages its units' shares of dh from step
// t + 1 (one contiguous region a chunk of rows), sums them in block order,
// updates the cell and writes dgates over the activations; then it forms
// its share of dh_prev for all H (share_product) and stores it in the
// exchange's parity t & 1; the grid then meets before the next step's
// staging (the step's own operands are in flight by then). The epilogue
// sums step 0's shares into dh0. With kTimed, thread 0 records the
// phases (PhaseClock).
template <typename T, int BB, bool kTimed>
__global__ void __launch_bounds__(kBwdThreads)
    lstm_scan_bwd_kernel(const float* __restrict__ w_hh, const float* __restrict__ c0,
                         const float* __restrict__ cs, const T* __restrict__ dys,
                         const T* __restrict__ dhT, const float* __restrict__ dcT,
                         float* __restrict__ dxg, float* __restrict__ dh0,
                         float* __restrict__ dc0, float* xbuf, unsigned long long* times,
                         BwdPlan p) {
  cg::grid_group grid = cg::this_grid();
  PhaseClock<kTimed, kPhases> timer(times + static_cast<size_t>(blockIdx.x) * (p.S + 1) * kPhases);
  extern __shared__ float4 smem4[];
  const int H = p.H, B = p.B, U = p.U, ncol = 4 * U, tid = threadIdx.x;
  const int nblk = gridDim.x, j0 = blockIdx.x * U;
  const size_t BH = static_cast<size_t>(B) * H, H4 = 4 * static_cast<size_t>(H);
  const size_t parity = static_cast<size_t>(nblk) * p.NC * p.QC;
  const size_t mine = static_cast<size_t>(blockIdx.x) * p.NC * p.QC;
  const int n4 = nblk * BB * U / 4;  // float4s of one (owner, chunk) region
  float* w_s = reinterpret_cast<float*>(smem4);
  float* sh = w_s + ncol * p.P;      // (blocks, BB, U) shares staged in, then out
  float* dg_s = sh + p.QC;           // (4U, Bp) this step's dgates, column-major
  float* dc_s = dg_s + ncol * p.Bp;  // (B, U) the dc carry
  load_weight<32>(w_s, w_hh, p, j0);
  for (int idx = tid; idx < ncol * p.Bp; idx += kBwdThreads) dg_s[idx] = 0.0f;
  __syncthreads();
  timer.mark(kPrologue);
  timer.store(p.S, kPrologue);

  const int cr = tid / U, cu = tid - cr * U, cj = j0 + cu;  // a cell thread's (row, unit)
  for (int t = p.S - 1; t >= 0; --t) {
    const bool last = t == p.S - 1;
    for (int b0 = 0; b0 < B; b0 += BB) {
      const int nb = min(BB, B - b0), b = b0 + cr;
      const bool cell = tid < nb * U && cj < H;
      const size_t bj = static_cast<size_t>(b) * H + cj;
      float* dxg_row = dxg + (static_cast<size_t>(t) * B + b) * H4 + cj;
      // no other block writes these: they load before the wait (dys as it
      // is stored, so that no conversion waits for it there)
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c_prev = 0.0f;
      T dy_raw = T();
      if (cell) {
#pragma unroll
        for (int g = 0; g < 4; ++g) a[g] = dxg_row[g * H];
        c_prev = t == 0 ? c0[bj] : cs[(t - 1) * BH + bj];
        dy_raw = dys[t * BH + bj];
      }
      timer.mark(kOperands);
      if (!last) {
        if (b0 == 0) grid.sync();  // every block's shares of step t + 1 are stored
        timer.mark(kBarrier);
        stage_own_shares(sh, xbuf + ((t + 1) & 1) * parity + mine + (b0 / BB) * p.QC, n4);
        __syncthreads();
        timer.mark(kStageShares);
      }
      if (cell) {
        const float i = a[0], f = a[1], g = a[2], o = a[3];
        // f * c_prev + i * g contracted as nvcc compiled the step-wise
        // design's source (whose bits this design keeps: PERF.md), written
        // out so that no compiler choice moves them
        const float tct = tanhf(fmaf(i, g, __fmul_rn(f, c_prev)));
        float dh_carry, dc_carry;
        if (last) {
          dh_carry = load_f(dhT + bj);
          dc_carry = dcT[bj];
        } else {
          dh_carry = sum_own_shares(sh + cr * U + cu, BB * U, nblk);
          dc_carry = dc_s[b * U + cu];
        }
        const float dh = dh_carry + to_f(dy_raw);
        const float dc = dc_carry + dh * o * (1.0f - tct * tct);
        // same operation order as the Pallas backward
        const float dg[4] = {dc * g * i * (1.0f - i), dc * c_prev * f * (1.0f - f),
                             dc * i * (1.0f - g * g), dh * tct * o * (1.0f - o)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dxg_row[q * H] = dg[q];
          dg_s[(q * U + cu) * p.Bp + b] = dg[q];
        }
        dc_s[b * U + cu] = dc * f;
      }
      __syncthreads();  // the staged shares are read; dgates are whole
      timer.mark(kCell);
    }
    for (int c = 0; c < p.NC; ++c) {  // sh is free: the shares go out through it
      share_product<BB>(w_s, dg_s, sh, p, c * BB);
      __syncthreads();
      timer.mark(kProduct);
      store_shares<BB>(sh, xbuf + (t & 1) * parity, p, c, blockIdx.x);
      __syncthreads();  // every thread's shares are stored; sh is free
      timer.mark(kStores);
    }
    timer.store(t);
  }
  // dh0 = the shares of step 0 summed in block order; dc0 = the dc carry
  grid.sync();
  for (int b0 = 0; b0 < B; b0 += BB) {
    const int nb = min(BB, B - b0);
    stage_own_shares(sh, xbuf + mine + (b0 / BB) * p.QC, n4);
    __syncthreads();
    if (tid < nb * U && cj < H) {
      const size_t bj = static_cast<size_t>(b0 + cr) * H + cj;
      dh0[bj] = sum_own_shares(sh + cr * U + cu, BB * U, nblk);
      dc0[bj] = dc_s[(b0 + cr) * U + cu];
    }
    __syncthreads();
  }
  timer.mark(kEpilogue);
  timer.store(p.S, kEpilogue);
}

// dw[m, c] = sum over n = t * B + b of h_prev[n, m] * dg[n, c], n in
// order; h_prev[n] = h0[b] for t = 0, ys[t - 1, b] after: the tile
// product with A = h_prev^T (m, n), whose slab is rows of h_prev as they
// lie, and Bm = dg. VEC: H % 4 == 0 and the pointers aligned, so every
// slab moves in runs of 4: 16-byte cp.async copies of fp32 rows, and
// 8-byte register loads of bf16 ys rows, widened into shared memory after
// the slab before's FMAs; otherwise one element a load, through registers.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
    lstm_scan_dw_kernel(const float* __restrict__ h0, const T* __restrict__ ys,
                        const float* __restrict__ dg, float* __restrict__ dw, int S, int B,
                        int H) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int N = S * B, m0 = blockIdx.y * kTileM;
  uint2 a_bf16[kBf16 && VEC ? kRunsA : 1];  // the bf16 runs of the slab in flight
  auto stage_a = [&](ASlab& a, int k0) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < kRunsA; ++i) {  // row r of the slab, m .. m + 3
        const int u = threadIdx.x + i * kTileThreads, r = u / (kTileM / 4);
        const int col = (u % (kTileM / 4)) * 4, n = k0 + r, m = m0 + col;
        const bool ok = n < N && m < H;
        if constexpr (kBf16) {
          if (ok && n >= B) {
            a_bf16[i] =
                __ldg(reinterpret_cast<const uint2*>(ys + static_cast<size_t>(n - B) * H + m));
            continue;
          }
        }
        const float* src = !ok ? h0
                           : n < B ? h0 + static_cast<size_t>(n) * H + m
                                   : reinterpret_cast<const float*>(ys) +
                                         static_cast<size_t>(n - B) * H + m;
        tile::cp_async16(&a[r][col], src, ok);
      }
    } else {
      float v[kTileK * kTileM / kTileThreads];
#pragma unroll
      for (int i = 0; i < kTileK * kTileM / kTileThreads; ++i) {  // every load before the stores
        const int e = threadIdx.x + i * kTileThreads, m = m0 + e % kTileM, n = k0 + e / kTileM;
        v[i] = 0.0f;
        if (n < N && m < H) {
          v[i] = n < B ? h0[static_cast<size_t>(n) * H + m]
                       : load_f(ys + static_cast<size_t>(n - B) * H + m);
        }
      }
#pragma unroll
      for (int i = 0; i < kTileK * kTileM / kTileThreads; ++i) {
        const int e = threadIdx.x + i * kTileThreads;
        a[e / kTileM][e % kTileM] = v[i];
      }
    }
  };
  // the bf16 runs widened into the slab
  auto land_a = [&](ASlab& a, int k0) {
    if constexpr (kBf16 && VEC) {
#pragma unroll
      for (int i = 0; i < kRunsA; ++i) {
        const int u = threadIdx.x + i * kTileThreads, r = u / (kTileM / 4);
        const int col = (u % (kTileM / 4)) * 4, n = k0 + r;
        if (n < N && n >= B && m0 + col < H) {
          *reinterpret_cast<float4*>(&a[r][col]) = widen_bf16x4(a_bf16[i]);
        }
      }
    }
  };
  tile_product<VEC>(stage_a, land_a, dg, 0, N, 4 * H, blockIdx.x * kTileC, dw, m0, H);
}

inline Plan make_plan(int S, int B, int H, int U, int BB) {
  Plan p;
  p.S = S;
  p.B = B;
  p.H = H;
  p.U = U;
  // P also holds one row of dh shares, one per unit of every block
  p.P = (std::max(H, (H + U - 1) / U * U) + 3) / 4 * 4;
  if ((p.P / 4) % 2 == 0) p.P += 4;  // P/4 odd: 8 columns' float4 reads on distinct banks
  p.KS = std::max(1, std::min(kSliceThreads / (4 * U), p.P / 4));
  p.Kc = ((p.P + p.KS - 1) / p.KS + 3) / 4 * 4;
  p.Bp = (B + BB - 1) / BB * BB;
  return p;
}

// The forward's plan: make_plan's slices, its own pitch.
inline Plan make_fwd_plan(int S, int B, int H, int U, int BB) {
  Plan p = make_plan(S, B, H, U, BB);
  p.P = fwd_pitch(p);
  return p;
}

// The forward's shared memory: the weight slice, BB rows of h, the
// slices' sums and the (B, U) cell states.
inline size_t fwd_smem_bytes(const Plan& p, int BB) {
  return (static_cast<size_t>(4 * p.U) * p.P + static_cast<size_t>(BB) * p.P +
          static_cast<size_t>(BB) * 4 * p.U * p.KS + static_cast<size_t>(p.B) * p.U) *
         sizeof(float);
}

inline BwdPlan make_bwd_plan(int S, int B, int H, int U, int BB) {
  BwdPlan p;
  static_cast<Plan&>(p) = make_plan(S, B, H, U, BB);
  const int nblk = (H + U - 1) / U;
  p.NC = p.Bp / BB;
  p.QC = (nblk * BB * U + 3) / 4 * 4;
  return p;
}

inline size_t bwd_smem_bytes(const BwdPlan& p, int BB) {
  const size_t ncol = 4 * p.U;
  return (ncol * p.P + p.QC + ncol * p.Bp + static_cast<size_t>(p.B) * p.U) * sizeof(float);
}

inline int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// The forward's chunk of rows: 4 for B <= 4, else 8 where shared memory
// holds them, else 4; its cell threads (BB x U x 4 gates) within the
// block. 0 when not even 4 fit.
inline int pick_bb(int S, int B, int H, int U) {
  const size_t limit = static_cast<size_t>(max_smem());
  for (int bb : {8, 4}) {
    if ((bb == 8 && B <= 4) || bb * U * 4 > kFwdThreads) continue;
    if (fwd_smem_bytes(make_fwd_plan(S, B, H, U, bb), bb) <= limit) return bb;
  }
  return 0;
}

// The backward's chunk of rows (the cell threads, BB x U, at most one a
// thread, and the staged shares), chosen as the forward's.
inline int pick_bwd_bb(int S, int B, int H, int U) {
  const size_t limit = static_cast<size_t>(max_smem());
  for (int bb : {8, 4}) {
    if ((bb == 8 && B <= 4) || bb * U > kBwdThreads) continue;
    if (bwd_smem_bytes(make_bwd_plan(S, B, H, U, bb), bb) <= limit) return bb;
  }
  return 0;
}

// Opt in to the shared memory, check that the grid can be co-resident,
// and launch cooperatively.
int coop_launch(const void* kernel, int grid, int threads, size_t smem, void** args,
                cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(per_sm) * sms < grid) return kErrNotResident;
  err = cudaLaunchCooperativeKernel(kernel, grid, threads, args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* xg, const void* w_hh, const void* h0, const void* c0, void* ys,
               void* cs, void* hbuf, void* times, int S, int B, int H, int U,
               cudaStream_t stream) {
  const int bb = pick_bb(S, B, H, U);
  if (bb == 0) return kErrSharedMemory;
  Plan p = make_fwd_plan(S, B, H, U, bb);
  const T* xg_p = static_cast<const T*>(xg);
  const float* w_p = static_cast<const float*>(w_hh);
  const float* h0_p = static_cast<const float*>(h0);
  const float* c0_p = static_cast<const float*>(c0);
  T* ys_p = static_cast<T*>(ys);
  float* cs_p = static_cast<float*>(cs);
  float* hb_p = static_cast<float*>(hbuf);
  auto* times_p = static_cast<unsigned long long*>(times);
  void* args[] = {&xg_p, &w_p, &h0_p, &c0_p, &ys_p, &cs_p, &hb_p, &times_p, &p};
  const void* kernel =
      times != nullptr
          ? (bb == 8 ? reinterpret_cast<const void*>(&lstm_scan_fwd_kernel<T, 8, true>)
                     : reinterpret_cast<const void*>(&lstm_scan_fwd_kernel<T, 4, true>))
          : (bb == 8 ? reinterpret_cast<const void*>(&lstm_scan_fwd_kernel<T, 8, false>)
                     : reinterpret_cast<const void*>(&lstm_scan_fwd_kernel<T, 4, false>));
  return coop_launch(kernel, (H + U - 1) / U, kFwdThreads, fwd_smem_bytes(p, bb), args, stream);
}

template <typename T>
int launch_gates(const void* xg, const void* h0, const void* ys, const void* w_hh, void* part,
                 void* dxg, int S, int B, int H, int U, cudaStream_t stream) {
  const auto aligned = [](const void* p, unsigned bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const Plan p = make_plan(S, B, H, U, 4);  // the recurrence's slices of k
  const bool vec = H % 4 == 0 && aligned(h0, 16) && aligned(ys, 4 * sizeof(T)) &&
                   aligned(w_hh, 16) && aligned(part, 16);
  const int N = S * B;
  const dim3 grid((4 * H + kTileC - 1) / kTileC, (N + kTileM - 1) / kTileM, p.KS);
  const T* xg_p = static_cast<const T*>(xg);
  const float* h0_p = static_cast<const float*>(h0);
  const T* ys_p = static_cast<const T*>(ys);
  const float* w_p = static_cast<const float*>(w_hh);
  float* part_p = static_cast<float*>(part);
  if (vec) {
    lstm_scan_gates_kernel<T, true>
        <<<grid, kTileThreads, 0, stream>>>(h0_p, ys_p, w_p, part_p, S, B, H, p.Kc);
  } else {
    lstm_scan_gates_kernel<T, false>
        <<<grid, kTileThreads, 0, stream>>>(h0_p, ys_p, w_p, part_p, S, B, H, p.Kc);
  }
  const size_t total4 = static_cast<size_t>(N) * H;
  const unsigned blocks = static_cast<unsigned>(std::min<size_t>((total4 + 255) / 256, 4096));
  lstm_scan_gates_sum_kernel<T><<<blocks, 256, 0, stream>>>(part_p, xg_p,
                                                           static_cast<float*>(dxg), N, H, p.KS);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* w_hh, const void* c0, const void* cs, const void* dys, const void* dhT,
               const void* dcT, void* dxg, void* dh0, void* dc0, void* scratch, void* times, int S,
               int B, int H, int U, cudaStream_t stream) {
  const int bb = pick_bwd_bb(S, B, H, U);
  if (bb == 0) return kErrSharedMemory;
  BwdPlan p = make_bwd_plan(S, B, H, U, bb);
  const float* w_p = static_cast<const float*>(w_hh);
  const float* c0_p = static_cast<const float*>(c0);
  const float* cs_p = static_cast<const float*>(cs);
  const T* dys_p = static_cast<const T*>(dys);
  const T* dhT_p = static_cast<const T*>(dhT);
  const float* dcT_p = static_cast<const float*>(dcT);
  float* dxg_p = static_cast<float*>(dxg);
  float* dh0_p = static_cast<float*>(dh0);
  float* dc0_p = static_cast<float*>(dc0);
  float* xbuf_p = static_cast<float*>(scratch);
  auto* times_p = static_cast<unsigned long long*>(times);
  void* args[] = {&w_p,   &c0_p,  &cs_p,   &dys_p,   &dhT_p, &dcT_p, &dxg_p,
                  &dh0_p, &dc0_p, &xbuf_p, &times_p, &p};
  const void* kernel =
      times != nullptr
          ? (bb == 8 ? reinterpret_cast<const void*>(&lstm_scan_bwd_kernel<T, 8, true>)
                     : reinterpret_cast<const void*>(&lstm_scan_bwd_kernel<T, 4, true>))
          : (bb == 8 ? reinterpret_cast<const void*>(&lstm_scan_bwd_kernel<T, 8, false>)
                     : reinterpret_cast<const void*>(&lstm_scan_bwd_kernel<T, 4, false>));
  return coop_launch(kernel, (H + U - 1) / U, kBwdThreads, bwd_smem_bytes(p, bb), args, stream);
}

template <typename T>
int launch_dw(const void* h0, const void* ys, const void* dgates, void* dw, int S, int B, int H,
              cudaStream_t stream) {
  const auto aligned = [](const void* p, unsigned bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = H % 4 == 0 && aligned(h0, 16) && aligned(ys, 4 * sizeof(T)) &&
                   aligned(dgates, 16) && aligned(dw, 16);
  const dim3 grid((4 * H + kTileC - 1) / kTileC, (H + kTileM - 1) / kTileM);
  const float* h0_p = static_cast<const float*>(h0);
  const T* ys_p = static_cast<const T*>(ys);
  const float* dg_p = static_cast<const float*>(dgates);
  float* dw_p = static_cast<float*>(dw);
  if (vec) {
    lstm_scan_dw_kernel<T, true>
        <<<grid, kTileThreads, 0, stream>>>(h0_p, ys_p, dg_p, dw_p, S, B, H);
  } else {
    lstm_scan_dw_kernel<T, false>
        <<<grid, kTileThreads, 0, stream>>>(h0_p, ys_p, dg_p, dw_p, S, B, H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 xg/ys/dys/dhT, 1 = bfloat16. w_hh, h0, c0, cs, dcT
// and every gradient are float32. U is the number of hidden units per
// block; the grid is ceil(H / U) blocks, all resident at once. hbuf is
// the forward's (2, B, H) float32 scratch. times: null for the model's
// calls, else a (grid, S + 1, kFwdPhases) uint64 table that the timed
// instantiation fills (FwdPhase above). Returns a cudaError_t as int (0 =
// success), -1 when the weight slice does not fit shared memory, -2 when
// the grid cannot be co-resident.
extern "C" int lstm_scan_fwd(int dtype, const void* xg, const void* w_hh, const void* h0,
                             const void* c0, void* ys, void* cs, void* hbuf, void* times, int S,
                             int B, int H, int U, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || U <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(xg, w_hh, h0, c0, ys, cs, hbuf, times, S, B, H, U, s);
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(xg, w_hh, h0, c0, ys, cs, hbuf, times, S, B, H, U, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's gate recompute (lstm_scan_gates_kernel and its sum):
// every step's gate activations into dxg (S, B, 4H) float32, from xg, h0,
// ys and w_hh as lstm_scan_fwd takes them; part is
// lstm_scan_bwd_gates_floats(S, B, H, U) float32 of scratch, the slices'
// products. lstm_scan_bwd then runs the recurrence.
extern "C" int lstm_scan_bwd_gates(int dtype, const void* xg, const void* h0, const void* ys,
                                   const void* w_hh, void* part, void* dxg, int S, int B, int H,
                                   int U, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || U <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gates<float>(xg, h0, ys, w_hh, part, dxg, S, B, H, U, s);
  if (dtype == 1) return launch_gates<__nv_bfloat16>(xg, h0, ys, w_hh, part, dxg, S, B, H, U, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gate recompute's scratch, in float32 elements: (KS, S * B, 4H).
extern "C" long long lstm_scan_bwd_gates_floats(int S, int B, int H, int U) {
  if (S <= 0 || B <= 0 || H <= 0 || U <= 0) return 0;
  return static_cast<long long>(make_plan(S, B, H, U, 4).KS) * S * B * 4 * H;
}

// The backward recurrence, t = S-1..0, over the activations that
// lstm_scan_bwd_gates left in dxg: dgates into dxg, dh0 and dc0 (B, H)
// float32. dys and dhT in the dtype, cs, c0 and dcT float32. scratch:
// lstm_scan_bwd_scratch_floats(S, B, H, U) float32, the exchange of dh
// shares. times: null for the model's calls, else a
// (grid, S + 1, kPhases) uint64 table that the timed instantiation fills
// (Phase above).
extern "C" int lstm_scan_bwd(int dtype, const void* w_hh, const void* c0, const void* cs,
                             const void* dys, const void* dhT, const void* dcT, void* dxg,
                             void* dh0, void* dc0, void* scratch, void* times, int S, int B,
                             int H, int U, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || U <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(w_hh, c0, cs, dys, dhT, dcT, dxg, dh0, dc0, scratch, times, S, B, H,
                             U, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(w_hh, c0, cs, dys, dhT, dcT, dxg, dh0, dc0, scratch, times,
                                     S, B, H, U, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's scratch, in float32 elements: the exchange of dh shares
// (1 when lstm_scan_bwd refuses the shape).
extern "C" long long lstm_scan_bwd_scratch_floats(int S, int B, int H, int U) {
  const int bb = S > 0 && B > 0 && H > 0 && U > 0 ? pick_bwd_bb(S, B, H, U) : 0;
  if (bb == 0) return 1;
  return static_cast<long long>(bwd_exchange_floats(make_bwd_plan(S, B, H, U, bb)));
}

// dw (H, 4H) float32 from h0 (B, H) float32, ys (S, B, H) in the dtype
// and dgates (S, B, 4H) float32.
extern "C" int lstm_scan_dw(int dtype, const void* h0, const void* ys, const void* dgates,
                            void* dw, int S, int B, int H, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dw<float>(h0, ys, dgates, dw, S, B, H, s);
  if (dtype == 1) return launch_dw<__nv_bfloat16>(h0, ys, dgates, dw, S, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dw kernel's resident blocks an SM (dtype as above; vec 1 for the
// 16-byte route), into *blocks; returns a cudaError_t as int.
extern "C" int lstm_scan_dw_blocks_per_sm(int dtype, int vec, int* blocks) {
  const void* k = dtype == 0 ? (vec ? reinterpret_cast<const void*>(&lstm_scan_dw_kernel<float, true>)
                                    : reinterpret_cast<const void*>(&lstm_scan_dw_kernel<float, false>))
                             : (vec ? reinterpret_cast<const void*>(
                                          &lstm_scan_dw_kernel<__nv_bfloat16, true>)
                                    : reinterpret_cast<const void*>(
                                          &lstm_scan_dw_kernel<__nv_bfloat16, false>));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kTileThreads, 0));
}
