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
// - Each step stages B rows of h (fp32) in shared memory, BB rows at a
//   time (B = 64 in decoding does not fit beside the weight), and splits
//   each gate column's dot product over KS slices of k; the slices are
//   summed in a fixed order.
// - The forward publishes h_t (fp32) in a double-buffered global buffer,
//   and all blocks meet at a grid-wide barrier each step. Loads of data
//   that other blocks wrote bypass L1 (__ldcg), which is not coherent.
// - The backward recomputes its units' gates from the stored ys (no
//   exchange needed), then forms its share of dh_prev for all H from its
//   own dgates and weight columns. The shares go to a double-buffered
//   global buffer; after the barrier each block stages the shares of its
//   units in shared memory (all loads in flight at once) and sums them
//   over the blocks in block order. The result is bitwise repeatable.
// - The dw product is a register-blocked fp32 product on the CUDA cores
//   (no tensor cores: TF32 or bf16 would change the numbers): a 64 x 128
//   tile of dw per block of 128 threads, 8 x 8 outputs a thread, slabs of
//   16 rows of n in a 2-stage ring of shared memory (cp.async for fp32
//   rows, register loads widened in place for bf16 ys) whose next slab
//   loads while this one's FMAs run; 3 blocks an SM, the encoder's 648
//   blocks in 1.64 waves of 396. Each output is one fmaf chain over
//   n = t * B + b in order, without atomics: bitwise repeatable, and its
//   bits do not depend on the tiling.
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
// entry point launches one kernel on the caller's stream, allocates
// nothing, and returns a cudaError_t as int (or the codes above).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
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

// For idx < n, store(idx, load(idx)) over the block, each thread issuing
// kBatch loads before any store: a store through a generic pointer may
// alias a later load, so a plain loop would wait out each load's latency
// in turn.
template <typename Load, typename Store>
__device__ __forceinline__ void copy_batched(int n, Load load, Store store) {
  constexpr int kBatch = 8;
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
__device__ void load_weight(float* w_s, const float* __restrict__ w_hh, const Plan& p, int j0) {
  const int ncol = 4 * p.U;
  copy_batched(
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

// h_s[r * P + k] = src[(b0 + r) * H + k] as fp32, zero past B and H.
// ``coherent`` reads bypass L1, for rows other blocks wrote this launch.
template <int BB, typename T>
__device__ void stage_rows(float* h_s, const T* __restrict__ src, int b0, const Plan& p,
                           bool coherent) {
  copy_batched(
      BB * p.P,
      [&](int idx) {
        const int r = idx / p.P, k = idx - r * p.P, b = b0 + r;
        if (b >= p.B || k >= p.H) return 0.0f;
        const T* q = src + static_cast<size_t>(b) * p.H + k;
        if constexpr (sizeof(T) == 4) {
          return coherent ? __ldcg(reinterpret_cast<const float*>(q)) : load_f(q);
        } else {
          return load_f(q);
        }
      },
      [&](int idx, float v) { h_s[idx] = v; });
}

// h_s[r * P + q * U + u] = shares[q, b0 + r, j0 + u]: every block q's
// share of dh for this block's units, rows b0.., zero past B and H.
template <int BB>
__device__ void stage_shares(float* h_s, const float* shares, int b0, const Plan& p, int nblk,
                             int j0) {
  const int per_row = nblk * p.U;
  const size_t BH = static_cast<size_t>(p.B) * p.H;
  copy_batched(
      BB * per_row,
      [&](int idx) {
        const int r = idx / per_row, rest = idx - r * per_row, q = rest / p.U;
        const int b = b0 + r, j = j0 + rest - q * p.U;
        return (b < p.B && j < p.H) ? __ldcg(shares + q * BH + static_cast<size_t>(b) * p.H + j)
                                    : 0.0f;
      },
      [&](int idx, float v) {
        const int r = idx / per_row;
        h_s[r * p.P + idx - r * per_row] = v;
      });
}

// The staged shares of (row r, unit u) summed over the blocks in order.
__device__ __forceinline__ float sum_shares(const float* h_s, int r, int u, const Plan& p,
                                            int nblk) {
  const float* q = h_s + r * p.P + u;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += q[k * p.U];
  return s;
}

// red[(r * 4U + col) * KS + ks] = the ks-th slice of sum_k h_s[r, k] w_s[col, k].
template <int BB>
__device__ void gate_dots(const float* w_s, const float* h_s, float* red, const Plan& p) {
  const int ncol = 4 * p.U;
  for (int item = threadIdx.x; item < ncol * p.KS; item += blockDim.x) {
    const int ks = item / ncol, col = item - ks * ncol;
    const int k0 = ks * p.Kc, k1 = min(k0 + p.Kc, p.P);
    float acc[BB];
#pragma unroll
    for (int r = 0; r < BB; ++r) acc[r] = 0.0f;
    const float* wp = w_s + col * p.P;
    for (int k = k0; k < k1; k += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wp + k);
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(h_s + r * p.P + k);
        acc[r] = fmaf(h4.x, w4.x, acc[r]);
        acc[r] = fmaf(h4.y, w4.y, acc[r]);
        acc[r] = fmaf(h4.z, w4.z, acc[r]);
        acc[r] = fmaf(h4.w, w4.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BB; ++r) red[(r * ncol + col) * p.KS + ks] = acc[r];
  }
}

// The four gate pre-activations of (row r of the chunk, unit u):
// xg + the slices of the dot product summed in order.
template <typename T>
__device__ __forceinline__ void gate_sums(const float* red, int r, int u, const Plan& p,
                                          const T* xg_row, int j, float out[4]) {
  const int ncol = 4 * p.U;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float* q = red + (r * ncol + g * p.U + u) * p.KS;
    float s = 0.0f;
    for (int ks = 0; ks < p.KS; ++ks) s += q[ks];
    out[g] = load_f(xg_row + g * p.H + j) + s;
  }
}

template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
    lstm_scan_fwd_kernel(const T* __restrict__ xg, const float* __restrict__ w_hh,
                         const float* __restrict__ h0, const float* __restrict__ c0,
                         T* __restrict__ ys, float* __restrict__ cs, float* hbuf, Plan p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + 4 * p.U * p.P;
  float* red = h_s + BB * p.P;
  const int H = p.H, B = p.B, U = p.U;
  const size_t BH = static_cast<size_t>(B) * H;
  const int j0 = blockIdx.x * U;
  load_weight(w_s, w_hh, p, j0);
  for (int t = 0; t < p.S; ++t) {
    const float* hsrc = t == 0 ? h0 : hbuf + (t & 1) * BH;
    float* hdst = hbuf + ((t + 1) & 1) * BH;
    for (int b0 = 0; b0 < B; b0 += BB) {
      __syncthreads();  // the weight is staged; h_s and red are free
      stage_rows<BB>(h_s, hsrc, b0, p, t > 0);
      __syncthreads();
      gate_dots<BB>(w_s, h_s, red, p);
      __syncthreads();
      const int nb = min(BB, B - b0);
      for (int item = threadIdx.x; item < nb * U; item += blockDim.x) {
        const int r = item / U, u = item - r * U, j = j0 + u, b = b0 + r;
        if (j >= H) continue;
        float gs[4];
        gate_sums(red, r, u, p, xg + (static_cast<size_t>(t) * B + b) * 4 * H, j, gs);
        const float i = sigmoid(gs[0]), f = sigmoid(gs[1] + 1.0f), g = tanhf(gs[2]),
                    o = sigmoid(gs[3]);
        const size_t bj = static_cast<size_t>(b) * H + j;
        const float c_prev = t == 0 ? c0[bj] : cs[(t - 1) * BH + bj];
        const float c_new = f * c_prev + i * g;
        const float h_new = o * tanhf(c_new);
        cs[t * BH + bj] = c_new;
        store_f(ys + t * BH + bj, h_new);
        hdst[bj] = h_new;
      }
    }
    grid.sync();  // h_t is published to every block
  }
}

template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
    lstm_scan_bwd_kernel(const T* __restrict__ xg, const float* __restrict__ w_hh,
                         const float* __restrict__ h0, const float* __restrict__ c0,
                         const T* __restrict__ ys, const float* __restrict__ cs,
                         const T* __restrict__ dys, const T* __restrict__ dhT,
                         const float* __restrict__ dcT, float* __restrict__ dxg,
                         float* __restrict__ dh0, float* __restrict__ dc0, float* pbuf, Plan p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int H = p.H, B = p.B, U = p.U, ncol = 4 * U;
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + ncol * p.P;
  float* red = h_s + BB * p.P;
  float* dg_s = red + BB * ncol * p.KS;  // (Bp, 4U) this step's dgates of the block's units
  float* dc_s = dg_s + p.Bp * ncol;      // (B, U) the dc carry of the block's units
  const size_t BH = static_cast<size_t>(B) * H;
  const int nblk = gridDim.x, j0 = blockIdx.x * U;
  load_weight(w_s, w_hh, p, j0);
  for (int idx = threadIdx.x; idx < p.Bp * ncol; idx += blockDim.x) dg_s[idx] = 0.0f;

  for (int t = p.S - 1; t >= 0; --t) {
    const float* shares_in = pbuf + static_cast<size_t>((t + 1) & 1) * nblk * BH;
    for (int b0 = 0; b0 < B; b0 += BB) {
      __syncthreads();
      if (t == 0) {
        stage_rows<BB>(h_s, h0, b0, p, false);
      } else {
        stage_rows<BB>(h_s, ys + (t - 1) * BH, b0, p, false);
      }
      __syncthreads();
      gate_dots<BB>(w_s, h_s, red, p);
      __syncthreads();
      if (t < p.S - 1) {  // h_s is free: stage the shares of dh from step t + 1
        stage_shares<BB>(h_s, shares_in, b0, p, nblk, j0);
        __syncthreads();
      }
      const int nb = min(BB, B - b0);
      for (int item = threadIdx.x; item < nb * U; item += blockDim.x) {
        const int r = item / U, u = item - r * U, j = j0 + u, b = b0 + r;
        if (j >= H) continue;
        float gs[4];
        gate_sums(red, r, u, p, xg + (static_cast<size_t>(t) * B + b) * 4 * H, j, gs);
        const float i = sigmoid(gs[0]), f = sigmoid(gs[1] + 1.0f), g = tanhf(gs[2]),
                    o = sigmoid(gs[3]);
        const size_t bj = static_cast<size_t>(b) * H + j;
        const float c_prev = t == 0 ? c0[bj] : cs[(t - 1) * BH + bj];
        const float tct = tanhf(f * c_prev + i * g);
        float dh_carry, dc_carry;
        if (t == p.S - 1) {
          dh_carry = load_f(dhT + bj);
          dc_carry = dcT[bj];
        } else {
          dh_carry = sum_shares(h_s, r, u, p, nblk);
          dc_carry = dc_s[b * U + u];
        }
        const float dh = dh_carry + load_f(dys + t * BH + bj);
        const float dc = dc_carry + dh * o * (1.0f - tct * tct);
        // same operation order as the Pallas backward
        const float dg[4] = {dc * g * i * (1.0f - i), dc * c_prev * f * (1.0f - f),
                             dc * i * (1.0f - g * g), dh * tct * o * (1.0f - o)};
        float* dxg_row = dxg + (static_cast<size_t>(t) * B + b) * 4 * H;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dxg_row[q * H + j] = dg[q];
          dg_s[b * ncol + q * U + u] = dg[q];
        }
        dc_s[b * U + u] = dc * f;
      }
    }
    __syncthreads();
    // this block's share of dh_prev[b, k] = sum over its columns of
    // dgates[b, col] * w_hh[k, col], for every k
    float* shares_out = pbuf + (static_cast<size_t>(t & 1) * nblk + blockIdx.x) * BH;
    const int chunks = p.Bp / BB;
    for (int item = threadIdx.x; item < chunks * H; item += blockDim.x) {
      const int c = item / H, k = item - c * H, b0 = c * BB;
      float acc[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[r] = 0.0f;
      for (int col = 0; col < ncol; col += 4) {
        const float w0 = w_s[col * p.P + k], w1 = w_s[(col + 1) * p.P + k],
                    w2 = w_s[(col + 2) * p.P + k], w3 = w_s[(col + 3) * p.P + k];
#pragma unroll
        for (int r = 0; r < BB; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dg_s + (b0 + r) * ncol + col);
          acc[r] = fmaf(d.x, w0, acc[r]);
          acc[r] = fmaf(d.y, w1, acc[r]);
          acc[r] = fmaf(d.z, w2, acc[r]);
          acc[r] = fmaf(d.w, w3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        if (b0 + r < B) shares_out[static_cast<size_t>(b0 + r) * H + k] = acc[r];
      }
    }
    grid.sync();  // every block's share of dh_prev is published
  }
  // dh0 = the shares of step 0 summed in block order; dc0 = the dc carry
  for (int b0 = 0; b0 < B; b0 += BB) {
    __syncthreads();
    stage_shares<BB>(h_s, pbuf, b0, p, nblk, j0);
    __syncthreads();
    for (int item = threadIdx.x; item < min(BB, B - b0) * U; item += blockDim.x) {
      const int r = item / U, u = item - r * U, j = j0 + u;
      if (j >= H) continue;
      const size_t bj = static_cast<size_t>(b0 + r) * H + j;
      dh0[bj] = sum_shares(h_s, r, u, p, nblk);
      dc0[bj] = dc_s[(b0 + r) * U + u];
    }
  }
}

// dw[m, c] = sum over n = t * B + b of h_prev[n, m] * dg[n, c], n in
// order; h_prev[n] = h0[b] for t = 0, ys[t - 1, b] after. A register-
// blocked SIMT product: a 64 (m) x 128 (c) tile of dw per block of 128
// threads, 8 x 8 outputs a thread (per row of n four 16-byte shared loads
// feed 64 FMAs), n staged in slabs of 16 rows through a 2-stage ring:
// slab s + 1's copies are in flight while slab s's FMAs run. Each output
// is one fmaf chain from 0 over n in order: rows past N are zeros, and
// fmaf(0, 0, acc) is acc (acc is never -0).
constexpr int kDwM = 64, kDwC = 128, kDwK = 16, kDwThreads = 128;
// 3 blocks an SM (up to 168 registers a thread): at the encoder (H = 1152)
// 18 x 36 = 648 blocks on 396 slots, 1.64 waves. Five an SM (96 registers,
// the 648 blocks in one wave) spill the accumulators and ran slower on the
// card (PERF.md).
constexpr int kDwBlocksPerSm = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// VEC: H % 4 == 0 and the pointers aligned, so every slab moves in runs of
// 4: 16-byte cp.async copies of fp32 rows, and 8-byte register loads of
// bf16 ys rows, widened into shared memory after the slab before's FMAs;
// otherwise one element a load, through registers.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kDwThreads, kDwBlocksPerSm)
    lstm_scan_dw_kernel(const float* __restrict__ h0, const T* __restrict__ ys,
                        const float* __restrict__ dg, float* __restrict__ dw, int S, int B,
                        int H) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kRunsA = kDwK * kDwM / 4 / kDwThreads, kRunsD = kDwK * kDwC / 4 / kDwThreads;
  __shared__ __align__(16) float a_s[2][kDwK][kDwM];
  __shared__ __align__(16) float d_s[2][kDwK][kDwC];
  const int N = S * B, H4 = 4 * H;
  const int m0 = blockIdx.y * kDwM, c0 = blockIdx.x * kDwC;
  // threads as (kDwM / 8) x (kDwC / 8): each takes rows ty*4 + {0..3} and
  // kDwM/2 + ty*4 + {0..3}, columns tx*4 + {0..3} and kDwC/2 + tx*4 + {0..3}
  static_assert((kDwM / 8) * (kDwC / 8) == kDwThreads, "one 8 x 8 block of dw a thread");
  const int tid = threadIdx.x, tx = tid % (kDwC / 8), ty = tid / (kDwC / 8);
  const int nslab = (N + kDwK - 1) / kDwK;
  uint2 a_bf16[kBf16 && VEC ? kRunsA : 1];  // the bf16 runs of the slab in flight

  // start slab s's loads into stage s % 2
  auto stage = [&](int s) {
    const int buf = s % 2;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < kRunsA; ++i) {  // A: kDwK x kDwM values in runs of 4
        const int u = tid + i * kDwThreads, r = u / (kDwM / 4), col = (u % (kDwM / 4)) * 4;
        const int n = s * kDwK + r, m = m0 + col;
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
        cp_async16(&a_s[buf][r][col], src, ok);
      }
#pragma unroll
      for (int i = 0; i < kRunsD; ++i) {  // D: kDwK x kDwC values in runs of 4
        const int u = tid + i * kDwThreads, r = u / (kDwC / 4), col = (u % (kDwC / 4)) * 4;
        const int n = s * kDwK + r, c = c0 + col;
        const bool ok = n < N && c < H4;
        cp_async16(&d_s[buf][r][col], ok ? dg + static_cast<size_t>(n) * H4 + c : dg, ok);
      }
    } else {
      float a[kDwK * kDwM / kDwThreads], d[kDwK * kDwC / kDwThreads];
#pragma unroll
      for (int i = 0; i < kDwK * kDwM / kDwThreads; ++i) {  // every load before the stores
        const int e = tid + i * kDwThreads, r = e / kDwM, m = m0 + e % kDwM, n = s * kDwK + r;
        a[i] = 0.0f;
        if (n < N && m < H) {
          a[i] = n < B ? h0[static_cast<size_t>(n) * H + m]
                       : load_f(ys + static_cast<size_t>(n - B) * H + m);
        }
      }
#pragma unroll
      for (int i = 0; i < kDwK * kDwC / kDwThreads; ++i) {
        const int e = tid + i * kDwThreads, r = e / kDwC, c = c0 + e % kDwC, n = s * kDwK + r;
        d[i] = n < N && c < H4 ? dg[static_cast<size_t>(n) * H4 + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kDwK * kDwM / kDwThreads; ++i) {
        const int e = tid + i * kDwThreads;
        a_s[buf][e / kDwM][e % kDwM] = a[i];
      }
#pragma unroll
      for (int i = 0; i < kDwK * kDwC / kDwThreads; ++i) {
        const int e = tid + i * kDwThreads;
        d_s[buf][e / kDwC][e % kDwC] = d[i];
      }
    }
  };
  // finish slab s's loads: this thread's copies landed, its bf16 runs
  // widened into the stage
  auto land = [&](int s) {
    cp_async_wait_all();
    if constexpr (kBf16 && VEC) {
#pragma unroll
      for (int i = 0; i < kRunsA; ++i) {
        const int u = tid + i * kDwThreads, r = u / (kDwM / 4), col = (u % (kDwM / 4)) * 4;
        const int n = s * kDwK + r;
        if (n < N && n >= B && m0 + col < H) {
          const uint2 w = a_bf16[i];
          // bf16 -> fp32 exactly: the 16 bits on top of a zero mantissa tail
          *reinterpret_cast<float4*>(&a_s[s % 2][r][col]) =
              make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                          __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
  }
  stage(0);
  land(0);
  __syncthreads();
  for (int s = 0; s < nslab; ++s) {
    const int cur = s % 2;
    if (s + 1 < nslab) stage(s + 1);
#pragma unroll
    for (int kk = 0; kk < kDwK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[cur][kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[cur][kk][kDwM / 2 + ty * 4]);
      const float4 d_lo = *reinterpret_cast<const float4*>(&d_s[cur][kk][tx * 4]);
      const float4 d_hi = *reinterpret_cast<const float4*>(&d_s[cur][kk][kDwC / 2 + tx * 4]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float dv[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w, d_hi.x, d_hi.y, d_hi.z, d_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], dv[q], acc[i][q]);
      }
    }
    if (s + 1 < nslab) land(s + 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : kDwM / 2 + ty * 4 + i - 4);
    if (m >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + half * (kDwC / 2) + tx * 4;
      float* row = dw + static_cast<size_t>(m) * H4;
      if constexpr (VEC) {
        if (c < H4) {  // H4 % 4 == 0: a run of 4 is all in or all out
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                          acc[i][half * 4 + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < H4) row[c + q] = acc[i][half * 4 + q];
        }
      }
    }
  }
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
  p.KS = std::max(1, std::min(kThreads / (4 * U), p.P / 4));
  p.Kc = ((p.P + p.KS - 1) / p.KS + 3) / 4 * 4;
  p.Bp = (B + BB - 1) / BB * BB;
  return p;
}

inline size_t smem_bytes(const Plan& p, int BB, bool bwd) {
  size_t floats = static_cast<size_t>(4 * p.U) * p.P + static_cast<size_t>(BB) * p.P +
                  static_cast<size_t>(BB) * 4 * p.U * p.KS;
  if (bwd) floats += static_cast<size_t>(p.Bp) * 4 * p.U + static_cast<size_t>(p.B) * p.U;
  return floats * sizeof(float);
}

inline int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// The staging chunk: 4 rows for B <= 4, else 8 where shared memory holds
// them, else 4. 0 when not even 4 fit.
inline int pick_bb(int S, int B, int H, int U, bool bwd) {
  const size_t limit = static_cast<size_t>(max_smem());
  if (B > 4 && smem_bytes(make_plan(S, B, H, U, 8), 8, bwd) <= limit) return 8;
  return smem_bytes(make_plan(S, B, H, U, 4), 4, bwd) <= limit ? 4 : 0;
}

// Opt in to the shared memory, check that the grid can be co-resident,
// and launch cooperatively.
int coop_launch(const void* kernel, int grid, size_t smem, void** args, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(per_sm) * sms < grid) return kErrNotResident;
  err = cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* xg, const void* w_hh, const void* h0, const void* c0, void* ys,
               void* cs, void* hbuf, int S, int B, int H, int U, cudaStream_t stream) {
  const int bb = pick_bb(S, B, H, U, false);
  if (bb == 0) return kErrSharedMemory;
  Plan p = make_plan(S, B, H, U, bb);
  const T* xg_p = static_cast<const T*>(xg);
  const float* w_p = static_cast<const float*>(w_hh);
  const float* h0_p = static_cast<const float*>(h0);
  const float* c0_p = static_cast<const float*>(c0);
  T* ys_p = static_cast<T*>(ys);
  float* cs_p = static_cast<float*>(cs);
  float* hb_p = static_cast<float*>(hbuf);
  void* args[] = {&xg_p, &w_p, &h0_p, &c0_p, &ys_p, &cs_p, &hb_p, &p};
  const void* kernel = bb == 8 ? reinterpret_cast<const void*>(&lstm_scan_fwd_kernel<T, 8>)
                               : reinterpret_cast<const void*>(&lstm_scan_fwd_kernel<T, 4>);
  return coop_launch(kernel, (H + U - 1) / U, smem_bytes(p, bb, false), args, stream);
}

template <typename T>
int launch_bwd(const void* xg, const void* w_hh, const void* h0, const void* c0, const void* ys,
               const void* cs, const void* dys, const void* dhT, const void* dcT, void* dxg,
               void* dh0, void* dc0, void* pbuf, int S, int B, int H, int U,
               cudaStream_t stream) {
  const int bb = pick_bb(S, B, H, U, true);
  if (bb == 0) return kErrSharedMemory;
  Plan p = make_plan(S, B, H, U, bb);
  const T* xg_p = static_cast<const T*>(xg);
  const float* w_p = static_cast<const float*>(w_hh);
  const float* h0_p = static_cast<const float*>(h0);
  const float* c0_p = static_cast<const float*>(c0);
  const T* ys_p = static_cast<const T*>(ys);
  const float* cs_p = static_cast<const float*>(cs);
  const T* dys_p = static_cast<const T*>(dys);
  const T* dhT_p = static_cast<const T*>(dhT);
  const float* dcT_p = static_cast<const float*>(dcT);
  float* dxg_p = static_cast<float*>(dxg);
  float* dh0_p = static_cast<float*>(dh0);
  float* dc0_p = static_cast<float*>(dc0);
  float* pb_p = static_cast<float*>(pbuf);
  void* args[] = {&xg_p,  &w_p,   &h0_p,  &c0_p,  &ys_p,  &cs_p, &dys_p,
                  &dhT_p, &dcT_p, &dxg_p, &dh0_p, &dc0_p, &pb_p, &p};
  const void* kernel = bb == 8 ? reinterpret_cast<const void*>(&lstm_scan_bwd_kernel<T, 8>)
                               : reinterpret_cast<const void*>(&lstm_scan_bwd_kernel<T, 4>);
  return coop_launch(kernel, (H + U - 1) / U, smem_bytes(p, bb, true), args, stream);
}

template <typename T>
int launch_dw(const void* h0, const void* ys, const void* dgates, void* dw, int S, int B, int H,
              cudaStream_t stream) {
  const auto aligned = [](const void* p, unsigned bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = H % 4 == 0 && aligned(h0, 16) && aligned(ys, 4 * sizeof(T)) &&
                   aligned(dgates, 16) && aligned(dw, 16);
  const dim3 grid((4 * H + kDwC - 1) / kDwC, (H + kDwM - 1) / kDwM);
  const float* h0_p = static_cast<const float*>(h0);
  const T* ys_p = static_cast<const T*>(ys);
  const float* dg_p = static_cast<const float*>(dgates);
  float* dw_p = static_cast<float*>(dw);
  if (vec) {
    lstm_scan_dw_kernel<T, true><<<grid, kDwThreads, 0, stream>>>(h0_p, ys_p, dg_p, dw_p, S, B, H);
  } else {
    lstm_scan_dw_kernel<T, false><<<grid, kDwThreads, 0, stream>>>(h0_p, ys_p, dg_p, dw_p, S, B,
                                                                   H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 xg/ys/dys/dhT, 1 = bfloat16. w_hh, h0, c0, cs, dcT
// and every gradient are float32. U is the number of hidden units per
// block; the grid is ceil(H / U) blocks, all resident at once. hbuf is
// (2, B, H) float32 scratch, pbuf (2, ceil(H / U), B, H). Returns a
// cudaError_t as int (0 = success), -1 when the weight slice does not fit
// shared memory, -2 when the grid cannot be co-resident.
extern "C" int lstm_scan_fwd(int dtype, const void* xg, const void* w_hh, const void* h0,
                             const void* c0, void* ys, void* cs, void* hbuf, int S, int B,
                             int H, int U, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || U <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(xg, w_hh, h0, c0, ys, cs, hbuf, S, B, H, U, s);
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(xg, w_hh, h0, c0, ys, cs, hbuf, S, B, H, U, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int lstm_scan_bwd(int dtype, const void* xg, const void* w_hh, const void* h0,
                             const void* c0, const void* ys, const void* cs, const void* dys,
                             const void* dhT, const void* dcT, void* dxg, void* dh0, void* dc0,
                             void* pbuf, int S, int B, int H, int U, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0 || U <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT, dxg, dh0, dc0, pbuf, S,
                             B, H, U, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT, dxg, dh0, dc0,
                                     pbuf, S, B, H, U, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kDwThreads, 0));
}
