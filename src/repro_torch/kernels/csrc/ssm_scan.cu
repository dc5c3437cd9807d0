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
// steps (the checkpoints, (B, H, n, P, N)) when asked; the backward replays
// each chunk from its checkpoint into a scratch of (B, H, chunk, P, N) and
// walks it back.
//
// Design: one block per (b, h). The forward has P threads, thread p holding
// row p of h in registers: y_t[p] is a sum over n in the thread, B_t and C_t
// staged in shared memory. The backward has N threads, thread n holding
// column n of h and of its cotangent G: dB and dC for the head are sums in
// the thread, written per head and added over the heads in order by a second
// launch (no atomics); s = G B_t (a sum over columns) goes through a padded
// shared tile, summed in a fixed order, and gives dx and ddt; da and ddt are
// summed over the block's threads by thread 0 in order.
//
// Bound on the card: the bytes (each input read once, each output written
// once), a few tens of MB a layer at zamba2's width; the work is about
// 4 P N flops a step per (b, h) forward. As K12, each step's latency (the
// staged vectors, two to four barriers) bounds this simple design.

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void ssm_scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                                    const float* __restrict__ a, const float* __restrict__ Bm,
                                    const float* __restrict__ Cm, const float* __restrict__ h0,
                                    float* __restrict__ y, float* __restrict__ hT,
                                    float* __restrict__ ckpt, int S, int H, int P, int chunk) {
  const int bh = blockIdx.x, b = bh / H, hd = bh % H, p = threadIdx.x;
  const int n_ck = (S + chunk - 1) / chunk;
  __shared__ float sB[N], sC[N];
  float hs[N];
  const float* h0row = h0 ? h0 + ((size_t)bh * P + p) * N : nullptr;
#pragma unroll
  for (int n = 0; n < N; ++n) hs[n] = h0row ? h0row[n] : 0.f;
  for (int t = 0; t < S; ++t) {
    if (ckpt && t % chunk == 0) {
      float* c = ckpt + (((size_t)bh * n_ck + t / chunk) * P + p) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) c[n] = hs[n];
    }
    const size_t bt = (size_t)b * S + t, o = bt * H + hd;
    __syncthreads();  // the last step's reads of sB and sC are done
    for (int q = p; q < N; q += P) {
      sB[q] = Bm[bt * N + q];
      sC[q] = Cm[bt * N + q];
    }
    __syncthreads();
    const float at = a[o];
    const float xs = dt[o] * x[o * P + p];
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      hs[n] = hs[n] * at + xs * sB[n];
      acc += hs[n] * sC[n];
    }
    y[o * P + p] = acc;
  }
  float* hrow = hT + ((size_t)bh * P + p) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) hrow[n] = hs[n];
}

template <int P>
__global__ void ssm_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ ckpt,
    const float* __restrict__ dy, const float* __restrict__ dhT, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ da, float* __restrict__ dB_heads,
    float* __restrict__ dC_heads, float* __restrict__ dh0, float* __restrict__ scratch,
    int S, int H, int N, int chunk) {
  const int bh = blockIdx.x, b = bh / H, hd = bh % H, n = threadIdx.x;
  const int n_ck = (S + chunk - 1) / chunk;
  extern __shared__ float smem[];
  float* sx = smem;              // x_t (P)
  float* sdy = sx + P;           // dy_t (P)
  float* ss = sdy + P;           // x_t[q] s[q] (P)
  float* red = ss + P;           // each thread's part of da (N)
  float* tile = red + N;         // tile[n][q] = G[q][n] B_t[n], rows P + 1 apart
  float g[P], hp[P];
#pragma unroll
  for (int q = 0; q < P; ++q) g[q] = dhT ? dhT[((size_t)bh * P + q) * N + n] : 0.f;
  float* scr = scratch + (size_t)bh * chunk * P * N + n;
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * chunk, t1 = min(S, t0 + chunk);
    const float* ck = ckpt + ((size_t)bh * n_ck + c) * P * N + n;
#pragma unroll
    for (int q = 0; q < P; ++q) hp[q] = ck[(size_t)q * N];
    for (int t = t0; t < t1; ++t) {  // replay: h_{t-1}'s column n into the scratch
      const size_t bt = (size_t)b * S + t, o = bt * H + hd;
      float* col = scr + (size_t)(t - t0) * P * N;
#pragma unroll
      for (int q = 0; q < P; ++q) col[(size_t)q * N] = hp[q];
      __syncthreads();
      for (int q = n; q < P; q += N) sx[q] = x[o * P + q];
      __syncthreads();
      const float at = a[o], dtt = dt[o], Bn = Bm[bt * N + n];
#pragma unroll
      for (int q = 0; q < P; ++q) hp[q] = hp[q] * at + (dtt * sx[q]) * Bn;
    }
    for (int t = t1 - 1; t >= t0; --t) {  // walk the chunk back
      const size_t bt = (size_t)b * S + t, o = bt * H + hd;
      __syncthreads();
      for (int q = n; q < P; q += N) {
        sx[q] = x[o * P + q];
        sdy[q] = dy[o * P + q];
      }
      __syncthreads();
      const float at = a[o], dtt = dt[o], Bn = Bm[bt * N + n], Cn = Cm[bt * N + n];
      const float* col = scr + (size_t)(t - t0) * P * N;
#pragma unroll
      for (int q = 0; q < P; ++q) hp[q] = col[(size_t)q * N];
      float dC = 0.f, dBn = 0.f, dan = 0.f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float xs = dtt * sx[q];
        const float cur = hp[q] * at + xs * Bn;  // h_t, as the forward computed it
        dC += cur * sdy[q];
        g[q] += sdy[q] * Cn;
        dBn += g[q] * xs;
        dan += g[q] * hp[q];
        tile[n * (P + 1) + q] = g[q] * Bn;
      }
      dB_heads[o * N + n] = dBn;
      dC_heads[o * N + n] = dC;
      red[n] = dan;
      __syncthreads();
      for (int q = n; q < P; q += N) {  // s[q] = sum over columns m of G[q][m] B_t[m]
        float sq = 0.f;
        for (int m = 0; m < N; ++m) sq += tile[m * (P + 1) + q];
        dx[o * P + q] = dtt * sq;
        ss[q] = sx[q] * sq;
      }
      __syncthreads();
      if (n == 0) {
        float dd = 0.f, aa = 0.f;
        for (int q = 0; q < P; ++q) dd += ss[q];
        for (int m = 0; m < N; ++m) aa += red[m];
        ddt[o] = dd;
        da[o] = aa;
      }
#pragma unroll
      for (int q = 0; q < P; ++q) g[q] *= at;
    }
  }
  if (dh0) {
#pragma unroll
    for (int q = 0; q < P; ++q) dh0[((size_t)bh * P + q) * N + n] = g[q];
  }
}

// dB, dC (B, S, N) = the per-head parts (B, S, H, N) added over h = 0, 1, ...
// in order; one block a (b, t)
__global__ void ssm_scan_bc_sum_kernel(const float* __restrict__ dB_heads,
                                       const float* __restrict__ dC_heads,
                                       float* __restrict__ dB, float* __restrict__ dC,
                                       int H, int N) {
  const size_t bt = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float* pb = dB_heads + bt * H * N + n;
    const float* pc = dC_heads + bt * H * N + n;
    float sb = pb[0], sc = pc[0];
    for (int h = 1; h < H; ++h) {
      sb += pb[(size_t)h * N];
      sc += pc[(size_t)h * N];
    }
    dB[bt * N + n] = sb;
    dC[bt * N + n] = sc;
  }
}

template <int N>
cudaError_t launch_fwd(const float* x, const float* dt, const float* a, const float* Bm,
                       const float* Cm, const float* h0, float* y, float* hT, float* ckpt,
                       int B, int S, int H, int P, int chunk, cudaStream_t stream) {
  ssm_scan_fwd_kernel<N><<<B * H, P, 0, stream>>>(x, dt, a, Bm, Cm, h0, y, hT, ckpt, S, H, P,
                                                  chunk);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_bwd(const float* x, const float* dt, const float* a, const float* Bm,
                       const float* Cm, const float* ckpt, const float* dy, const float* dhT,
                       float* dx, float* ddt, float* da, float* dB_heads, float* dC_heads,
                       float* dB, float* dC, float* dh0, float* scratch, int B, int S, int H,
                       int N, int chunk, cudaStream_t stream) {
  const size_t smem = (3 * P + N + (size_t)N * (P + 1)) * sizeof(float);
  ssm_scan_bwd_kernel<P><<<B * H, N, smem, stream>>>(x, dt, a, Bm, Cm, ckpt, dy, dhT, dx, ddt,
                                                     da, dB_heads, dC_heads, dh0, scratch, S,
                                                     H, N, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssm_scan_bc_sum_kernel<<<B * S, N, 0, stream>>>(dB_heads, dC_heads, dB, dC, H, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch: y (B, S, H, P), h_T (B, H, P, N) and, when ckpt is not null,
// the checkpoints (B, H, ceil(S / chunk), P, N). h0 null is a zero state.
// N is 16, 32 or 64; P at most 1024.
int ssm_scan_fwd(const float* x, const float* dt, const float* a, const float* Bm,
                 const float* Cm, const float* h0, float* y, float* hT, float* ckpt, int B,
                 int S, int H, int P, int N, int chunk, cudaStream_t stream) {
  switch (N) {
    case 16: return launch_fwd<16>(x, dt, a, Bm, Cm, h0, y, hT, ckpt, B, S, H, P, chunk, stream);
    case 32: return launch_fwd<32>(x, dt, a, Bm, Cm, h0, y, hT, ckpt, B, S, H, P, chunk, stream);
    case 64: return launch_fwd<64>(x, dt, a, Bm, Cm, h0, y, hT, ckpt, B, S, H, P, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Two launches: the recurrence backward (dx (B, S, H, P), ddt and da
// (B, S, H), the per-head dB and dC parts (B, S, H, N), dh0 when not
// null), then dB and dC (B, S, N). dhT null is a zero cotangent; scratch
// holds B·H·chunk·P·N floats. P is 16, 32 or 64; N at most 1024.
int ssm_scan_bwd(const float* x, const float* dt, const float* a, const float* Bm,
                 const float* Cm, const float* ckpt, const float* dy, const float* dhT,
                 float* dx, float* ddt, float* da, float* dB_heads, float* dC_heads, float* dB,
                 float* dC, float* dh0, float* scratch, int B, int S, int H, int P, int N,
                 int chunk, cudaStream_t stream) {
  switch (P) {
    case 16: return launch_bwd<16>(x, dt, a, Bm, Cm, ckpt, dy, dhT, dx, ddt, da, dB_heads,
                                   dC_heads, dB, dC, dh0, scratch, B, S, H, N, chunk, stream);
    case 32: return launch_bwd<32>(x, dt, a, Bm, Cm, ckpt, dy, dhT, dx, ddt, da, dB_heads,
                                   dC_heads, dB, dC, dh0, scratch, B, S, H, N, chunk, stream);
    case 64: return launch_bwd<64>(x, dt, a, Bm, Cm, ckpt, dy, dhT, dx, ddt, da, dB_heads,
                                   dC_heads, dB, dC, dh0, scratch, B, S, H, N, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
