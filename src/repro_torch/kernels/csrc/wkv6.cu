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
// backward replays each chunk from its checkpoint into a scratch of
// (B, H, chunk, P, P) and walks it back.
//
// Design: one block per (b, h), P threads. In the forward thread j holds
// column j of S in registers, so y_t[j] is a sum over i in the thread, in
// the reference's order of products; r_t, k_t and w_t are staged in shared
// memory a step at a time (the next step's loads issued before the
// current step's arithmetic). In the backward thread i holds row i of the
// state and of its cotangent G, so dr, dk, dw and du are sums in the
// thread; dv (a sum over rows) goes through a padded shared tile, summed
// over rows in a fixed order. du's per-(b, h) sums are added over b in
// order by a second launch: no atomics, the same bits for the same inputs.
//
// Bound on the card: the bytes (each input read once, each output written
// once; the state is tiny), a few MB a layer; the work is 4 P^2 flops a
// step per (b, h). At B·H = 128 blocks of 64 threads the kernel is bound
// by each step's latency (shared-memory round trips and two barriers),
// not by either: a faster design splits the state's columns over more
// threads and blocks.

#include <cuda_runtime.h>

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

template <int P>
__global__ void __launch_bounds__(P) wkv6_bwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ ckpt,
    const float* __restrict__ dy, const float* __restrict__ dST, float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du_rows, float* __restrict__ dS0, float* __restrict__ scratch,
    int S, int H, int chunk) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int n_ck = (S + chunk - 1) / chunk;
  __shared__ float sv[P], sdy[P], srku[P];
  __shared__ float tile[P][P + 1];  // tile[i][j] = G[i][j] k[i]; padded: no bank conflicts
  float g[P], s[P];
  const float ui = u[h * P + i];
#pragma unroll
  for (int j = 0; j < P; ++j) g[j] = dST ? dST[((size_t)bh * P + i) * P + j] : 0.f;
  float du_acc = 0.f;
  float* scr = scratch + (size_t)bh * chunk * P * P;
  const size_t step = (size_t)H * P;
  const size_t base = ((size_t)b * S * H + h) * P + i;  // element i of (b, t = 0, h)
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * chunk, t1 = min(S, t0 + chunk);
    // replay the chunk from its checkpoint: S_{t-1}'s row i into the
    // scratch, transposed so that a step's stores are coalesced
    const float* ck = ckpt + (((size_t)bh * n_ck + c) * P + i) * P;
#pragma unroll
    for (int j = 0; j < P; ++j) s[j] = ck[j];
    for (int t = t0; t < t1; ++t) {
      const size_t off = base + (size_t)t * step;
      float* row = scr + (size_t)(t - t0) * P * P + i;
#pragma unroll
      for (int j = 0; j < P; ++j) row[j * P] = s[j];
      __syncthreads();
      sv[i] = v[off];
      __syncthreads();
      const float wi = w[off], ki = k[off];
#pragma unroll
      for (int j = 0; j < P; ++j) s[j] = wi * s[j] + ki * sv[j];
    }
    // walk the chunk back
    for (int t = t1 - 1; t >= t0; --t) {
      const size_t off = base + (size_t)t * step;
      const float ri = r[off], ki = k[off], wi = w[off];
      __syncthreads();
      sv[i] = v[off];
      sdy[i] = dy[off];
      srku[i] = ri * ui * ki;
      __syncthreads();
      const float* row = scr + (size_t)(t - t0) * P * P + i;
#pragma unroll
      for (int j = 0; j < P; ++j) s[j] = row[j * P];
      float dyv = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) dyv += sdy[j] * sv[j];
      float dri = 0.f, dki = 0.f, dwi = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float kv = ki * sv[j];
        dri += (s[j] + ui * kv) * sdy[j];
        dki += g[j] * sv[j];
        dwi += g[j] * s[j];
        tile[i][j] = g[j] * ki;
      }
      dki += ri * ui * dyv;
      du_acc += ri * ki * dyv;
      __syncthreads();
      // thread i as column i: dv[i] = sum over rows q of G[q][i] k[q], plus
      // (sum_q r u k) dy[i]
      float dvi = 0.f, rku = 0.f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        dvi += tile[q][i];
        rku += srku[q];
      }
      dvi += rku * sdy[i];
#pragma unroll
      for (int j = 0; j < P; ++j) g[j] = wi * g[j] + ri * sdy[j];
      dr[off] = dri;
      dk[off] = dki;
      dv[off] = dvi;
      dw[off] = dwi;
    }
  }
  if (dS0) {
#pragma unroll
    for (int j = 0; j < P; ++j) dS0[((size_t)bh * P + i) * P + j] = g[j];
  }
  du_rows[(size_t)bh * P + i] = du_acc;
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
cudaError_t launch_bwd(const float* r, const float* k, const float* v, const float* w,
                       const float* u, const float* ckpt, const float* dy, const float* dST,
                       float* dr, float* dk, float* dv, float* dw, float* du_rows, float* du,
                       float* dS0, float* scratch, int B, int S, int H, int chunk,
                       cudaStream_t stream) {
  wkv6_bwd_kernel<P><<<B * H, P, 0, stream>>>(r, k, v, w, u, ckpt, dy, dST, dr, dk, dv, dw,
                                              du_rows, dS0, scratch, S, H, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_du_sum_kernel<<<H, P, 0, stream>>>(du_rows, du, B, H, P);
  return cudaGetLastError();
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
// then du (H, P). dST null is a zero cotangent; scratch holds
// B·H·chunk·P·P floats.
int wkv6_bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* ckpt, const float* dy, const float* dST, float* dr, float* dk,
             float* dv, float* dw, float* du_rows, float* du, float* dS0, float* scratch,
             int B, int S, int H, int P, int chunk, cudaStream_t stream) {
  switch (P) {
    case 16: return launch_bwd<16>(r, k, v, w, u, ckpt, dy, dST, dr, dk, dv, dw, du_rows, du,
                                   dS0, scratch, B, S, H, chunk, stream);
    case 32: return launch_bwd<32>(r, k, v, w, u, ckpt, dy, dST, dr, dk, dv, dw, du_rows, du,
                                   dS0, scratch, B, S, H, chunk, stream);
    case 64: return launch_bwd<64>(r, k, v, w, u, ckpt, dy, dST, dr, dk, dv, dw, du_rows, du,
                                   dS0, scratch, B, S, H, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
