// K3 in one launch without scratch: the design the port measured against
// its three-launch forward (csrc/rnnt_joint.cu) and did not take, built
// and run only by tools/k3_k8_parent_ab.py. One block of 128 threads a
// 64-point lattice tile (132 blocks at the paper width, one an SM) walks
// the 128-column vocab tiles in order: the shared tile product
// (src/repro_torch/kernels/csrc/tile_product.cuh) computes the logits
// tile from h, made from e and g as it is loaded, and W; then each warp
// takes 16 of the rows through the three-launch forward's log-sum-exp
// step in its order. It gives that forward's bits with no (N x V) logits
// and no h in device memory, and its 4 warps an SM leave the products
// latency-bound (PERF.md).
//
//   nvcc <the port's NVCC_FLAGS> -I src/repro_torch/kernels/csrc -o k3_noscratch.so tools/k3_noscratch.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <cstdint>

#include "tile_product.cuh"

namespace {

constexpr int kTV = 128;  // the log-sum-exp's vocab slab

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Lattice {
  long long N;  // B·T·U1
  int T, U1, J, V;
};

// A slab of h computed where it is loaded: s[kk][x] = tanh(e[b, t, k0 + kk]
// + g[b, u, k0 + kk]) for lattice point m0 + x = (b, t, u), zero past J
// and N; tile::ColSlab's thread layout, the values csrc/rnnt_joint.cu's
// joint_h_kernel writes.
template <typename T>
struct HSlab {
  static constexpr int kRuns = tile::ColSlab<tile::kM, false>::kRuns;
  float r[kRuns][4];
  const T* er[kRuns];  // e's and g's rows of each run's lattice point, or null
  const T* gr[kRuns];
  __device__ __forceinline__ HSlab(const Lattice& L, const T* e, const T* g, long long m0) {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const long long n = m0 + tile::ColSlab<tile::kM, false>::x(i);
      er[i] = gr[i] = nullptr;
      if (n < L.N) {
        const long long bt = n / L.U1, b = bt / L.T, u = n - bt * L.U1;
        er[i] = e + bt * L.J;
        gr[i] = g + (b * L.U1 + u) * L.J;
      }
    }
  }
  __device__ __forceinline__ void stage(int k0, int J) {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const int k = k0 + tile::ColSlab<tile::kM, false>::kq(i);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[i][q] = er[i] != nullptr && k + q < J ? tanhf(to_f(er[i][k + q]) + to_f(gr[i][k + q]))
                                                 : 0.f;
    }
  }
  __device__ __forceinline__ void land(tile::ASlab& s) const {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[tile::ColSlab<tile::kM, false>::kq(i) + q][tile::ColSlab<tile::kM, false>::x(i)] =
            r[i][q];
    }
  }
};

// Row stride of the shared logits tile: 16-byte rows
constexpr int kFusedStride = tile::kC + 4;

// blank, label and lse of the 64 lattice points of a block, with no
// scratch: for each vocab tile in order the tile product computes the
// logits tile from h (made by HSlab as it is loaded) and W, adds the bias
// and leaves it in shared memory; then each warp takes 16 of the rows
// through csrc/rnnt_joint.cu's joint_lse_kernel step for that slab, the
// running max and sum in shared memory. The same roundings in the same
// order: that kernel's bits. One block an SM (132 at the paper width: one
// wave).
template <typename T, bool VEC>
__global__ void __launch_bounds__(tile::kThreads, 1)
    joint_fwd_fused_kernel(Lattice L, const T* __restrict__ e, const T* __restrict__ g,
                           const float* __restrict__ w, const float* __restrict__ bias,
                           const int* __restrict__ labels, float* __restrict__ blank_out,
                           float* __restrict__ label_out, float* __restrict__ lse_out) {
  extern __shared__ __align__(16) float lg_s[];  // tile::kM x kFusedStride
  __shared__ float m_s[tile::kM], l_s[tile::kM], blk_s[tile::kM], lab_s[tile::kM];
  __shared__ int lbl_s[tile::kM];
  constexpr int kRowsPerWarp = tile::kM / (tile::kThreads / 32);
  const int tx = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * tile::kM;
  for (int r = threadIdx.x; r < tile::kM; r += tile::kThreads) {
    const long long n = m0 + r;
    m_s[r] = -INFINITY;
    l_s[r] = blk_s[r] = lab_s[r] = 0.f;
    lbl_s[r] = -1;
    if (n < L.N) {
      const long long bt = n / L.U1, b = bt / L.T, u = n - bt * L.U1;
      lbl_s[r] = labels[b * L.U1 + u];
    }
  }
  HSlab<T> a(L, e, g, m0);
  tile::RowSlab<tile::kC, VEC> bw;
  const int nslab = (L.J + tile::kK - 1) / tile::kK;
  for (int c0 = 0; c0 < L.V; c0 += tile::kC) {
    float acc[8][8];
    tile::mainloop<0>(
        [&](tile::ASlab&, tile::BSlab& bs, int s) {
          a.stage(s * tile::kK, L.J);
          bw.stage(bs, w, L.V, s * tile::kK, L.J, c0, L.V);
        },
        [&](tile::ASlab& as, tile::BSlab&, int) { a.land(as); }, tile::NoSlabHook(), nslab,
        acc, nullptr);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int v = c0 + tile::col(q);
      const float bv = v < L.V ? bias[v] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        lg_s[tile::row(i) * kFusedStride + tile::col(q)] = __fadd_rn(acc[i][q], bv);
    }
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float* row = lg_s + r * kFusedStride;
      for (int v0 = 0; v0 < tile::kC && c0 + v0 < L.V; v0 += kTV) {
        float lg[kTV / 32], mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < kTV / 32; ++c) {
          const int v = c0 + v0 + tx + 32 * c;
          lg[c] = v < L.V ? row[v0 + tx + 32 * c] : -INFINITY;
          mx = fmaxf(mx, lg[c]);
        }
        const float m_run = m_s[r];
        const float nm = fmaxf(m_run, warp_max(mx));
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kTV / 32; ++c) s = __fadd_rn(s, expf(__fsub_rn(lg[c], nm)));
        const float l_new = fmaf(l_s[r], expf(__fsub_rn(m_run, nm)), warp_sum(s));
        __syncwarp();
        if (tx == 0) {
          m_s[r] = nm;
          l_s[r] = l_new;
        }
        __syncwarp();
      }
      if (tx == 0) {
        if (c0 == 0) blk_s[r] = row[0];
        const int label = lbl_s[r];
        if (label >= c0 && label < c0 + tile::kC && label < L.V) lab_s[r] = row[label - c0];
      }
    }
    __syncthreads();  // the tile is read; the next one may overwrite it
  }
  for (int r = threadIdx.x; r < tile::kM; r += tile::kThreads) {
    const long long n = m0 + r;
    if (n < L.N) {
      const float s = __fadd_rn(m_s[r], logf(fmaxf(l_s[r], 1e-30f)));
      blank_out[n] = __fsub_rn(blk_s[r], s);
      label_out[n] = __fsub_rn(lab_s[r], s);
      lse_out[n] = s;
    }
  }
}

// One launch in the VEC or element-wise route, its dynamic shared memory
// allowed first.
template <typename KVec, typename KElem, typename... Args>
cudaError_t launch_product(KVec kvec, KElem kelem, bool vec, dim3 grid, size_t smem,
                           cudaStream_t s, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      vec ? kvec : kelem, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (vec) {
    kvec<<<grid, tile::kThreads, smem, s>>>(args...);
  } else {
    kelem<<<grid, tile::kThreads, smem, s>>>(args...);
  }
  return cudaGetLastError();
}

}  // namespace

// blank, label and lse (B, T, U1) float32 from e, g, w, b and the labels
// in one launch without scratch (joint_fwd_fused_kernel). dtype: 0 =
// float32 e and g, 1 = bfloat16; the rest as csrc/rnnt_joint.cu's entry
// points take them. Returns a cudaError_t as int.
extern "C" int rnnt_joint_fwd_fused(int dtype, const void* e, const void* g, const void* w,
                                    const void* b, const void* labels, void* blank,
                                    void* label, void* lse, int B, int T, int U1, int J, int V,
                                    void* stream) {
  if (B <= 0 || T <= 0 || U1 <= 0 || J <= 0 || V <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Lattice L{static_cast<long long>(B) * T * U1, T, U1, J, V};
  const bool vec = V % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t smem = sizeof(float) * tile::kM * kFusedStride;
  const dim3 grid(static_cast<unsigned>((L.N + tile::kM - 1) / tile::kM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const int* lp = static_cast<const int*>(labels);
  float* o0 = static_cast<float*>(blank);
  float* o1 = static_cast<float*>(label);
  float* o2 = static_cast<float*>(lse);
  if (dtype == 0) {
    const float* ep = static_cast<const float*>(e);
    const float* gp = static_cast<const float*>(g);
    return static_cast<int>(launch_product(
        joint_fwd_fused_kernel<float, true>, joint_fwd_fused_kernel<float, false>, vec, grid,
        smem, s, L, ep, gp, wp, bp, lp, o0, o1, o2));
  }
  const __nv_bfloat16* ep = static_cast<const __nv_bfloat16*>(e);
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
  return static_cast<int>(launch_product(
      joint_fwd_fused_kernel<__nv_bfloat16, true>, joint_fwd_fused_kernel<__nv_bfloat16, false>,
      vec, grid, smem, s, L, ep, gp, wp, bp, lp, o0, o1, o2));
}

