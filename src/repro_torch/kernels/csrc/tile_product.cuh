// The register-blocked fp32 tile product shared by csrc/lstm_scan.cu
// (K2's gate recompute and dw_hh product) and csrc/rnnt_joint.cu (K3's
// logits and K4's three products). build.py hashes this header into every
// library.
//
// out[m, c] = the sum over k, in order, of A[m, k] * B[k, c], for a kM (m)
// x kC (c) tile a block of kThreads threads, 8 x 8 outputs a thread (per k
// four 16-byte shared loads feed 64 FMAs). k runs in slabs of kK through a
// 2-stage ring of shared memory: slab s + 1's loads are in flight while
// slab s's FMAs run. The caller brings the loaders of both operands (the
// slab types below serve operands that lie in rows along k, RowSlab, or
// across them, ColSlab) and the epilogue: the main loop leaves the sums in
// registers. Each output is one fmaf chain from 0 over k in order, or, with
// kChunk, one chain for each run of kChunk slabs, added into a running sum
// in shared memory when the run ends, in run order. Operands past the
// edges are zeros, and fmaf(0, 0, acc) is acc (acc is never -0), so the
// bits do not depend on the tiling. The products are fp32 FMA on the CUDA
// cores: TF32 or bf16 tensor cores would change the numbers.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace tile {

constexpr int kM = 64, kC = 128, kK = 16, kThreads = 128;
// 3 blocks an SM (up to 168 registers a thread). Five an SM (96 registers)
// spill the accumulators and ran slower on the card (PERF.md).
constexpr int kBlocksPerSm = 3;
// floats of a running sum (kChunk), kThreads x 64 outputs
constexpr int kRunFloats = kThreads * 64;

using ASlab = float[kK][kM];  // a[kk][m] = A[m0 + m, k0 + kk]
using BSlab = float[kK][kC];  // b[kk][c] = B[k0 + kk, c0 + c]

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// threads as (kM / 8) x (kC / 8): output i of a thread is row(i) of the
// tile, output q column col(q)
__device__ __forceinline__ int row(int i) {
  const int ty = threadIdx.x / (kC / 8);
  return i < 4 ? ty * 4 + i : kM / 2 + ty * 4 + i - 4;
}
__device__ __forceinline__ int col(int q) {
  const int tx = threadIdx.x % (kC / 8);
  return q < 4 ? tx * 4 + q : kC / 2 + tx * 4 + q - 4;
}

// A slab of an operand that lies in rows along k: s[kk][x] = src[(k0 + kk)
// * ld + x0 + x], zero at k >= k_hi or x0 + x >= n_x. VEC (ld, x0 and n_x
// multiples of 4, src 16-byte aligned): 16-byte cp.async copies, a run of 4
// all in or all out; else element loads, all issued before the stores.
template <int W, bool VEC>
struct RowSlab {
  __device__ __forceinline__ void stage(float (&s)[kK][W], const float* __restrict__ src,
                                        size_t ld, int k0, long long k_hi, long long x0,
                                        long long n_x) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < kK * W / 4 / kThreads; ++i) {  // row kk, columns x .. x + 3
        const int u = threadIdx.x + i * kThreads, kk = u / (W / 4), x = (u % (W / 4)) * 4;
        const long long k = k0 + kk, xx = x0 + x;
        const bool ok = k < k_hi && xx < n_x;
        cp_async16(&s[kk][x], ok ? src + static_cast<size_t>(k) * ld + xx : src, ok);
      }
    } else {
      float v[kK * W / kThreads];
#pragma unroll
      for (int i = 0; i < kK * W / kThreads; ++i) {  // every load before the stores
        const int e = threadIdx.x + i * kThreads, kk = e / W;
        const long long k = k0 + kk, xx = x0 + e % W;
        v[i] = k < k_hi && xx < n_x ? src[static_cast<size_t>(k) * ld + xx] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kK * W / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        s[e / W][e % W] = v[i];
      }
    }
  }
};

// A slab of an operand that lies across k (its rows run along k): s[kk][x]
// = src[(x0 + x) * ld + k0 + kk], zero at k >= k_hi or x0 + x >= n_x. A
// thread loads runs of 4 along k into registers (stage) and stores them
// transposed after the slab before's FMAs (land). VEC (ld, k0 and k_hi
// multiples of 4, src 16-byte aligned): one 16-byte load a run.
template <int W, bool VEC>
struct ColSlab {
  static constexpr int kRuns = kK * W / 4 / kThreads;
  float r[kRuns][4];  // run i: s[kq(i) + e][x(i)]
  __device__ __forceinline__ static int x(int i) {
    return (threadIdx.x + i * kThreads) / (kK / 4);
  }
  __device__ __forceinline__ static int kq(int i) {
    return ((threadIdx.x + i * kThreads) % (kK / 4)) * 4;
  }
  __device__ __forceinline__ void stage(const float* __restrict__ src, size_t ld, int k0,
                                        long long k_hi, long long x0, long long n_x) {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const long long xx = x0 + x(i), k = k0 + kq(i);
      const float* p = src + static_cast<size_t>(xx) * ld + k;
      if constexpr (VEC) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (xx < n_x && k < k_hi) v = __ldg(reinterpret_cast<const float4*>(p));
        r[i][0] = v.x, r[i][1] = v.y, r[i][2] = v.z, r[i][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) r[i][e] = xx < n_x && k + e < k_hi ? __ldg(p + e) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void land(float (&s)[kK][W]) const {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[kq(i) + e][x(i)] = r[i][e];
    }
  }
};

struct NoSlabHook {
  __device__ __forceinline__ void operator()(const BSlab&, int) const {}
};

// The main loop over nslab slabs: stage(a, b, s) starts slab s's loads into
// a stage of the ring, land(a, b, s) finishes them once this thread's
// cp.async copies have landed, hook(b, s) sees each B slab after its FMAs.
// acc ends as the sums (with kChunk, those of the running sum in run, a
// block's kRunFloats floats of shared memory).
template <int kChunk, typename Stage, typename Land, typename Hook>
__device__ __forceinline__ void mainloop(Stage stage, Land land, Hook hook, int nslab,
                                         float (&acc)[8][8], float* run) {
  __shared__ __align__(16) float a_s[2][kK][kM];
  __shared__ __align__(16) float b_s[2][kK][kC];
  const int tid = threadIdx.x, tx = tid % (kC / 8), ty = tid / (kC / 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc[i][q] = 0.0f;
      if constexpr (kChunk > 0) run[(i * 8 + q) * kThreads + tid] = 0.0f;
    }
  }
  if (nslab > 0) {
    stage(a_s[0], b_s[0], 0);
    cp_async_wait_all();
    land(a_s[0], b_s[0], 0);
  }
  __syncthreads();
  for (int s = 0; s < nslab; ++s) {
    const int cur = s % 2;
    if (s + 1 < nslab) stage(a_s[cur ^ 1], b_s[cur ^ 1], s + 1);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[cur][kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[cur][kk][kM / 2 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[cur][kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&b_s[cur][kk][kC / 2 + tx * 4]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
      }
    }
    hook(b_s[cur], s);
    if constexpr (kChunk > 0) {
      if ((s + 1) % kChunk == 0 || s + 1 == nslab) {  // a run ends: into the running sum
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            run[(i * 8 + q) * kThreads + tid] += acc[i][q];
            acc[i][q] = 0.0f;
          }
        }
      }
    }
    if (s + 1 < nslab) {
      cp_async_wait_all();
      land(a_s[cur ^ 1], b_s[cur ^ 1], s + 1);
    }
    __syncthreads();
  }
  if constexpr (kChunk > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = run[(i * 8 + q) * kThreads + tid];
    }
  }
}

// Store a tile of sums into row-major out (ldo floats a row): rows m0 +
// row(i) < M, columns c0 + col(q) < N. VEC (ldo, c0 and N multiples of 4,
// out 16-byte aligned): 16-byte stores.
template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[8][8], float* __restrict__ out,
                                      size_t ldo, long long m0, long long M, int c0, int N) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + row(i);
    if (m >= M) continue;
    float* o = out + static_cast<size_t>(m) * ldo;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + col(half * 4);
      if constexpr (VEC) {
        if (c < N) {
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                          acc[i][half * 4 + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < N) o[c + q] = acc[i][half * 4 + q];
        }
      }
    }
  }
}

}  // namespace tile
