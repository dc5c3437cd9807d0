// LSTM cell gate kernels (K1) for Hopper, forward and backward.
//
// Replaces the Pallas TPU kernels src/repro/kernels/lstm_gates.py:43
// lstm_gates_fused (_kernel, :30) and :92 lstm_gates_bwd_fused
// (_bwd_kernel, :74). The per-step LSTM cell after the recurrent matmul:
//
//   gates (N, 4H) in the order [i | f | g | o], +1 on the forget gate,
//   c (N, H) fp32
//   forward : h_new = o * tanh(c_new), c_new = f * c + i * g
//             -> h_new (N, H) in the gate dtype, c_new (N, H) fp32
//   backward: (gates, c, dh, dc_next) -> dgates (N, 4H) in the gate
//             dtype, dc_prev (N, H) fp32, with the four activations
//             recomputed from the saved pre-activations.
//
// Design: one thread per (row, hidden unit). Each thread reads its four
// gates at strides of H, so neighbouring threads read neighbouring
// addresses in each of the four gate slabs. Any N and H are taken; the
// ragged edge is masked (the TPU kernel's H % 128 rule does not apply).
// Math is fp32 with expf/tanhf (no fast math), so the fp32 path stays
// within a few ulps of the plain PyTorch version.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes moved. At the paper-width
// step (N = 4, H = 1152, bf16 gates) the forward reads gates (36,864 B)
// and c (18,432 B) and writes h (9,216 B) and c_new (18,432 B): about
// 83 KB, about 25 ns. Its 19 operations per hidden unit take about 1 ns
// at 67 TFLOP/s fp32. The backward moves about 138 KB, about 41 ns. A
// launch costs microseconds, so at these sizes the kernel is bound by
// the launch, not by the card; making it faster (fusing steps, CUDA
// graphs) is later work.
//
// Built by src/repro_torch/kernels/build.py with nvcc for sm_90a into a
// shared library with a plain C interface, called through ctypes. Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void lstm_gates_fwd_kernel(const T* __restrict__ gates, const float* __restrict__ c,
                                      T* __restrict__ h_out, float* __restrict__ c_out,
                                      long long total, int H) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= total) return;
  long long n = idx / H;
  int j = static_cast<int>(idx - n * H);
  const T* g = gates + n * 4 * H + j;
  float i = sigmoid(load_f(g));
  float f = sigmoid(load_f(g + H) + 1.0f);
  float gg = tanhf(load_f(g + 2 * H));
  float o = sigmoid(load_f(g + 3 * H));
  float c_new = f * c[idx] + i * gg;
  c_out[idx] = c_new;
  store_f(h_out + idx, o * tanhf(c_new));
}

template <typename T>
__global__ void lstm_gates_bwd_kernel(const T* __restrict__ gates, const float* __restrict__ c,
                                      const T* __restrict__ dh, const float* __restrict__ dc_next,
                                      T* __restrict__ dgates, float* __restrict__ dc_prev,
                                      long long total, int H) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= total) return;
  long long n = idx / H;
  int j = static_cast<int>(idx - n * H);
  const T* g = gates + n * 4 * H + j;
  T* dg = dgates + n * 4 * H + j;
  float cv = c[idx];
  float dhv = load_f(dh + idx);
  float i = sigmoid(load_f(g));
  float f = sigmoid(load_f(g + H) + 1.0f);
  float gg = tanhf(load_f(g + 2 * H));
  float o = sigmoid(load_f(g + 3 * H));
  float t = tanhf(f * cv + i * gg);  // tanh(c_new), recomputed
  float dc = dc_next[idx] + dhv * o * (1.0f - t * t);
  // same operation order as the Pallas backward
  store_f(dg, dc * gg * i * (1.0f - i));
  store_f(dg + H, dc * cv * f * (1.0f - f));
  store_f(dg + 2 * H, dc * i * (1.0f - gg * gg));
  store_f(dg + 3 * H, dhv * t * o * (1.0f - o));
  dc_prev[idx] = dc * f;
}

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 = float32 gates, 1 = bfloat16 gates. c, c_out, dc_next and
// dc_prev are always float32. Returns a cudaError_t as int (0 = success).
extern "C" int lstm_gates_fwd(int dtype, const void* gates, const void* c, void* h_out,
                              void* c_out, int N, int H, void* stream) {
  long long total = static_cast<long long>(N) * H;
  if (total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(c);
  float* cop = static_cast<float*>(c_out);
  if (dtype == 0) {
    lstm_gates_fwd_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(gates), cp, static_cast<float*>(h_out), cop, total, H);
  } else if (dtype == 1) {
    lstm_gates_fwd_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gates), cp, static_cast<__nv_bfloat16*>(h_out), cop,
        total, H);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lstm_gates_bwd(int dtype, const void* gates, const void* c, const void* dh,
                              const void* dc_next, void* dgates, void* dc_prev, int N, int H,
                              void* stream) {
  long long total = static_cast<long long>(N) * H;
  if (total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(c);
  const float* dcn = static_cast<const float*>(dc_next);
  float* dcp = static_cast<float*>(dc_prev);
  if (dtype == 0) {
    lstm_gates_bwd_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(gates), cp, static_cast<const float*>(dh), dcn,
        static_cast<float*>(dgates), dcp, total, H);
  } else if (dtype == 1) {
    lstm_gates_bwd_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gates), cp, static_cast<const __nv_bfloat16*>(dh), dcn,
        static_cast<__nv_bfloat16*>(dgates), dcp, total, H);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
