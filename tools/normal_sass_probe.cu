// Probe kernels that hold one piece each of the normal kernel's device
// code, so that cuobjdump -sass counts the instructions of each piece
// (tools/k7_normal_parent_ab.py --sass compiles this file to a cubin, once
// against this checkout's csrc/threefry_normal.cu and once, with -DPARENT,
// against an older checkout's, whose log1p is one select of both branches).
// Every probe loads its inputs, computes the piece once and stores one
// word; probe_copy is the same load and store alone, the count to subtract.
//
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin
//      -DNORMAL_SOURCE='"<csrc>/threefry_normal.cu"' -I <csrc> normal_sass_probe.cu

#include NORMAL_SOURCE

// extern "C": plain names in the SASS listing, and kept though no host
// code launches them
extern "C" {

__device__ __forceinline__ unsigned probe_index() { return blockIdx.x * blockDim.x + threadIdx.x; }

__global__ void probe_copy(const float* __restrict__ in, float* __restrict__ out) {
  const unsigned i = probe_index();
  out[i] = in[i];
}

// one threefry block (both words: the xor keeps both live)
__global__ void probe_hash(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                           uint32_t k0, uint32_t k1, uint32_t n) {
  const unsigned i = probe_index();
  uint32_t o0, o1;
  threefry::threefry_pair(k0, k1, in[i], n, o0, o1);
  out[i] = o0 ^ o1;
}

#ifdef PARENT
// XLA's log1p as the select of both branches
__global__ void probe_log1p_select(const float* __restrict__ in, float* __restrict__ out) {
  const unsigned i = probe_index();
  out[i] = xla_log1p(in[i]);
}

// a word's normal, the whole chain (fill, uniform, log1p select, erf_inv)
__global__ void probe_word_to_normal(const uint32_t* __restrict__ in, float* __restrict__ out) {
  const unsigned i = probe_index();
  out[i] = word_to_normal(in[i]);
}
#else
__global__ void probe_log1p_cephes(const float* __restrict__ in, float* __restrict__ out) {
  const unsigned i = probe_index();
  out[i] = log1p_cephes(in[i]);
}

__global__ void probe_log1p_eigen(const float* __restrict__ in, float* __restrict__ out) {
  const unsigned i = probe_index();
  out[i] = log1p_eigen(in[i]);
}

// erf_inv's polynomials given the log1p (both branches' code: static count)
__global__ void probe_erf_inv(const float* __restrict__ in, const float* __restrict__ lg,
                              float* __restrict__ out) {
  const unsigned i = probe_index();
  out[i] = erf_inv_of(in[i], lg[i]);
}

// erf_inv's common branch alone (lg > -5, where all but about 0.3 % of
// the draws fall)
__global__ void probe_erf_inv_common(const float* __restrict__ in, const float* __restrict__ lg,
                                     float* __restrict__ out) {
  const unsigned i = probe_index();
  const float l = lg[i];
  __builtin_assume(l > -5.0f);
  out[i] = erf_inv_of(in[i], l);
}

// the fill and the uniform of a word
__global__ void probe_uniform(const uint32_t* __restrict__ in, float* __restrict__ out) {
  const unsigned i = probe_index();
  out[i] = uniform_of(in[i]);
}
#endif

}  // extern "C"
