// Pieces shared by the kernels of K12 (WKV-6, csrc/wkv6.cu) and K13
// (Mamba2's scan, csrc/ssm_scan.cu), forwards and backwards.
//
// Both run a recurrence over a state of LINES x SPAN fp32 entries per
// (batch row, head), in which every entry evolves on its own. A thread
// holds kSpan entries of one line, the line's SPAN entries over LG = SPAN /
// kSpan neighbouring lanes, 32 / LG lines a warp (Geom). Sums along a line
// are in the thread and then over its LG lanes by a shuffle reduce-scatter
// in a fixed tree: no atomics, the same bits on every call. The one update
// of a state entry is written once here (wkv6_update, ssm_update), so a
// backward's replay walks through exactly the states its forward kept.
//
// The inputs come into shared memory a sub-chunk (kSub steps) at a time,
// one TMA box of kSub rows an input, completing on an mbarrier, into a
// ring of slabs loaded ahead of the one in use.
//
// Backward: one block a state; sums across the lines go over the lanes of
// a warp that share a span position, then over the warps through a shared
// tile. A chunk's states stay on chip: its sub-checkpoints (every kSub
// steps) in shared memory, a sub-chunk's states in registers; kSlabs
// slabs, kAhead sub-chunks ahead.
//
// Forward (FwdGeom): a state's lines split over blocks of at most kFwdLines
// lines, which share nothing, a thread kSpan entries of each of a few
// lines (the inputs it reads from shared memory a step serve them all);
// kFwdSlabs slabs, kFwdSlabs - 1 sub-chunks ahead. A step's sums wait for
// the sub-chunk's end, when one reduce-scatter adds the kSub steps' sums
// over each line's lanes; the outputs leave through shared memory as
// 16-byte stores, after the sub-chunk's one barrier.
//
// Header only: each library that includes it keeps its own copy.

#pragma once

#include "wgmma_tma.cuh"  // smem_u32, mbarriers, TMA loads, encode_tiled, allow_smem

namespace {

constexpr int kChunk = 64;   // steps between the forward's checkpoints
constexpr int kSub = 8;      // steps of a sub-chunk: its states in registers
constexpr int kSpan = 8;     // state entries of a thread, along its line
constexpr int kSlabs = 4;    // sub-chunk input slabs in shared memory
constexpr int kAhead = 2;    // slabs in flight beyond the one in use
constexpr int kFwdSlabs = 4;  // the forwards' input slabs
constexpr int kFwdLines = 32; // lines of a forward block, at most
// sub-checkpoints kept in shared memory: sub-chunks 1 .. kChunk / kSub - 2
// (sub-chunk 0 starts at the forward's checkpoint, the last one from the
// registers of the pass that wrote the others)
constexpr int kSubSlots = kChunk / kSub - 2;

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

template <int LINES, int SPAN>
struct Geom {
  static constexpr int LG = SPAN / kSpan;   // lanes a line
  static constexpr int LPW = 32 / LG;       // lines a warp
  static constexpr int W = LINES / LPW;     // warps
  static constexpr int T = 32 * W;          // threads: LINES * SPAN / kSpan
  static_assert(LG >= 2 && LG <= 8 && W >= 1, "widths 16, 32 or 64");
  // span position of a thread's entry e (g: its lane within the line): four
  // consecutive positions, then four more 4·LG on, so that each half is one
  // 16-byte load and a line's lanes read one contiguous run
  __device__ static __forceinline__ int pos(int g, int e) {
    return (e >> 2) * 4 * LG + 4 * g + (e & 3);
  }
};

// The forwards' block: LB lines of a state's LINES, LPT lines a thread
// (at most WANT, as many as whole warps allow): Geom<LB / LPT, SPAN> lays
// out a thread's first line, its others LB / LPT lines on; BLOCKS blocks a
// (b, h). A sub-chunk's line sums wait in a shared tile of kSub rows of YS
// floats (16-byte rows).
template <int LINES, int SPAN, int WANT>
struct FwdGeom {
  static constexpr int LB = LINES < kFwdLines ? LINES : kFwdLines;
  static constexpr int LPT = WANT < LB * SPAN / kSpan / 32 ? WANT : LB * SPAN / kSpan / 32;
  static constexpr int SL = LB / LPT;
  using Gm = Geom<SL, SPAN>;
  static constexpr int T = Gm::T, LG = Gm::LG, LPW = Gm::LPW;
  static constexpr int BLOCKS = LINES / LB;
  static constexpr int YS = LB + 4;
  static_assert(LINES % LB == 0 && LB % 4 == 0 && LPT >= 1, "lines of 16, 32 or 64");
};

// The one update of a state entry, in the forwards and the backwards'
// replays alike. K12: S <- w S + k v, the product k v rounded first.
__device__ __forceinline__ float wkv6_update(float s, float w, float kv) {
  return fmaf(w, s, kv);
}

// K13: h <- a h + (dt x) B, in the plain version's order of products.
__device__ __forceinline__ float ssm_update(float h, float a, float dtx, float B) {
  return fmaf(h, a, dtx * B);
}

// Reduce-scatter of V values over the lanes that differ in the lane bits
// M, 2M, ..., MEND. While more than one value is left, each stage halves
// them: the lane with the stage's bit set keeps the upper half and adds
// its partner's; then the stages add the one value over the bits left.
// x[0 .. Scatter::kept) end as sums whose indices start at `off`.
template <int V, int C, int M, int MEND>
__device__ __forceinline__ void reduce_scatter(float (&x)[V], int lane, int& off) {
  if constexpr (M <= MEND) {
    if constexpr (C > 1) {
      constexpr int Hh = C / 2;
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int k = 0; k < Hh; ++k) {
        const float send = up ? x[k] : x[k + Hh];
        const float keep = up ? x[k + Hh] : x[k];
        x[k] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (up) off += Hh;
      reduce_scatter<V, Hh, 2 * M, MEND>(x, lane, off);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], M);
      reduce_scatter<V, 1, 2 * M, MEND>(x, lane, off);
    }
  }
}

template <int V, int M, int MEND>
struct Scatter {
  static constexpr int stages = ilog2(MEND / M) + 1;
  static constexpr int halvings = stages < ilog2(V) ? stages : ilog2(V);
  static constexpr int kept = V >> halvings;
  // the lane bits of the stages that only added: lanes that differ in them
  // hold the same sums, and the one with them clear writes
  static constexpr int dup_mask = ((MEND << 1) - 1) & ~((M << halvings) - 1);
  // the index of a lane's first kept sum, without the shuffles
  __device__ static __forceinline__ int offset(int lane) {
    int off = 0;
#pragma unroll
    for (int s = 0; s < halvings; ++s)
      if (lane & (M << s)) off += V >> (s + 1);
    return off;
  }
  __device__ static __forceinline__ int run(float (&x)[V], int lane, bool& writes) {
    int off = 0;
    reduce_scatter<V, V, M, MEND>(x, lane, off);
    writes = (lane & dup_mask) == 0;
    return off;
  }
};

// a thread's kSpan entries of a row of SPAN floats (16-byte aligned)
template <int LG>
__device__ __forceinline__ void load_span(float (&d)[kSpan], const float* row, int g) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * g);
  const float4 b = *reinterpret_cast<const float4*>(row + 4 * LG + 4 * g);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

template <int LG>
__device__ __forceinline__ void store_span(float* row, int g, const float (&d)[kSpan]) {
  *reinterpret_cast<float4*>(row + 4 * g) = make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<float4*>(row + 4 * LG + 4 * g) = make_float4(d[4], d[5], d[6], d[7]);
}

// a sub-checkpoint slot: [2][T] float4, a thread's entries at tid
template <int T>
__device__ __forceinline__ void store_slot(float4* slot, int tid, const float (&s)[kSpan]) {
  slot[tid] = make_float4(s[0], s[1], s[2], s[3]);
  slot[T + tid] = make_float4(s[4], s[5], s[6], s[7]);
}

template <int T>
__device__ __forceinline__ void load_slot(float (&s)[kSpan], const float4* slot, int tid) {
  const float4 a = slot[tid], b = slot[T + tid];
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

// The order in which the sub-chunks' inputs are used, and so loaded: the
// chunks last first; in each, a forward pass over sub-chunks 0 .. nq - 2
// (writing the sub-checkpoints), then the walk back over nq - 1 .. 0.
struct Cursor {
  int c, q, walk;  // c < 0: past the last sub-chunk
  __device__ static int subs(int c, int S) {
    const int len = min(kChunk, S - c * kChunk);
    return (len + kSub - 1) / kSub;
  }
  __device__ void start(int S) {
    walk = subs(c, S) > 1 ? 0 : 1;
    q = 0;
  }
  __device__ void advance(int S) {
    const int nq = subs(c, S);
    if (!walk) {
      if (++q > nq - 2) {
        walk = 1;
        q = nq - 1;
      }
    } else if (--q < 0) {
      if (--c >= 0) start(S);
    }
  }
};

// Thread 0 loads the sub-chunks up to index `upto` that are not loaded yet:
// `issue(cursor, slab)` for each.
template <typename Issue>
__device__ __forceinline__ void produce(Cursor& cur, int& issued, int upto, int S,
                                        Issue issue) {
  while (issued <= upto && cur.c >= 0) {
    issue(cur, issued % kSlabs);
    cur.advance(S);
    ++issued;
  }
}

// a sum of the W values p[0], p[stride], ... in a fixed pairwise order
template <int W>
__device__ __forceinline__ float tree_sum(const float* p, int stride) {
  if constexpr (W == 1) {
    return p[0];
  } else {
    return tree_sum<W / 2>(p, stride) + tree_sum<W / 2>(p + (W / 2) * stride, stride);
  }
}

// the slab of sub-chunk `item` has landed
__device__ __forceinline__ void wait_slab(uint64_t* full, int item) {
  mbar_wait(&full[item % kSlabs], (item / kSlabs) & 1);
}

// The encoding of a tensor map is a driver call and needs a current
// context: cudaSetDevice makes the device's primary context current on a
// thread with none yet (as make_map does for K10). Returns the cudaError.
int make_context_current() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

// A contiguous fp32 (B, S, rows, width) tensor as TMA reads it: boxes of
// `box` columns (all `width` by default) x 1 row x kSub steps x 1, not
// swizzled, zeros past step S - 1. Returns 0, or the negated CUresult of
// the encoding (with a current context: make_context_current).
int make_step_map(CUtensorMap* map, const float* ptr, int B, int S, int rows, int width,
                  int box = 0) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(width) * sizeof(float);
  const cuuint64_t strides[3] = {row, row * rows, row * rows * S};
  const cuuint32_t dims_box[4] = {static_cast<cuuint32_t>(box ? box : width), 1, kSub, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr),
                            dims, strides, dims_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// A kernel launched with T threads and `smem` dynamic shared bytes on the
// current card: out[0..4] = threads, dynamic shared bytes, registers a
// thread, blocks an SM, local (spilled) bytes a thread. Returns the
// cudaError.
template <typename Kern>
int kernel_info(Kern kernel, int T, size_t smem, int* out) {
  bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, T, smem);
  if (err != cudaSuccess) return err;
  out[0] = T;
  out[1] = static_cast<int>(smem);
  out[2] = attr.numRegs;
  out[3] = blocks;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// the dynamic shared memory, its start rounded up to 128 bytes (TMA's
// destination alignment); kernels ask for kSmemSlack bytes more
constexpr int kSmemSlack = 128;
__device__ __forceinline__ float* smem_base(unsigned char* raw) {
  return reinterpret_cast<float*>(raw + ((128 - (smem_u32(raw) & 127)) & 127));
}

// sum over the 32 lanes of a warp, every lane the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

}  // namespace
