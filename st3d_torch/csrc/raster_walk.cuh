// The chunk walk K1 (raster_hard.cu), K1's soft mode (raster_soft.cu) and
// K7 (raster_topk.cu) share: one thread per pixel, one block per 256
// consecutive pixels of the flat row-major index, faces in sorted 128-face
// chunks.
//
// - The chunks the block tests are found by one warp ballot over 32 chunk
//   bands at a time, kept in a register window (each warp computes the
//   same answer on its own, so no barrier is needed).
// - A chunk's coefficient rows are copied face-major into shared memory
//   by 4-byte cp.async into the free one of two slots while the previous
//   chunk is tested: rows 0-18 at REC floats a face for the soft mode and
//   K7 (a face's planes are five 16-byte broadcast loads), rows 0-11 at
//   HARD_REC floats for K1 (three).
// - Each warp keeps, by four ballots, the faces whose bbox upper bound over
//   the warp's pixel rectangle, ub, passes the caller's limit. For a pixel
//   (px, py) of the rectangle [col0, col1] x [row0, row1] the bbox distance
//   min(fl(px - xmin), fl(xmax - px), fl(py - ymin), fl(ymax - py)) is at
//   most ub = min(fl(col1 - xmin), fl(xmax - col0), fl(row1 - ymin),
//   fl(ymax - row0)), since rounding is monotone. A warp that wraps a row
//   takes the rectangle [0, W-1] x its rows; lanes past the frame only
//   widen it.
//
// Every affine value is two rounded products and two rounded sums
// (__fmul_rn / __fadd_rn); the sources that include this are built with
// -fmad=false.

#pragma once

#include <cuda_runtime.h>

namespace st3d_walk {

constexpr int CHUNK = 128;     // faces per chunk (the wrapper pads to it)
constexpr int TILE = 256;      // pixels per block
constexpr int WARPS = TILE / 32;
constexpr int NROWS = 19;      // coefficient rows staged (row 19 pads)
constexpr int REC = 20;        // floats a staged face: 16-byte aligned
constexpr int HARD_ROWS = 12;  // K1's rows: the barycentric and 1/z planes
constexpr int HARD_REC = 12;   // floats a face K1 stages: 16-byte aligned
constexpr float NEG_INIT = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float affine(float px, float py, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

// A face's 19 coefficient rows as staged: a = rows 0-3, b = 4-7, c = 8-11,
// d = 12-15, e = 16-19 (e.w is not staged).
struct Face {
  float4 a, b, c, d, e;
};

__device__ __forceinline__ Face load_face(const float* slot, int f) {
  const float4* q = reinterpret_cast<const float4*>(slot + f * REC);
  return Face{q[0], q[1], q[2], q[3], q[4]};
}

// The bbox distance of pixel (px, py): rows 15-18 are xmin, xmax, ymin, ymax.
__device__ __forceinline__ float bbox_dist(const Face& q, float px,
                                           float py) {
  return fminf(fminf(__fsub_rn(px, q.d.w), __fsub_rn(q.e.x, px)),
               fminf(__fsub_rn(py, q.e.y), __fsub_rn(q.e.z, py)));
}

// K1's rows 0-11 as staged: a = rows 0-3, b = 4-7, c = 8-11.
struct HardFace {
  float4 a, b, c;
};

__device__ __forceinline__ HardFace load_hard_face(const float* slot, int f) {
  const float4* q = reinterpret_cast<const float4*>(slot + f * HARD_REC);
  return HardFace{q[0], q[1], q[2]};
}

// Barycentrics b0, b1, b2 (rows 0-8) and 1/z (rows 9-11) at (px, py), of a
// Face or a HardFace.
template <typename F>
__device__ __forceinline__ void planes(const F& q, float px, float py,
                                       float& b0, float& b1, float& b2) {
  b0 = affine(px, py, q.a.x, q.a.y, q.a.z);
  b1 = affine(px, py, q.a.w, q.b.x, q.b.y);
  b2 = affine(px, py, q.b.z, q.b.w, q.c.x);
}

template <typename F>
__device__ __forceinline__ float inv_z(const F& q, float px, float py) {
  return affine(px, py, q.c.y, q.c.z, q.c.w);
}

// The signed edge distance min(b0*h0, b1*h1, b2*h2) (rows 12-14).
__device__ __forceinline__ float edge_dist(const Face& q, float b0, float b1,
                                           float b2) {
  return fminf(fminf(__fmul_rn(b0, q.d.x), __fmul_rn(b1, q.d.y)),
               __fmul_rn(b2, q.d.z));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of chunk c's rows 0 .. ROWS-1 into `slot`, face-major:
// slot[f * RECN + r] = row r of face f. Reads are coalesced along faces.
template <int ROWS, int RECN>
__device__ __forceinline__ void stage_rows(float* slot,
                                           const float* __restrict__ cv,
                                           int f_pad, int c) {
  for (int i = threadIdx.x; i < ROWS * CHUNK; i += TILE) {
    const int r = i / CHUNK;
    const int f = i % CHUNK;
    cp_async4(slot + f * RECN + r,
              cv + (long long)r * f_pad + (long long)c * CHUNK + f);
  }
  cp_async_commit();
}

// Rows 0-18 at REC floats a face (the soft mode and K7).
__device__ __forceinline__ void stage(float* slot,
                                      const float* __restrict__ cv,
                                      int f_pad, int c) {
  stage_rows<NROWS, REC>(slot, cv, f_pad, c);
}

// The chunks a block tests, found 32 bands a ballot: bit i of `hits` says
// whether chunk base + i has a row band [ymin, ymax] that meets [lo, hi].
// The window stays in registers, so the walk reads the bounds once.
struct ChunkScan {
  const float* bv;
  int n_chunks;
  float lo, hi;
  int base;
  unsigned hits;

  __device__ __forceinline__ ChunkScan(const float* bv_, int n_chunks_,
                                       float lo_, float hi_)
      : bv(bv_), n_chunks(n_chunks_), lo(lo_), hi(hi_), base(0) {
    load();
  }

  __device__ __forceinline__ void load() {
    const int cc = base + (threadIdx.x & 31);
    hits = __ballot_sync(
        FULL, cc < n_chunks && bv[n_chunks + cc] >= lo && bv[cc] <= hi);
  }

  // The first tested chunk after c (n_chunks when none); c never falls
  // below the previous answer.
  __device__ __forceinline__ int next(int c) {
    for (;;) {
      const int from = max(c + 1 - base, 0);
      const unsigned m = from >= 32 ? 0u : hits & (~0u << from);
      if (m) return base + __ffs(m) - 1;
      base += 32;
      if (base >= n_chunks) return n_chunks;
      load();
    }
  }
};

// The warp's pixel rectangle [col0, col1] x [row0, row1].
struct Box {
  float col0, col1, row0, row1;
};

__device__ __forceinline__ Box warp_box(float px, float py, int W) {
  Box b{__shfl_sync(FULL, px, 0), __shfl_sync(FULL, px, 31),
        __shfl_sync(FULL, py, 0), __shfl_sync(FULL, py, 31)};
  if (b.row0 != b.row1) {   // the warp wraps a row
    b.col0 = 0.f;
    b.col1 = (float)(W - 1);
  }
  return b;
}

// The warp's list of the staged chunk: bit f % 32 of keep[f / 32] is set
// unless ub <= lim (so every dropped face has bbox distance <= lim at every
// pixel of the warp). Faces stay in sorted order.
__device__ __forceinline__ void face_list(const float* slot, const Box& b,
                                          float lim, unsigned keep[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) {
    const float* q = slot + (32 * w + lane) * REC;
    const float4 d = *reinterpret_cast<const float4*>(q + 12);
    const float4 e = *reinterpret_cast<const float4*>(q + 16);
    const float ub = fminf(fminf(__fsub_rn(b.col1, d.w),
                                 __fsub_rn(e.x, b.col0)),
                           fminf(__fsub_rn(b.row1, e.y),
                                 __fsub_rn(e.z, b.row0)));
    keep[w] = __ballot_sync(FULL, !(ub <= lim));
  }
}

// Adds the block's (pixel, face) pairs to *tested: `pairs` is each warp's
// own count (the same in every lane). Call from every thread.
__device__ __forceinline__ void add_tested(unsigned long long* tested,
                                           unsigned long long pairs) {
  __shared__ unsigned long long per_warp[WARPS];
  if (tested == nullptr) return;
  if ((threadIdx.x & 31) == 0) per_warp[threadIdx.x / 32] = pairs;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < WARPS; ++w) s += per_warp[w];
    atomicAdd(tested, s);
  }
}

}  // namespace st3d_walk
