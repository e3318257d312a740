// The chunk walk K1 (raster_hard.cu), K1's soft mode (raster_soft.cu), K6
// (raster_stream.cu), K7 (raster_topk.cu) and G (raster_2d.cu) share: one
// thread per pixel, one block per 256 pixels (K1, K1-soft, K6, K7:
// consecutive pixels of the flat row-major index; G: a 16 x 16 tile),
// faces in sorted 128-face chunks.
//
// - The chunks the block tests are found by one warp ballot over 32 chunks
//   at a time, kept in a register window (each warp computes the same
//   answer on its own, so no barrier is needed): by row band (ChunkScan)
//   or, for G, by the chunk's x and y bounds against the tile
//   (ChunkScan2D). K6 walks every chunk of its tile's range (RangeScan).
// - A chunk's coefficient rows are copied face-major into shared memory
//   by 4-byte cp.async into the free one of two slots while the previous
//   chunk is tested: rows 0-18 at REC floats a face for the soft mode and
//   K7 (a face's planes are five 16-byte broadcast loads), rows 0-11 at
//   HARD_REC floats for K1 and G (three).
// - The bbox bound: for a pixel (px, py) of the warp's rectangle
//   [col0, col1] x [row0, row1] the bbox distance min(fl(px - xmin),
//   fl(xmax - px), fl(py - ymin), fl(ymax - py)) is at most ub =
//   min(fl(col1 - xmin), fl(xmax - col0), fl(row1 - ymin), fl(ymax - row0)),
//   since rounding is monotone. A warp that wraps a row takes the rectangle
//   [0, W-1] x its rows; lanes past the frame only widen it.
// - K1, G and K6 hard (hard_walk): each warp keeps the faces that the exact
//   corner rule cannot rule out over its rectangle (hard_list; the lemma is
//   in raster_hard.cu's header).
// - K1-soft and K6 soft (soft_walk): each warp keeps a face unless the
//   corner rule rules it out as the covering face AND ub <= s_near, the
//   least nearest distance over the warp's pixels (soft_list). The bbox
//   alone never rules out covering: a sliver's rounded barycentrics can
//   all be >= 0 at pixels many pixels outside its bbox.
// - K7: each warp keeps the faces with ub > -window (face_list): the
//   eligibility it selects on is a distance <= the bbox distance.
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

// The chunks a block of G (raster_2d.cu) tests, found as ChunkScan finds
// them: bit i of `hits` says whether chunk base + i has bounds (ymin, ymax,
// xmin, xmax) that meet the tile's rows [row0, row1] and columns
// [col0, col1] (the reference's x-and-y rule).
struct ChunkScan2D {
  const float* bv;
  int n_chunks;
  float row0, row1, col0, col1;
  int base;
  unsigned hits;

  __device__ __forceinline__ ChunkScan2D(const float* bv_, int n_chunks_,
                                         float row0_, float row1_,
                                         float col0_, float col1_)
      : bv(bv_), n_chunks(n_chunks_), row0(row0_), row1(row1_), col0(col0_),
        col1(col1_), base(0) {
    load();
  }

  __device__ __forceinline__ void load() {
    const int cc = base + (threadIdx.x & 31);
    const int n = n_chunks;
    hits = __ballot_sync(
        FULL, cc < n && bv[n + cc] >= row0 && bv[cc] <= row1 &&
                  bv[3 * n + cc] >= col0 && bv[2 * n + cc] <= col1);
  }

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

// The chunks of one range [c_lo, c_hi] in order, each of them (K6: the
// range of the block's tile, as the TPU kernel walks it); none when
// c_lo > c_hi.
struct RangeScan {
  int c_lo, c_hi, n_chunks;

  // The chunk after c (n_chunks when none).
  __device__ __forceinline__ int next(int c) const {
    const int n = max(c + 1, c_lo);
    return n <= c_hi ? n : n_chunks;
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

// ub: the upper bound of a face's bbox distance over the box (rows 15-18
// are d.w = xmin, e.x = xmax, e.y = ymin, e.z = ymax).
__device__ __forceinline__ float bbox_upper(const float4& d, const float4& e,
                                            const Box& b) {
  return fminf(fminf(__fsub_rn(b.col1, d.w), __fsub_rn(e.x, b.col0)),
               fminf(__fsub_rn(b.row1, e.y), __fsub_rn(e.z, b.row0)));
}

// The warp's list of the staged chunk (K7): bit f % 32 of keep[f / 32] is
// set unless ub <= lim (so every dropped face has bbox distance <= lim at
// every pixel of the warp). Faces stay in sorted order.
__device__ __forceinline__ void face_list(const float* slot, const Box& b,
                                          float lim, unsigned keep[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) {
    const float* q = slot + (32 * w + lane) * REC;
    const float4 d = *reinterpret_cast<const float4*>(q + 12);
    const float4 e = *reinterpret_cast<const float4*>(q + 16);
    keep[w] = __ballot_sync(FULL, !(bbox_upper(d, e, b) <= lim));
  }
}

// The largest value of affine(px, py, a, b, c) over the box, exactly as the
// kernel would round it at that pixel (the lemma in raster_hard.cu).
__device__ __forceinline__ float corner_max(const Box& bx, float a, float b,
                                            float c) {
  return affine(a >= 0.f ? bx.col1 : bx.col0, b >= 0.f ? bx.row1 : bx.row0,
                a, b, c);
}

// Whether the corner rule rules the face (a Face or a HardFace) out as the
// covering face of every pixel of the box: it covers none of them, or its
// 1/z is <= s_w over the whole box.
template <typename F>
__device__ __forceinline__ bool corner_drop(const F& q, const Box& bx,
                                            float s_w) {
  return corner_max(bx, q.a.x, q.a.y, q.a.z) < 0.f ||
         corner_max(bx, q.a.w, q.b.x, q.b.y) < 0.f ||
         corner_max(bx, q.b.z, q.b.w, q.c.x) < 0.f ||
         corner_max(bx, q.c.y, q.c.z, q.c.w) <= s_w;
}

// The warp's hard list of the staged chunk (K1, G, K6 hard): bit f % 32 of
// keep[f / 32] is set unless corner_drop. Faces stay in sorted order.
__device__ __forceinline__ void hard_list(const float* slot, const Box& bx,
                                          float s_w, unsigned keep[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) {
    const HardFace q = load_hard_face(slot, 32 * w + lane);
    keep[w] = __ballot_sync(FULL, !corner_drop(q, bx, s_w));
  }
}

// The warp's soft lists of the staged chunk (K1-soft, K6 soft): bit f % 32
// of hard[f / 32] is set unless corner_drop against s_hard (the least best
// 1/z over the warp's pixels), and of keep[f / 32] also where ub > s_near
// (the least nearest distance): a face left out can change neither a
// pixel's covering face nor its nearest one, whose distance is <= the bbox
// distance <= ub. Faces stay in sorted order.
__device__ __forceinline__ void soft_list(const float* slot, const Box& bx,
                                          float s_hard, float s_near,
                                          unsigned keep[4],
                                          unsigned hard[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) {
    const Face q = load_face(slot, 32 * w + lane);
    const bool cover = !corner_drop(q, bx, s_hard);
    hard[w] = __ballot_sync(FULL, cover);
    keep[w] = __ballot_sync(FULL, cover || !(bbox_upper(q.d, q.e, bx) <=
                                             s_near));
  }
}

// The least of v over the warp's pixels in the frame.
__device__ __forceinline__ float warp_least(float v, bool live) {
  float s = live ? v : 3.0e38f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = fminf(s, __shfl_xor_sync(FULL, s, o));
  return s;
}

// The hard walk of one block (K1, G, K6 hard): the chunks `scan` yields, in
// order, each staged (rows 0-11 face-major) into the free one of the two
// slots of `buf` while the previous one is tested; each warp tests its hard
// list of the chunk at its pixel (px, py), strict '>' on 1/z into best and
// fid. `live`: the pixel is in the frame. Returns the warp's tested (pixel,
// face) pairs (the same in every lane). Call from every thread.
template <typename Scan>
__device__ __forceinline__ unsigned long long hard_walk(
    Scan& scan, float (*buf)[CHUNK * HARD_REC], const float* cv, int f_pad,
    int n_chunks, const Box& box, float px, float py, bool live,
    float& best, int& fid) {
  const int n_live = __popc(__ballot_sync(FULL, live));
  unsigned long long pairs = 0;
  int cur = scan.next(-1);
  int nxt = n_chunks;
  if (cur < n_chunks) {
    stage_rows<HARD_ROWS, HARD_REC>(buf[0], cv, f_pad, cur);
    nxt = scan.next(cur);
  }
  int slot = 0;
  while (cur < n_chunks) {
    if (nxt < n_chunks) {
      stage_rows<HARD_ROWS, HARD_REC>(buf[slot ^ 1], cv, f_pad, nxt);
      cp_async_wait<1>();   // chunk cur has landed, nxt may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sc = buf[slot];
    unsigned keep[CHUNK / 32];
    hard_list(sc, box, warp_least(best, live), keep);
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w)
      pairs += (unsigned long long)(__popc(keep[w]) * n_live);
    if (live) {
#pragma unroll
      for (int w = 0; w < CHUNK / 32; ++w) {
        for (unsigned m = keep[w]; m; m &= m - 1) {
          const int f = 32 * w + __ffs(m) - 1;
          const HardFace q = load_hard_face(sc, f);
          float b0, b1, b2;
          planes(q, px, py, b0, b1, b2);
          const float iz = inv_z(q, px, py);
          if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f && iz > best) {
            best = iz;
            fid = cur * CHUNK + f;
          }
        }
      }
    }
    __syncthreads();   // slot `slot` is refilled next
    cur = nxt;
    slot ^= 1;
    if (cur < n_chunks) nxt = scan.next(cur);
  }
  return pairs;
}

// The soft walk of one block (K1-soft, K6 soft), as hard_walk with rows
// 0-18 staged and soft_list's lists: strict '>' on 1/z into best and fid,
// and on the distance min(edge distance, bbox distance) into sbest and sid.
// A pixel also skips a listed face outside hard's bits whose own bbox
// distance is <= its best distance so far (the face cannot cover it past
// its best 1/z, and its distance cannot pass sbest, now or later). Returns
// the warp's tested (pixel, face) pairs. Call from every thread.
template <typename Scan>
__device__ __forceinline__ unsigned long long soft_walk(
    Scan& scan, float (*buf)[CHUNK * REC], const float* cv, int f_pad,
    int n_chunks, const Box& box, float px, float py, bool live,
    float& best, int& fid, float& sbest, int& sid) {
  const int n_live = __popc(__ballot_sync(FULL, live));
  unsigned long long pairs = 0;
  int cur = scan.next(-1);
  int nxt = n_chunks;
  if (cur < n_chunks) {
    stage(buf[0], cv, f_pad, cur);
    nxt = scan.next(cur);
  }
  int slot = 0;
  while (cur < n_chunks) {
    if (nxt < n_chunks) {
      stage(buf[slot ^ 1], cv, f_pad, nxt);
      cp_async_wait<1>();   // chunk cur has landed, nxt may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sc = buf[slot];
    unsigned keep[CHUNK / 32], hard[CHUNK / 32];
    soft_list(sc, box, warp_least(best, live), warp_least(sbest, live), keep,
              hard);
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w)
      pairs += (unsigned long long)(__popc(keep[w]) * n_live);
    if (live) {
#pragma unroll
      for (int w = 0; w < CHUNK / 32; ++w) {
        for (unsigned m = keep[w]; m; m &= m - 1) {
          const int f = 32 * w + __ffs(m) - 1;
          const Face q = load_face(sc, f);
          const float bb = bbox_dist(q, px, py);
          if (!((hard[w] >> (f & 31)) & 1u) && bb <= sbest) continue;
          float b0, b1, b2;
          planes(q, px, py, b0, b1, b2);
          const float iz = inv_z(q, px, py);
          if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f && iz > best) {
            best = iz;
            fid = cur * CHUNK + f;
          }
          const float d = fminf(edge_dist(q, b0, b1, b2), bb);
          if (d > sbest) {
            sbest = d;
            sid = cur * CHUNK + f;
          }
        }
      }
    }
    __syncthreads();   // slot `slot` is refilled next
    cur = nxt;
    slot ^= 1;
    if (cur < n_chunks) nxt = scan.next(cur);
  }
  return pairs;
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
