// Top-K visibility: per pixel, the K nearest faces by raw 1/z among those
// whose signed distance exceeds -window, sorted near to far (SoftRas with
// faces_per_pixel K, and the hard blur / K > 1 path with K + slack slots).
//
// Replaces the TPU kernel st3d/kernels/raster_pallas.py::_raster_topk_kernel
// (entry _rasterize_pallas_topk_impl). Preprocessing stays outside the
// kernel (st3d_torch/kernels/raster.py), as for K1.
//
// Selection, the TPU kernel's exactly: per chunk, the chunk's eligible faces
// are ranked by descending 1/z with the lower index first on ties (the TPU
// kernel's K rounds of first-index argmax), and its first K are inserted in
// that order into the pixel's K slots, each insertion walking the slots and
// swapping wherever the carried entry is strictly greater. Here each thread
// builds the chunk's ranking as a second K-slot list by stable insertion
// (a new face goes after equal scores) and then merges it with the TPU
// kernel's swap walk. Eligibility is the soft distance of K1's soft mode,
//   min(b0*h0, b1*h1, b2*h2, bbox distance) > -window,
// with K1's rounding (__fmul_rn / __fadd_rn, -fmad=false), so the ids equal
// the plain version's bit for bit. Empty slots are -1. K is a template
// argument (1..16), so both lists live in registers.
//
// Work layout (raster_walk.cuh): one thread per pixel, one block per 256
// consecutive pixels; chunks whose row band misses the block's rows
// widened by window + 2 are skipped (their faces are all more than the
// window away), the next chunk to test is found by a warp ballot over 32
// bands and staged face-major by cp.async while the previous one is
// tested. Each warp then tests only the faces that can be eligible at one
// of its 32 pixels: it drops a face when ub <= -window, ub being the face's
// bbox upper bound over the warp's pixel rectangle. Exact: at every pixel
// of the warp the soft distance is <= the bbox distance <= ub <= -window,
// so the face is not eligible there, and an ineligible face changes neither
// the chunk's ranking nor the slots. A warp whose list is empty skips the
// chunk; a pixel skips a listed face whose own bbox distance is <= -window.
// st3d_raster_topk_every_face keeps the earlier walk (every face of every
// chunk in band, 19 x 128 rows staged between two barriers): launched by no
// route, the twin chip_smoke.py holds this kernel against.
//
// What bounds it on an H100: compute per tested (pixel, face) pair, as K1's
// soft mode, plus K-step insertions for the faces that enter a list (few
// after the first chunks).
// The lists leave so few pairs that the walk's latency (staging, barriers)
// weighs as much: five blocks an SM (__launch_bounds__) hide it better than
// the registers the compiler would otherwise take.

#include <cuda_runtime.h>

#include "raster_walk.cuh"

namespace {

using namespace st3d_walk;

template <int K>
__global__ void __launch_bounds__(TILE, 5)
raster_topk_kernel(const float* __restrict__ coeffs,
                   const float* __restrict__ bounds, int* __restrict__ ids,
                   unsigned long long* __restrict__ tested, int H, int W,
                   int f_pad, int n_chunks, float window, float margin) {
  __shared__ __align__(16) float buf[2][CHUNK * REC];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const long long last = min(t0 + TILE - 1, hw - 1);
  const float lo = __fsub_rn((float)(t0 / W), margin);
  const float hi = __fadd_rn((float)(last / W), margin);
  const float px = (float)(p % W);
  const float py = (float)(p / W);
  const float neg_window = -window;
  const bool live = p < hw;
  const int n_live = __popc(__ballot_sync(FULL, live));
  const Box box = warp_box(px, py, W);

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 2 * n_chunks;

  float ss[K], ls[K];
  int si[K], li[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ss[s] = NEG_INIT;
    si[s] = -1;
  }
  unsigned long long pairs = 0;
  ChunkScan scan(bv, n_chunks, lo, hi);
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
    unsigned keep[CHUNK / 32];
    face_list(sc, box, neg_window, keep);
    int listed = 0;
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w) listed += __popc(keep[w]);
    pairs += (unsigned long long)(listed * n_live);
    if (listed > 0 && live) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        ls[s] = NEG_INIT;
        li[s] = -1;
      }
#pragma unroll
      for (int w = 0; w < CHUNK / 32; ++w) {
        for (unsigned m = keep[w]; m; m &= m - 1) {
          const int f = 32 * w + __ffs(m) - 1;
          const Face q = load_face(sc, f);
          const float bb = bbox_dist(q, px, py);
          if (!(bb > neg_window)) continue;
          float b0, b1, b2;
          planes(q, px, py, b0, b1, b2);
          if (!(fminf(edge_dist(q, b0, b1, b2), bb) > neg_window)) continue;
          const float iz = inv_z(q, px, py);
          if (!(iz > ls[K - 1])) continue;   // ranks after the chunk's K-th
          // Stable insertion into the chunk's ranking: shift the entries it
          // beats strictly one slot down, land after the equal ones. (No
          // break: below the landing slot both tests fail, so every index
          // is a constant and the lists stay in registers.)
          const int id = cur * CHUNK + f;
#pragma unroll
          for (int j = K - 1; j > 0; --j) {
            if (iz > ls[j - 1]) {
              ls[j] = ls[j - 1];
              li[j] = li[j - 1];
            } else if (iz > ls[j]) {
              ls[j] = iz;
              li[j] = id;
            }
          }
          if (iz > ls[0]) {
            ls[0] = iz;
            li[0] = id;
          }
        }
      }
      // Merge the chunk's ranking in order with the TPU kernel's swap walk.
#pragma unroll
      for (int e = 0; e < K; ++e) {
        float ns = ls[e];
        int ni = li[e];
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (ns > ss[s]) {
            const float ts = ss[s];
            const int ti = si[s];
            ss[s] = ns;
            si[s] = ni;
            ns = ts;
            ni = ti;
          }
        }
      }
    }
    __syncthreads();   // slot `slot` is refilled next
    cur = nxt;
    slot ^= 1;
    if (cur < n_chunks) nxt = scan.next(cur);
  }
  add_tested(tested, pairs);
  if (live) {
    int* out = ids + ((long long)v * hw + p) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) out[s] = ss[s] > -1.0e38f ? si[s] : -1;
  }
}

// The earlier walk: every face of every chunk in band, the chunk's 19 x 128
// rows staged between two barriers.
template <int K>
__global__ void __launch_bounds__(TILE)
raster_topk_every_face_kernel(const float* __restrict__ coeffs,
                              const float* __restrict__ bounds,
                              int* __restrict__ ids, int H, int W, int f_pad,
                              int n_chunks, float window, float margin) {
  __shared__ float sc[NROWS][CHUNK];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const long long last = min(t0 + TILE - 1, hw - 1);
  const float lo = __fsub_rn((float)(t0 / W), margin);
  const float hi = __fadd_rn((float)(last / W), margin);
  const float px = (float)(p % W);
  const float py = (float)(p / W);
  const float neg_window = -window;

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 2 * n_chunks;

  float ss[K], ls[K];
  int si[K], li[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ss[s] = NEG_INIT;
    si[s] = -1;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const float ymin = bv[c];
    const float ymax = bv[n_chunks + c];
    if (!(ymax >= lo && ymin <= hi)) continue;   // same for the block
    __syncthreads();
    for (int i = threadIdx.x; i < NROWS * CHUNK; i += TILE) {
      const int r = i / CHUNK;
      const int f = i % CHUNK;
      sc[r][f] = cv[(long long)r * f_pad + (long long)c * CHUNK + f];
    }
    __syncthreads();
    if (p >= hw) continue;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      ls[s] = NEG_INIT;
      li[s] = -1;
    }
    for (int f = 0; f < CHUNK; ++f) {
      const float b0 = affine(px, py, sc[0][f], sc[1][f], sc[2][f]);
      const float b1 = affine(px, py, sc[3][f], sc[4][f], sc[5][f]);
      const float b2 = affine(px, py, sc[6][f], sc[7][f], sc[8][f]);
      const float sd = fminf(fminf(__fmul_rn(b0, sc[12][f]),
                                   __fmul_rn(b1, sc[13][f])),
                             __fmul_rn(b2, sc[14][f]));
      const float bb = fminf(fminf(__fsub_rn(px, sc[15][f]),
                                   __fsub_rn(sc[16][f], px)),
                             fminf(__fsub_rn(py, sc[17][f]),
                                   __fsub_rn(sc[18][f], py)));
      if (!(fminf(sd, bb) > neg_window)) continue;
      const float iz = affine(px, py, sc[9][f], sc[10][f], sc[11][f]);
      if (!(iz > ls[K - 1])) continue;   // ranks after the chunk's K-th
      // Stable insertion into the chunk's ranking: shift the entries it
      // beats strictly one slot down, land after the equal ones.
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        if (j > 0 && iz > ls[j > 0 ? j - 1 : 0]) {
          ls[j] = ls[j - 1];
          li[j] = li[j - 1];
        } else {
          ls[j] = iz;
          li[j] = c * CHUNK + f;
          break;
        }
      }
    }
    // Merge the chunk's ranking in order with the TPU kernel's swap walk.
#pragma unroll
    for (int e = 0; e < K; ++e) {
      float ns = ls[e];
      int ni = li[e];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (ns > ss[s]) {
          const float ts = ss[s];
          const int ti = si[s];
          ss[s] = ns;
          si[s] = ni;
          ns = ts;
          ni = ti;
        }
      }
    }
  }
  if (p < hw) {
    int* out = ids + ((long long)v * hw + p) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) out[s] = ss[s] > -1.0e38f ? si[s] : -1;
  }
}

template <int K>
void launch(dim3 grid, cudaStream_t st, const float* coeffs,
            const float* bounds, int* ids, unsigned long long* tested, int H,
            int W, int f_pad, int n_chunks, float window, float margin,
            bool every_face) {
  if (every_face) {
    raster_topk_every_face_kernel<K><<<grid, TILE, 0, st>>>(
        coeffs, bounds, ids, H, W, f_pad, n_chunks, window, margin);
  } else {
    raster_topk_kernel<K><<<grid, TILE, 0, st>>>(
        coeffs, bounds, ids, tested, H, W, f_pad, n_chunks, window, margin);
  }
}

int launch_k(const void* coeffs, const void* bounds, void* ids, void* tested,
             int N, int H, int W, int f_pad, int n_chunks, int K,
             float window, float margin, void* stream, bool every_face) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  cudaStream_t st = (cudaStream_t)stream;
  const float* c = (const float*)coeffs;
  const float* b = (const float*)bounds;
  int* o = (int*)ids;
  unsigned long long* t = (unsigned long long*)tested;
#define ST3D_TOPK_CASE(KK)                                                 \
  case KK:                                                                 \
    launch<KK>(grid, st, c, b, o, t, H, W, f_pad, n_chunks, window, margin, \
               every_face);                                                \
    break;
  switch (K) {
    ST3D_TOPK_CASE(1) ST3D_TOPK_CASE(2) ST3D_TOPK_CASE(3) ST3D_TOPK_CASE(4)
    ST3D_TOPK_CASE(5) ST3D_TOPK_CASE(6) ST3D_TOPK_CASE(7) ST3D_TOPK_CASE(8)
    ST3D_TOPK_CASE(9) ST3D_TOPK_CASE(10) ST3D_TOPK_CASE(11)
    ST3D_TOPK_CASE(12) ST3D_TOPK_CASE(13) ST3D_TOPK_CASE(14)
    ST3D_TOPK_CASE(15) ST3D_TOPK_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ST3D_TOPK_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// coeffs (N, 20, f_pad) float32, rows 0..18 read; bounds
// (N, 2, n_chunks) float32; ids (N, H*W, K) int32 in sorted face order, -1
// empty; K in 1..16; `margin` (window + 2, rounded by the caller) widens the
// cull band. tested, if not null, a uint64 the (pixel, face) pairs of the
// warps' lists are added to (one atomic a block).
extern "C" int st3d_raster_topk(const void* coeffs, const void* bounds,
                                void* ids, void* tested, int N, int H, int W,
                                int f_pad, int n_chunks, int K, float window,
                                float margin, void* stream) {
  return launch_k(coeffs, bounds, ids, tested, N, H, W, f_pad, n_chunks, K,
                  window, margin, stream, false);
}

// The same ids by the earlier walk (every face of every chunk in band).
extern "C" int st3d_raster_topk_every_face(const void* coeffs,
                                           const void* bounds, void* ids,
                                           int N, int H, int W, int f_pad,
                                           int n_chunks, int K, float window,
                                           float margin, void* stream) {
  return launch_k(coeffs, bounds, ids, nullptr, N, H, W, f_pad, n_chunks, K,
                  window, margin, stream, true);
}
