// Soft-mode visibility: K1's hard outputs plus, per pixel, the nearest face.
//
// Replaces the TPU kernel st3d/kernels/raster_pallas.py::_raster_kernel
// (entry _rasterize_pallas_impl) with soft=True. Preprocessing stays outside
// the kernel (st3d_torch/kernels/raster.py: face coefficients sorted by top
// row, 128-face chunks with their [ymin, ymax] row band).
//
// Per pixel, over the faces of every chunk whose row band meets the cull
// band (the rows of the pixel's `cull`-pixel tile widened by `margin`):
//   - hard: the covering face of largest 1/z (strict '>' from 0, sorted
//     order), exactly as raster_hard.cu;
//   - nearest: the face of largest signed distance
//       d = min(b0*h0, b1*h1, b2*h2, bbox distance)
//     by strict '>' from -3e38 and id 0, in sorted order. That is the TPU
//     kernel's "first argmax within a chunk, strict '>' across chunks".
// The cull band is the JAX package's 1024-pixel tile (the wrapper passes
// it): for a pixel farther than the margin from every face, the nearest
// face is whichever survives the cull, so the band is part of the result.
//
// Work layout (raster_walk.cuh, soft_walk): one thread per pixel, one block
// per 256 consecutive pixels (a block lies inside one cull tile, so the
// chunk test is uniform across it); the next chunk to test is found by a
// warp ballot over 32 bands and staged face-major by cp.async while the
// previous one is tested. Each warp then tests only the faces that can
// still change one of its 32 pixels: it drops a face when K1's exact
// corner rule rules it out as the covering face (over the warp's pixel
// rectangle, no barycentric's corner value is >= 0, or 1/z's corner value
// is <= the least best 1/z over the warp's pixels; raster_hard.cu) AND
// ub <= s_w, where ub is the face's bbox upper bound over the rectangle
// and s_w the least nearest distance over the warp's pixels at the chunk's
// start: then at every pixel d <= bbox distance <= ub <= s_w <= the
// pixel's best, so the strict '>' cannot pick the face, now or later (the
// best only rises). Inside the list a pixel also skips a face that the
// corner rule ruled out and whose own bbox distance is <= its best so far,
// by the same argument. The bbox alone says nothing of covering: a
// sliver's rounded barycentrics can all be >= 0 at pixels many pixels
// outside its bbox, and such a face can win there.
// st3d_raster_soft_every_face keeps the earlier walk (every face of every
// chunk in band, 19 x 128 rows staged between two barriers): launched by no
// route, the twin chip_smoke.py holds this kernel against.
//
// Exactness: every affine value is two rounded products and two rounded
// sums in the plain version's order (__fmul_rn / __fadd_rn, never contracted
// into an FMA); the file is also built with -fmad=false. So p2f and nearest
// equal the plain version bit for bit.
//
// What bounds it on an H100: compute per tested (pixel, face) pair, 11
// multiplies, 12 adds/subtracts, 7 min and 5 compares, and a face's five
// broadcast loads per warp. Far pixels (most of a frame around a mesh) keep
// the faces of their band until their nearest distance rises past them.
// The lists leave so few pairs that the walk's latency (staging, barriers)
// weighs as much: five blocks an SM (__launch_bounds__) hide it better than
// the registers the compiler would otherwise take.

#include <cuda_runtime.h>

#include "raster_walk.cuh"

namespace {

using namespace st3d_walk;

constexpr float BIG_Z = 1e10f;

__global__ void __launch_bounds__(TILE, 5)
raster_soft_kernel(const float* __restrict__ coeffs,
                   const float* __restrict__ bounds, int* __restrict__ p2f,
                   float* __restrict__ zbuf, int* __restrict__ near,
                   unsigned long long* __restrict__ tested, int H, int W,
                   int f_pad, int n_chunks, int cull, float margin) {
  __shared__ __align__(16) float buf[2][CHUNK * REC];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const long long c0 = (t0 / cull) * cull;
  const long long last = min(c0 + cull - 1, hw - 1);
  const float lo = __fsub_rn((float)(c0 / W), margin);
  const float hi = __fadd_rn((float)(last / W), margin);
  const float px = (float)(p % W);
  const float py = (float)(p / W);
  const bool live = p < hw;
  const Box box = warp_box(px, py, W);

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 2 * n_chunks;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  float sbest = NEG_INIT;
  int sid = 0;
  ChunkScan scan(bv, n_chunks, lo, hi);
  const unsigned long long pairs =
      soft_walk(scan, buf, cv, f_pad, n_chunks, box, px, py, live, best, fid,
                sbest, sid);
  add_tested(tested, pairs);
  if (live) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
    near[(long long)v * hw + p] = sid;
  }
}

// The earlier walk: every face of every chunk in band, the chunk's 19 x 128
// rows staged between two barriers.
__global__ void __launch_bounds__(TILE)
raster_soft_every_face_kernel(const float* __restrict__ coeffs,
                              const float* __restrict__ bounds,
                              int* __restrict__ p2f, float* __restrict__ zbuf,
                              int* __restrict__ near, int H, int W, int f_pad,
                              int n_chunks, int cull, float margin) {
  __shared__ float sc[NROWS][CHUNK];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const long long c0 = (t0 / cull) * cull;
  const long long last = min(c0 + cull - 1, hw - 1);
  const float lo = __fsub_rn((float)(c0 / W), margin);
  const float hi = __fadd_rn((float)(last / W), margin);
  const float px = (float)(p % W);
  const float py = (float)(p / W);

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 2 * n_chunks;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  float sbest = NEG_INIT;
  int sid = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const float ymin = bv[c];
    const float ymax = bv[n_chunks + c];
    if (!(ymax >= lo && ymin <= hi)) continue;   // same for the block
    __syncthreads();   // the previous chunk's readers are done with sc
    for (int i = threadIdx.x; i < NROWS * CHUNK; i += TILE) {
      const int r = i / CHUNK;
      const int f = i % CHUNK;
      sc[r][f] = cv[(long long)r * f_pad + (long long)c * CHUNK + f];
    }
    __syncthreads();
    if (p < hw) {
      for (int f = 0; f < CHUNK; ++f) {
        const float b0 = affine(px, py, sc[0][f], sc[1][f], sc[2][f]);
        const float b1 = affine(px, py, sc[3][f], sc[4][f], sc[5][f]);
        const float b2 = affine(px, py, sc[6][f], sc[7][f], sc[8][f]);
        const float iz = affine(px, py, sc[9][f], sc[10][f], sc[11][f]);
        if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f && iz > best) {
          best = iz;
          fid = c * CHUNK + f;
        }
        const float sd = fminf(fminf(__fmul_rn(b0, sc[12][f]),
                                     __fmul_rn(b1, sc[13][f])),
                               __fmul_rn(b2, sc[14][f]));
        const float bb = fminf(fminf(__fsub_rn(px, sc[15][f]),
                                     __fsub_rn(sc[16][f], px)),
                               fminf(__fsub_rn(py, sc[17][f]),
                                     __fsub_rn(sc[18][f], py)));
        const float d = fminf(sd, bb);
        if (d > sbest) {
          sbest = d;
          sid = c * CHUNK + f;
        }
      }
    }
  }
  if (p < hw) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
    near[(long long)v * hw + p] = sid;
  }
}

}  // namespace

// coeffs (N, 20, f_pad) float32, rows 0..18 read; bounds
// (N, 2, n_chunks) float32; p2f, near (N, H*W) int32 in sorted face order;
// zbuf (N, H*W) float32. `cull` is the cull tile in pixels (a multiple of
// 256, or at least H*W); `margin` widens its row band. tested, if not
// null, a uint64 the (pixel, face) pairs of the warps' lists are added to
// (one atomic a block).
extern "C" int st3d_raster_soft(const void* coeffs, const void* bounds,
                                void* p2f, void* zbuf, void* near,
                                void* tested, int N, int H, int W, int f_pad,
                                int n_chunks, int cull, float margin,
                                void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  raster_soft_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)bounds, (int*)p2f, (float*)zbuf,
      (int*)near, (unsigned long long*)tested, H, W, f_pad, n_chunks, cull,
      margin);
  return (int)cudaGetLastError();
}

// The same outputs by the earlier walk (every face of every chunk in band).
extern "C" int st3d_raster_soft_every_face(const void* coeffs,
                                           const void* bounds, void* p2f,
                                           void* zbuf, void* near, int N,
                                           int H, int W, int f_pad,
                                           int n_chunks, int cull,
                                           float margin, void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  raster_soft_every_face_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)bounds, (int*)p2f, (float*)zbuf,
      (int*)near, H, W, f_pad, n_chunks, cull, margin);
  return (int)cudaGetLastError();
}
