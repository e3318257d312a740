// Hard-mode visibility: per pixel, the covering face of largest 1/z.
//
// Replaces the TPU kernel st3d/kernels/raster_pallas.py::_raster_kernel
// (entry _rasterize_pallas_impl) in hard mode. Preprocessing stays outside
// the kernel (torch ops, as it was XLA): each face becomes 12 affine
// coefficients (screen barycentrics b0, b1, b2 and the 1/z plane, see
// st3d_torch/kernels/raster.py::face_coeffs), faces are sorted by their top
// row and cut into 128-face chunks whose [ymin, ymax] row band rides along.
//
// Selection is a strict '>' on 1/z over faces in sorted order starting from
// 0, which is the TPU kernel's "first max within a chunk, strict '>' across
// chunks": the lowest sorted id wins ties. Sorted ids are mapped back to
// mesh ids by the wrapper.
//
// Work layout (raster_walk.cuh): one thread per pixel, one block per 256
// consecutive pixels of the flat row-major index. The chunks whose row band
// meets the block's rows are found by a warp ballot over 32 bands; each is
// staged face-major (rows 0-11, 12 floats a face) by cp.async into the free
// one of two slots while the previous chunk is tested. Each warp then tests,
// in sorted order, only the faces that can still change one of its 32
// pixels. It drops a face when, over the warp's pixel rectangle
// [col0, col1] x [row0, row1] (a warp that wraps a row takes [0, W-1] x its
// rows), the corner value of b0, b1 or b2 is < 0, or the corner value of
// 1/z is <= s_w, the least best 1/z over the warp's pixels at the chunk's
// start. Both drops are exact, in the kernel's own arithmetic:
//   - affine(px, py, a, b, c) = fl(fl(fl(px*a) + fl(py*b)) + c) is monotone
//     in px and in py separately, since a product by a fixed factor and a
//     sum with a fixed term are monotone and so is rounding. Its largest
//     value over the rectangle is therefore the one at the corner
//     (col1 if a >= 0 else col0, row1 if b >= 0 else row0), computed by
//     the same rounded operations (corner_max);
//   - a barycentric whose corner value is < 0 is < 0 at every pixel of the
//     warp, so the face covers none of them;
//   - if 1/z's corner value is <= s_w, then at every pixel 1/z <= s_w <=
//     the pixel's best, and the strict '>' cannot pick the face, now or
//     later (the best only rises; it starts at 0, so faces whose 1/z is
//     never positive over the warp go too).
// A NaN corner value compares false and keeps the face. So the kept faces,
// tested in sorted order with the strict '>', select exactly what testing
// every face selects.
// st3d_raster_hard_every_face keeps the earlier walk (every face of every
// chunk in band, 12 x 128 rows staged between two barriers): launched by no
// route, the twin chip_smoke.py holds this kernel against.
//
// Row bands: a launch may cover rows [row0, row0 + H) of a taller image
// (the tiled render's band). Each pixel's py, and the rows the block tests
// chunk bands against, are image rows, so a band's outputs equal those
// rows of the whole frame's, bit for bit, with the same coefficients.
//
// Exactness: b = px*A + py*B + C is evaluated as two rounded products and
// two rounded sums in that order (__fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA), the same operations as the plain torch version,
// so pix_to_face equals it bit for bit. The file is also built with
// -fmad=false.
//
// What bounds it on an H100: latency, not the card's rates. Its bytes (the
// 12 coefficient rows once, the bounds, 8 bytes a pixel out) take some
// 3 us and its needed pairs (each pixel against the faces whose bbox holds
// it, 20 operations a pair) less. Per tested (pixel, face) pair the kernel
// does 8 multiplies, 8 adds and 4 compares, and the lists cut those pairs
// to a few per needed one; what is left is per chunk and warp: the ballot,
// the staging of 6 KB by cp.async, two barriers and the list (16 corner
// evaluations a lane). Five blocks an SM (__launch_bounds__, as K1-soft
// and K7) keep the staging of one block under the tests of the others.

#include <cuda_runtime.h>

#include "raster_walk.cuh"

namespace {

using namespace st3d_walk;

constexpr float BIG_Z = 1e10f;

__global__ void __launch_bounds__(TILE, 5)
raster_hard_kernel(const float* __restrict__ coeffs,
                   const float* __restrict__ bounds, int* __restrict__ p2f,
                   float* __restrict__ zbuf,
                   unsigned long long* __restrict__ tested, int H, int W,
                   int f_pad, int n_chunks, int row0) {
  __shared__ __align__(16) float buf[2][CHUNK * HARD_REC];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const long long last = min(t0 + TILE - 1, hw - 1);
  const float px = (float)(p % W);
  const float py = (float)(p / W + row0);
  const bool live = p < hw;
  const Box box = warp_box(px, py, W);

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 2 * n_chunks;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  ChunkScan scan(bv, n_chunks, (float)(t0 / W + row0),
                 (float)(last / W + row0));
  const unsigned long long pairs = hard_walk(scan, buf, cv, f_pad, n_chunks,
                                             box, px, py, live, best, fid);
  add_tested(tested, pairs);
  if (live) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
  }
}

// The earlier walk: every face of every chunk in band, the chunk's 12 x 128
// rows staged between two barriers.
__global__ void __launch_bounds__(TILE)
raster_hard_every_face_kernel(const float* __restrict__ coeffs,
                              const float* __restrict__ bounds,
                              int* __restrict__ p2f, float* __restrict__ zbuf,
                              int H, int W, int f_pad, int n_chunks) {
  __shared__ float sc[HARD_ROWS][CHUNK];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const long long last = min(t0 + TILE - 1, hw - 1);
  const float row0 = (float)(t0 / W);
  const float row1 = (float)(last / W);
  const float px = (float)(p % W);
  const float py = (float)(p / W);

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 2 * n_chunks;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  for (int c = 0; c < n_chunks; ++c) {
    const float ymin = bv[c];
    const float ymax = bv[n_chunks + c];
    if (!(ymax >= row0 && ymin <= row1)) continue;   // same for the block
    __syncthreads();   // the previous chunk's readers are done with sc
    for (int i = threadIdx.x; i < HARD_ROWS * CHUNK; i += TILE) {
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
      }
    }
  }
  if (p < hw) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
  }
}

}  // namespace

// coeffs (N, 20, f_pad) float32, rows 0..11 read; bounds (N, 2, n_chunks)
// float32; p2f (N, H*W) int32 in sorted face order; zbuf (N, H*W) float32,
// the image rows [row0, row0 + H). tested, if not null, a uint64 the
// (pixel, face) pairs of the warps' lists are added to (one atomic a
// block).
extern "C" int st3d_raster_hard(const void* coeffs, const void* bounds,
                                void* p2f, void* zbuf, void* tested, int N,
                                int H, int W, int f_pad, int n_chunks,
                                int row0, void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  raster_hard_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)bounds, (int*)p2f, (float*)zbuf,
      (unsigned long long*)tested, H, W, f_pad, n_chunks, row0);
  return (int)cudaGetLastError();
}

// The same outputs by the earlier walk (every face of every chunk in band).
extern "C" int st3d_raster_hard_every_face(const void* coeffs,
                                           const void* bounds, void* p2f,
                                           void* zbuf, int N, int H, int W,
                                           int f_pad, int n_chunks,
                                           void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  raster_hard_every_face_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)bounds, (int*)p2f, (float*)zbuf, H,
      W, f_pad, n_chunks);
  return (int)cudaGetLastError();
}
