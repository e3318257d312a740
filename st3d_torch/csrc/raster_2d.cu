// Hard-mode visibility on 2D pixel tiles: per pixel, the covering face of
// largest 1/z, over faces in Morton order with chunks culled in x and y.
//
// Replaces the TPU kernel st3d/kernels/raster_pallas.py::_raster2d_kernel
// (entry _rasterize_pallas2d_impl, K9). Preprocessing stays outside the
// kernel (torch ops, as it was XLA; st3d_torch/kernels/raster.py::
// preprocess_2d): faces are sorted by the reference's Morton code of their
// bbox centre and cut into 128-face chunks whose (ymin, ymax, xmin, xmax)
// bounds ride along. Each face carries the 12 affine coefficients of K1
// (raster.py::face_coeffs). The reference's codes spread only 8 of their
// 10 bits, so a chunk gathers faces from all over the mesh and its bounds
// meet many tiles; the order is kept, since it decides which face wins an
// exact 1/z tie.
//
// Selection is a strict '>' on 1/z over faces in sorted order starting from
// 0, which is the TPU kernel's "first max within a chunk, strict '>' across
// chunks": the lowest Morton-sorted id wins exact ties. A chunk is tested on
// a tile exactly where raster.py::cull_2d says (its bounds meet the tile's
// rows and columns).
//
// Work layout: one thread per pixel, one block per 16 x 16 pixel tile, the
// walk of K1 (raster_walk.cuh::hard_walk; see raster_hard.cu):
//   - each warp finds the block's chunks on its own, 32 chunk bounds a
//     ballot (ChunkScan2D, the x-and-y rule);
//   - a chunk's rows 0-11 are copied face-major by cp.async into the free
//     one of two shared-memory slots while the previous chunk is tested;
//   - each warp owns an 8 x 4 rectangle of the tile and drops a face when,
//     over the rectangle, the corner value of b0, b1 or b2 is < 0 or that
//     of 1/z is <= s_w, the least best 1/z over its pixels at the chunk's
//     start. raster_hard.cu's lemma holds for any rectangle (rounding is
//     monotone in px and in py separately), so the drops are exact and the
//     kept faces, tested in sorted order, select what every face selects.
//     Lanes past the frame only widen the rectangle. 8 x 4 and not 16 x 2
//     (the earlier kernel's warps): on the CPU model's scenes
//     (tests/test_torch_2d_walk.py) its lists hold about half the pairs,
//     and on the level-4 sphere at 512² x 4 the corner rule alone keeps
//     4.32 M pairs against 8.04 M, since a face's edges rule out a square
//     rectangle more often than a long one.
// st3d_raster_2d_every_face keeps the earlier kernel (every face of every
// chunk the cull leaves, 12 x 128 rows staged between two barriers):
// launched by no route, the twin chip_smoke.py holds this kernel against.
//
// Exactness: the planes are evaluated as K1 evaluates them (__fmul_rn,
// __fadd_rn, built with -fmad=false), so the plain torch version, which
// tests the same (pixel, chunk) pairs, gives the same ids bit for bit.
//
// What bounds it on an H100: latency, as K1. Its bytes (12 coefficient rows
// once, the bounds, 8 bytes a pixel out) take some 3 us and its needed
// pairs less. Per tested pair it does 8 multiplies, 8 adds and 4 compares;
// per (tile, chunk) pair the ballot, 6 KB of cp.async, two barriers and a
// list of 16 corner evaluations a lane. The reference order leaves about
// seven times K1's (block, chunk) pairs, so those dominate. Five blocks an
// SM (__launch_bounds__) keep one block's staging under the others' tests.

#include <cuda_runtime.h>

#include "raster_walk.cuh"

namespace {

using namespace st3d_walk;

constexpr int TS = 16;          // tile side in pixels (raster.py TILE_2D)
constexpr int WW = 8;           // a warp's rectangle: WW columns ...
constexpr int WH = 32 / WW;     // ... by WH rows
constexpr int WARPS_X = TS / WW;
constexpr float BIG_Z = 1e10f;
static_assert(TS * TS == TILE, "one thread per pixel of the tile");

__global__ void __launch_bounds__(TILE, 5)
raster_2d_kernel(const float* __restrict__ coeffs,
                 const float* __restrict__ bounds, int* __restrict__ p2f,
                 float* __restrict__ zbuf,
                 unsigned long long* __restrict__ tested, int H, int W,
                 int f_pad, int n_chunks) {
  __shared__ __align__(16) float buf[2][CHUNK * HARD_REC];
  const int v = blockIdx.z;
  const int tx0 = blockIdx.x * TS;
  const int ty0 = blockIdx.y * TS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int wx0 = tx0 + (warp % WARPS_X) * WW;
  const int wy0 = ty0 + (warp / WARPS_X) * WH;
  const int x = wx0 + lane % WW;
  const int y = wy0 + lane / WW;
  const bool live = x < W && y < H;
  const Box box{(float)wx0, (float)(wx0 + WW - 1), (float)wy0,
                (float)(wy0 + WH - 1)};

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 4 * n_chunks;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  ChunkScan2D scan(bv, n_chunks, (float)ty0, (float)(ty0 + TS - 1),
                   (float)tx0, (float)(tx0 + TS - 1));
  const unsigned long long pairs =
      hard_walk(scan, buf, cv, f_pad, n_chunks, box, (float)x, (float)y,
                live, best, fid);
  add_tested(tested, pairs);
  if (live) {
    const long long p = (long long)v * H * W + (long long)y * W + x;
    const bool hit = best > 0.f;
    p2f[p] = hit ? fid : -1;
    zbuf[p] = hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
  }
}

// The earlier kernel: every face of every chunk the cull leaves, the
// chunk's 12 x 128 rows staged between two barriers.
__global__ void __launch_bounds__(TILE)
raster_2d_every_face_kernel(const float* __restrict__ coeffs,
                            const float* __restrict__ bounds,
                            int* __restrict__ p2f, float* __restrict__ zbuf,
                            int H, int W, int f_pad, int n_chunks) {
  __shared__ float sc[HARD_ROWS][CHUNK];
  const int v = blockIdx.z;
  const int tx0 = blockIdx.x * TS;
  const int ty0 = blockIdx.y * TS;
  const int x = tx0 + threadIdx.x % TS;
  const int y = ty0 + threadIdx.x / TS;
  const bool inside = x < W && y < H;
  const float px = (float)x;
  const float py = (float)y;
  const float row0 = (float)ty0, row1 = (float)(ty0 + TS - 1);
  const float col0 = (float)tx0, col1 = (float)(tx0 + TS - 1);

  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 4 * n_chunks;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  for (int c = 0; c < n_chunks; ++c) {
    const float ymin = bv[c];
    const float ymax = bv[n_chunks + c];
    const float xmin = bv[2 * n_chunks + c];
    const float xmax = bv[3 * n_chunks + c];
    // The same for the whole block.
    if (!(ymax >= row0 && ymin <= row1 && xmax >= col0 && xmin <= col1)) {
      continue;
    }
    __syncthreads();   // the previous chunk's readers are done with sc
    for (int i = threadIdx.x; i < HARD_ROWS * CHUNK; i += TILE) {
      const int r = i / CHUNK;
      const int f = i % CHUNK;
      sc[r][f] = cv[(long long)r * f_pad + (long long)c * CHUNK + f];
    }
    __syncthreads();
    if (inside) {
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
  if (inside) {
    const long long p = (long long)v * H * W + (long long)y * W + x;
    const bool hit = best > 0.f;
    p2f[p] = hit ? fid : -1;
    zbuf[p] = hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
  }
}

dim3 tile_grid(int N, int H, int W) {
  return dim3((unsigned)((W + TS - 1) / TS), (unsigned)((H + TS - 1) / TS),
              (unsigned)N);
}

}  // namespace

// coeffs (N, 20, f_pad) float32 in Morton order, rows 0..11 read; bounds
// (N, 4, n_chunks) float32 = [ymin; ymax; xmin; xmax] per chunk; p2f
// (N, H*W) int32 in sorted face order; zbuf (N, H*W) float32. tested, if
// not null, a uint64 the (pixel, face) pairs of the warps' lists are added
// to (one atomic a block).
extern "C" int st3d_raster_2d(const void* coeffs, const void* bounds,
                              void* p2f, void* zbuf, void* tested, int N,
                              int H, int W, int f_pad, int n_chunks,
                              void* stream) {
  raster_2d_kernel<<<tile_grid(N, H, W), TILE, 0, (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)bounds, (int*)p2f, (float*)zbuf,
      (unsigned long long*)tested, H, W, f_pad, n_chunks);
  return (int)cudaGetLastError();
}

// The same outputs by the earlier kernel (every face of every culled chunk).
extern "C" int st3d_raster_2d_every_face(const void* coeffs,
                                         const void* bounds, void* p2f,
                                         void* zbuf, int N, int H, int W,
                                         int f_pad, int n_chunks,
                                         void* stream) {
  raster_2d_every_face_kernel<<<tile_grid(N, H, W), TILE, 0,
                                (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)bounds, (int*)p2f, (float*)zbuf, H,
      W, f_pad, n_chunks);
  return (int)cudaGetLastError();
}
