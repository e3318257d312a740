// Hard-mode visibility on 2D pixel tiles: per pixel, the covering face of
// largest 1/z, over faces in Morton order with chunks culled in x and y.
//
// Replaces the TPU kernel st3d/kernels/raster_pallas.py::_raster2d_kernel
// (entry _rasterize_pallas2d_impl, K9). Preprocessing stays outside the
// kernel (torch ops, as it was XLA; st3d_torch/kernels/raster.py::
// preprocess_2d): faces are sorted by the Morton code of their bbox centre,
// so consecutive faces are near each other in both axes, and cut into
// 128-face chunks whose (ymin, ymax, xmin, xmax) bounds ride along. Each
// face carries the 12 affine coefficients of K1 (raster.py::face_coeffs).
//
// Work layout: one thread per pixel, one block per 16 x 16 pixel tile (the
// TPU kernel used 8 x 128 to fill its vector registers; a square tile is
// what a 2D cull wants). A block walks the chunks in sorted order, skips a
// chunk whose bounds miss the tile's rows or columns (uniform across the
// block), stages its 12 x 128 coefficients in shared memory and tests every
// face against its pixel. Selection is a strict '>' on 1/z over faces in
// sorted order starting from 0, which is the TPU kernel's "first max within
// a chunk, strict '>' across chunks": the lowest Morton-sorted id wins exact
// ties. The result depends on the chunk size and the tile only where
// rounding lets a face cover a pixel centre just outside its own bbox.
//
// Exactness: the planes are evaluated as K1 evaluates them (__fmul_rn,
// __fadd_rn, built with -fmad=false), so the plain torch version, which
// tests the same (pixel, chunk) pairs, gives the same ids bit for bit.
//
// What bounds it on an H100: compute per covered (pixel, face) pair, 8
// multiplies, 8 adds and 4 compares, on the pairs the 2D cull leaves.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;     // faces per chunk (the wrapper pads to it)
constexpr int TW = 16;         // tile width in pixels
constexpr int TH = 16;         // tile height in pixels
constexpr int THREADS = TW * TH;
constexpr int NROWS = 12;      // affine coefficient rows used in hard mode
constexpr float BIG_Z = 1e10f;

__device__ __forceinline__ float affine(float px, float py, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__global__ void __launch_bounds__(THREADS)
raster_2d_kernel(const float* __restrict__ coeffs,
                 const float* __restrict__ bounds, int* __restrict__ p2f,
                 float* __restrict__ zbuf, int H, int W, int f_pad,
                 int n_chunks) {
  __shared__ float sc[NROWS][CHUNK];
  const int v = blockIdx.z;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const int x = tx0 + threadIdx.x % TW;
  const int y = ty0 + threadIdx.x / TW;
  const bool inside = x < W && y < H;
  const float px = (float)x;
  const float py = (float)y;
  const float row0 = (float)ty0, row1 = (float)(ty0 + TH - 1);
  const float col0 = (float)tx0, col1 = (float)(tx0 + TW - 1);

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
    for (int i = threadIdx.x; i < NROWS * CHUNK; i += THREADS) {
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

}  // namespace

// coeffs (N, 20, f_pad) float32 in Morton order, rows 0..11 read; bounds
// (N, 4, n_chunks) float32 = [ymin; ymax; xmin; xmax] per chunk; p2f
// (N, H*W) int32 in sorted face order; zbuf (N, H*W) float32.
extern "C" int st3d_raster_2d(const void* coeffs, const void* bounds,
                              void* p2f, void* zbuf, int N, int H, int W,
                              int f_pad, int n_chunks, void* stream) {
  dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH - 1) / TH),
            (unsigned)N);
  raster_2d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)bounds, (int*)p2f, (float*)zbuf, H,
      W, f_pad, n_chunks);
  return (int)cudaGetLastError();
}
