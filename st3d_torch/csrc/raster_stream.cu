// Streaming visibility for large meshes: K1's outputs (hard, or soft with the
// nearest face) with every tile walking its own chunk range.
//
// Replaces the TPU kernel st3d/kernels/raster_pallas.py::_stream_kernel
// (entry _rasterize_pallas_stream_impl). The TPU kernel exists because a
// large mesh's coefficients (327,680 faces: 26 MB) do not fit VMEM; on the
// H100 the coefficients stay in device memory either way, and what this
// kernel keeps from its design is the per-tile [c_lo, c_hi] chunk range
// (computed by the wrapper with torch ops, raster_pallas.py:605-624) and
// the double-buffered staging of each chunk into shared memory.
//
// Work layout: one thread per pixel, one block per 256 consecutive pixels of
// the flat row-major index; the block reads the range of its `cull`-pixel
// tile and walks every chunk in it (chunks inside the range whose band
// misses the tile are tested too, as on the TPU). While chunk s is tested,
// chunk s+1's coefficient rows (12 hard, 19 soft; 128 floats each) are
// copied into the other shared-memory slot with cp.async (16 bytes per
// copy), so the load of the next chunk overlaps the current one's tests.
//
// Selection and rounding are K1's (raster_hard.cu, raster_soft.cu): strict
// '>' in sorted order over 1/z from 0 for the covering face, over the gated
// signed distance from -3e38 (id 0) for the nearest face; every affine value
// is two rounded products and two rounded sums (__fmul_rn / __fadd_rn) and
// the file is built with -fmad=false. So pix_to_face and zbuf equal K1's,
// and everything equals the plain version, bit for bit.
//
// What bounds it on an H100: compute per tested (pixel, face) pair, as K1,
// plus the faces of in-range chunks that K1 would cull. The ranges keep the
// chunk loop to a tile's own rows instead of the whole mesh.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;     // faces per chunk (the wrapper pads to it)
constexpr int TILE = 256;      // pixels per block
constexpr float BIG_Z = 1e10f;
constexpr float NEG_INIT = -3.0e38f;

__device__ __forceinline__ float affine(float px, float py, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of chunk `c`'s first NROWS rows into `slot`.
template <int NROWS>
__device__ __forceinline__ void stage(float (*slot)[CHUNK],
                                      const float* __restrict__ cv, int f_pad,
                                      int c) {
  constexpr int PER_ROW = CHUNK / 4;   // 16-byte copies per row
  for (int i = threadIdx.x; i < NROWS * PER_ROW; i += TILE) {
    const int r = i / PER_ROW;
    const int q = i % PER_ROW;
    cp_async16(&slot[r][q * 4],
               cv + (long long)r * f_pad + (long long)c * CHUNK + q * 4);
  }
  cp_async_commit();
}

template <bool SOFT>
__global__ void __launch_bounds__(TILE)
raster_stream_kernel(const float* __restrict__ coeffs,
                     const int* __restrict__ ranges, int* __restrict__ p2f,
                     float* __restrict__ zbuf, int* __restrict__ near, int H,
                     int W, int f_pad, int n_tiles, int cull) {
  constexpr int NROWS = SOFT ? 19 : 12;
  __shared__ __align__(16) float buf[2][NROWS][CHUNK];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const float px = (float)(p % W);
  const float py = (float)(p / W);
  const int* rv = ranges + ((long long)v * n_tiles + t0 / cull) * 2;
  const int c_lo = rv[0];
  const int n_sc = rv[1] - c_lo + 1;   // <= 0 when nothing overlaps
  const float* cv = coeffs + (long long)v * 20 * f_pad;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  float sbest = NEG_INIT;
  int sid = 0;
  if (n_sc > 0) stage<NROWS>(buf[0], cv, f_pad, c_lo);
  for (int s = 0; s < n_sc; ++s) {
    if (s + 1 < n_sc) {
      stage<NROWS>(buf[(s + 1) & 1], cv, f_pad, c_lo + s + 1);
      cp_async_wait<1>();   // chunk s has landed, s+1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*sc)[CHUNK] = buf[s & 1];
    const int c = c_lo + s;
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
        if (SOFT) {
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
    __syncthreads();   // slot s&1 is refilled at iteration s+1
  }
  if (p < hw) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
    if (SOFT) near[(long long)v * hw + p] = sid;
  }
}

}  // namespace

// coeffs (N, 20, f_pad) float32, 16-byte aligned; ranges (N, n_tiles, 2)
// int32 [c_lo, c_hi] per `cull`-pixel tile (a multiple of 256, or at least
// H*W); p2f (N, H*W) int32 sorted ids; zbuf (N, H*W) float32; near
// (N, H*W) int32, written only when soft != 0.
extern "C" int st3d_raster_stream(const void* coeffs, const void* ranges,
                                  void* p2f, void* zbuf, void* near, int N,
                                  int H, int W, int f_pad, int n_tiles,
                                  int cull, int soft, void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  cudaStream_t st = (cudaStream_t)stream;
  if (soft) {
    raster_stream_kernel<true><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const int*)ranges, (int*)p2f, (float*)zbuf,
        (int*)near, H, W, f_pad, n_tiles, cull);
  } else {
    raster_stream_kernel<false><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const int*)ranges, (int*)p2f, (float*)zbuf,
        (int*)near, H, W, f_pad, n_tiles, cull);
  }
  return (int)cudaGetLastError();
}
