// Streaming visibility for large meshes: K1's outputs (hard, or soft with the
// nearest face) with every tile walking its own chunk range.
//
// Replaces the TPU kernel st3d/kernels/raster_pallas.py::_stream_kernel
// (entry _rasterize_pallas_stream_impl). The TPU kernel exists because a
// large mesh's coefficients (327,680 faces: 26 MB) do not fit VMEM; on the
// H100 the coefficients stay in device memory either way, and what this
// kernel keeps from its design is the per-tile [c_lo, c_hi] chunk range
// (computed by the wrapper with torch ops, raster_pallas.py:605-624), every
// chunk of which the TPU kernel tests at every pixel of the tile.
//
// Work layout (raster_walk.cuh): one thread per pixel, one block per 256
// consecutive pixels of the flat row-major index; the block walks every
// chunk of its `cull`-pixel tile's range (RangeScan), each staged
// face-major by cp.async into the free one of two shared-memory slots while
// the previous one is tested. Once the vertices move, one stretched face
// widens its chunk's [ymin, ymax] band and the ranges reach far past the
// tiles' own chunks; testing every face of them took most of a step. So
// each warp tests only the faces that can change one of its 32 pixels, by
// K1's lists: hard, the exact corner rule (hard_walk; the lemma is in
// raster_hard.cu); soft, that rule for the covering face and the bbox
// bound against the warp's least nearest distance for the nearest face
// (soft_walk; raster_soft.cu). No chunk of the range is skipped and no face
// is dropped by its bbox alone: a sliver's rounded barycentrics can all be
// >= 0 at pixels many pixels outside its bbox, even outside its chunk's
// row band, and the TPU kernel's walk lets it win there. (K1 tests only
// the chunks whose band meets the block's rows, so at such a pixel its
// result differs from this one's, as the JAX package's K1 and K6 do.)
// st3d_raster_stream_every_chunk keeps the TPU kernel's walk (every face of
// every chunk of the range, rows staged between two barriers): launched by
// no route, the twin chip_smoke.py holds the new walk against.
//
// A launch may cover rows [row0, row0 + H) of a taller image, as K1's does
// (raster_hard.cu): each pixel's py is its image row, and the wrapper
// makes the ranges for those rows.
//
// Selection and rounding are K1's (raster_hard.cu, raster_soft.cu): strict
// '>' in sorted order over 1/z from 0 for the covering face, over the gated
// signed distance from -3e38 (id 0) for the nearest face; every affine value
// is two rounded products and two rounded sums (__fmul_rn / __fadd_rn) and
// the file is built with -fmad=false. So everything equals the plain
// version and the twin, bit for bit.
//
// What bounds it on an H100: as K1, the walk's latency per chunk and warp
// (the ballot-free range, the staging of 6 KB (hard) or 10 KB (soft) by
// cp.async, two barriers, the list's corner evaluations) more than the
// tested pairs; a tile's range holds more chunks than its band does.

#include <cuda_runtime.h>

#include "raster_walk.cuh"

namespace {

using namespace st3d_walk;

constexpr float BIG_Z = 1e10f;

// K6: the walk of every chunk of the block's range, by K1's lists.
template <bool SOFT>
__global__ void __launch_bounds__(TILE, 5)
raster_stream_kernel(const float* __restrict__ coeffs,
                     const int* __restrict__ ranges, int* __restrict__ p2f,
                     float* __restrict__ zbuf, int* __restrict__ near_out,
                     unsigned long long* __restrict__ tested, int H, int W,
                     int f_pad, int n_chunks, int n_tiles, int cull,
                     int row0) {
  __shared__ __align__(16) float buf[2][CHUNK * (SOFT ? REC : HARD_REC)];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const float px = (float)(p % W);
  const float py = (float)(p / W + row0);
  const bool live = p < hw;
  const Box box = warp_box(px, py, W);
  const int* rv = ranges + ((long long)v * n_tiles + t0 / cull) * 2;
  RangeScan scan{rv[0], rv[1], n_chunks};   // c_lo > c_hi when none
  const float* cv = coeffs + (long long)v * 20 * f_pad;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  float sbest = NEG_INIT;
  int sid = 0;
  unsigned long long pairs;
  if constexpr (SOFT) {
    pairs = soft_walk(scan, buf, cv, f_pad, n_chunks, box, px, py, live,
                      best, fid, sbest, sid);
  } else {
    pairs = hard_walk(scan, buf, cv, f_pad, n_chunks, box, px, py, live,
                      best, fid);
  }
  add_tested(tested, pairs);
  if (live) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
    if (SOFT) near_out[(long long)v * hw + p] = sid;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The twin's copy of chunk `c`'s rows 0 .. ROWS-1 into `slot`, row-major.
template <int ROWS>
__device__ __forceinline__ void stage_chunk(float (*slot)[CHUNK],
                                            const float* __restrict__ cv,
                                            int f_pad, int c) {
  constexpr int PER_ROW = CHUNK / 4;   // 16-byte copies per row
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += TILE) {
    const int r = i / PER_ROW;
    const int q = i % PER_ROW;
    cp_async16(&slot[r][q * 4],
               cv + (long long)r * f_pad + (long long)c * CHUNK + q * 4);
  }
  cp_async_commit();
}

// The TPU kernel's walk: every face of every chunk of the range at every
// pixel, the next chunk's rows copied while the current one is tested.
template <bool SOFT>
__global__ void __launch_bounds__(TILE)
raster_stream_every_chunk_kernel(const float* __restrict__ coeffs,
                                 const int* __restrict__ ranges,
                                 int* __restrict__ p2f,
                                 float* __restrict__ zbuf,
                                 int* __restrict__ near_out,
                                 unsigned long long* __restrict__ tested,
                                 int H, int W, int f_pad, int n_tiles,
                                 int cull) {
  constexpr int ROWS = SOFT ? 19 : 12;
  __shared__ __align__(16) float buf[2][ROWS][CHUNK];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const float px = (float)(p % W);
  const float py = (float)(p / W);
  const int* rv = ranges + ((long long)v * n_tiles + t0 / cull) * 2;
  const int c_lo = rv[0], c_hi = rv[1];   // c_lo > c_hi when none overlaps
  const float* cv = coeffs + (long long)v * 20 * f_pad;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  float sbest = NEG_INIT;
  int sid = 0;
  if (c_lo <= c_hi) stage_chunk<ROWS>(buf[0], cv, f_pad, c_lo);
  int slot = 0;
  for (int cur = c_lo; cur <= c_hi; ++cur) {
    if (cur < c_hi) {
      stage_chunk<ROWS>(buf[slot ^ 1], cv, f_pad, cur + 1);
      cp_async_wait<1>();   // chunk cur has landed, cur + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*sc)[CHUNK] = buf[slot];
    if (p < hw) {
      for (int f = 0; f < CHUNK; ++f) {
        const float b0 = affine(px, py, sc[0][f], sc[1][f], sc[2][f]);
        const float b1 = affine(px, py, sc[3][f], sc[4][f], sc[5][f]);
        const float b2 = affine(px, py, sc[6][f], sc[7][f], sc[8][f]);
        const float iz = affine(px, py, sc[9][f], sc[10][f], sc[11][f]);
        if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f && iz > best) {
          best = iz;
          fid = cur * CHUNK + f;
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
            sid = cur * CHUNK + f;
          }
        }
      }
    }
    __syncthreads();   // slot `slot` is refilled next
    slot ^= 1;
  }
  if (tested != nullptr && threadIdx.x == 0 && c_lo <= c_hi)
    atomicAdd(tested, (unsigned long long)(c_hi - c_lo + 1));
  if (p < hw) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
    if (SOFT) near_out[(long long)v * hw + p] = sid;
  }
}

}  // namespace

// coeffs (N, 20, f_pad) float32, 16-byte aligned; ranges (N, n_tiles, 2)
// int32 [c_lo, c_hi] per `cull`-pixel tile (a multiple of 256, or at least
// H*W); p2f (N, H*W) int32 sorted ids; zbuf (N, H*W) float32; near
// (N, H*W) int32, written only when soft != 0; tested, if not null, a
// uint64 the (pixel, face) pairs of the warps' lists are added to (one
// atomic a block); the outputs are the image rows [row0, row0 + H).
extern "C" int st3d_raster_stream(const void* coeffs, const void* ranges,
                                  void* p2f, void* zbuf, void* near,
                                  void* tested, int N, int H, int W,
                                  int f_pad, int n_tiles, int cull, int soft,
                                  int row0, void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = f_pad / CHUNK;
  if (soft) {
    raster_stream_kernel<true><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const int*)ranges, (int*)p2f, (float*)zbuf,
        (int*)near, (unsigned long long*)tested, H, W, f_pad, n_chunks,
        n_tiles, cull, row0);
  } else {
    raster_stream_kernel<false><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const int*)ranges, (int*)p2f, (float*)zbuf,
        (int*)near, (unsigned long long*)tested, H, W, f_pad, n_chunks,
        n_tiles, cull, row0);
  }
  return (int)cudaGetLastError();
}

// The same outputs by the TPU kernel's walk: every chunk of each range is
// staged and tested; tested, if not null, counts the chunks a block walked.
extern "C" int st3d_raster_stream_every_chunk(
    const void* coeffs, const void* ranges, void* p2f, void* zbuf,
    void* near, void* tested, int N, int H, int W, int f_pad, int n_tiles,
    int cull, int soft, void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  cudaStream_t st = (cudaStream_t)stream;
  if (soft) {
    raster_stream_every_chunk_kernel<true><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const int*)ranges, (int*)p2f, (float*)zbuf,
        (int*)near, (unsigned long long*)tested, H, W, f_pad, n_tiles, cull);
  } else {
    raster_stream_every_chunk_kernel<false><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const int*)ranges, (int*)p2f, (float*)zbuf,
        (int*)near, (unsigned long long*)tested, H, W, f_pad, n_tiles, cull);
  }
  return (int)cudaGetLastError();
}
