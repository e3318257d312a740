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
// tile and walks it. The TPU kernel tests every chunk of the range. Once
// the vertices move, one stretched face widens its chunk's [ymin, ymax]
// band, and the chunks sorted around it fall into the ranges of tiles far
// below their own rows; testing them all took most of a step. So this
// kernel tests only the chunks that can change the result:
//   - hard: a chunk whose band misses the block's rows is skipped. That is
//     K1's own per-chunk cull (raster_hard.cu, the same float test), so
//     the pixels see exactly K1's chunks, in K1's order;
//   - soft: a chunk is skipped only when it is out of band by the margin,
//     fl(ymax - row0) <= -margin or fl(row1 - ymin) <= -margin in this
//     kernel's own rounded arithmetic, AND every pixel of the block already
//     has a nearest-face distance sbest >= -margin (__syncthreads_and, taken
//     after each tested chunk). Then every face of the chunk has bbox
//     distance bb <= -margin (rounding is monotone, ymax <= the band's, py
//     >= row0), so d = min(sd, bb) <= -margin <= sbest, and under the strict
//     '>' it cannot win, then or later: sbest only rises. Its faces cannot
//     cover a block pixel either (the band misses the rows). Before that
//     point every chunk of the range is tested, as on the TPU: a pixel
//     farther than the margin from every face takes its nearest face from
//     whatever is tested, so no skip may change that set.
// Inside a tested chunk, each warp keeps the faces whose bbox comes within 1
// of the block's rows and its own 32 columns (soft: all but those out by the
// margin once every pixel is near a face), 32 a ballot; soft, a face is
// also skipped at a pixel 1 or more outside its bbox once bb <= sbest there.
// A stretched face keeps its chunk's band wide, but its neighbours in the
// chunk are small.
// The next tested chunk is found by each warp on its own, 32 chunk bands a
// __ballot_sync, and its coefficient rows (16 hard: K1's 12 and the bbox;
// 19 soft; 128 floats each) are copied into the free one of two shared-memory slots with
// cp.async while the current chunk is tested: the skip is decided one
// tested chunk ahead, on the running best before the current chunk, which
// tests a chunk the rule might have skipped but never skips one it keeps.
// st3d_raster_stream_every_chunk keeps the TPU kernel's walk (every chunk
// of the range): launched by no route, the twin chip_smoke.py holds the
// new walk against.
//
// Selection and rounding are K1's (raster_hard.cu, raster_soft.cu): strict
// '>' in sorted order over 1/z from 0 for the covering face, over the gated
// signed distance from -3e38 (id 0) for the nearest face; every affine value
// is two rounded products and two rounded sums (__fmul_rn / __fadd_rn) and
// the file is built with -fmad=false. So pix_to_face and zbuf equal K1's,
// and everything equals the plain version, bit for bit.
//
// What bounds it on an H100: compute per tested (pixel, face) pair, as K1.
// The culls keep the tests to the faces whose bbox comes within a pixel of
// a warp's pixels (soft: or may still be their nearest); every tested chunk
// is still staged whole and its bbox rows read by every warp.

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

// Start the copy of chunk `c`'s coefficient rows into `slot`: rows 0-11
// and the bbox, rows 15-18 (slot rows 12-15), hard; rows 0-18, soft.
template <int NROWS>
__device__ __forceinline__ void stage(float (*slot)[CHUNK],
                                      const float* __restrict__ cv, int f_pad,
                                      int c) {
  constexpr int PER_ROW = CHUNK / 4;   // 16-byte copies per row
  for (int i = threadIdx.x; i < NROWS * PER_ROW; i += TILE) {
    const int r = i / PER_ROW;
    const int q = i % PER_ROW;
    const int src = NROWS == 16 && r >= 12 ? r + 3 : r;
    cp_async16(&slot[r][q * 4],
               cv + (long long)src * f_pad + (long long)c * CHUNK + q * 4);
  }
  cp_async_commit();
}

// Whether the block must test chunk c. Hard: its band meets the rows
// (K1's test). Soft: it is not out of band by the margin, or not every
// pixel is near a face yet (`near`).
template <bool SOFT>
__device__ __forceinline__ bool wanted(const float* __restrict__ bv,
                                       int n_chunks, int c, float row0,
                                       float row1, float margin, bool near) {
  const float ymin = bv[c], ymax = bv[n_chunks + c];
  if (!SOFT) return ymax >= row0 && ymin <= row1;
  return !near || !(__fsub_rn(ymax, row0) <= -margin ||
                    __fsub_rn(row1, ymin) <= -margin);
}

// The first chunk after `c`, up to `c_hi`, that the block must test
// (c_hi + 1 when none): each warp scans 32 bands a ballot.
template <bool SOFT>
__device__ __forceinline__ int next_wanted(const float* __restrict__ bv,
                                           int n_chunks, int c, int c_hi,
                                           float row0, float row1,
                                           float margin, bool near) {
  if (SOFT && !near) return c + 1;
  const int lane = threadIdx.x & 31;
  for (int base = c + 1; base <= c_hi; base += 32) {
    const int cc = base + lane;
    const unsigned hit = __ballot_sync(
        0xffffffffu, cc <= c_hi && wanted<SOFT>(bv, n_chunks, cc, row0, row1,
                                                margin, near));
    if (hit) return base + __ffs(hit) - 1;
  }
  return c_hi + 1;
}

template <bool SOFT, bool SKIP>
__global__ void __launch_bounds__(TILE)
raster_stream_kernel(const float* __restrict__ coeffs,
                     const float* __restrict__ bounds,
                     const int* __restrict__ ranges, int* __restrict__ p2f,
                     float* __restrict__ zbuf, int* __restrict__ near_out,
                     unsigned long long* __restrict__ tested, int H, int W,
                     int f_pad, int n_chunks, int n_tiles, int cull,
                     float margin) {
  // The every-chunk walk stages K1's rows only (12 hard).
  constexpr int NROWS = SOFT ? 19 : SKIP ? 16 : 12;
  constexpr int BOX = SOFT ? 15 : 12;  // slot row of xmin, xmax, ymin, ymax
  __shared__ __align__(16) float buf[2][NROWS][CHUNK];
  const int v = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long p = t0 + threadIdx.x;
  const float px = (float)(p % W);
  const float py = (float)(p / W);
  const float row0 = (float)(t0 / W);
  const float row1 = (float)(min(t0 + TILE - 1, hw - 1) / W);
  const int* rv = ranges + ((long long)v * n_tiles + t0 / cull) * 2;
  const int c_lo = rv[0], c_hi = rv[1];   // c_lo > c_hi when none overlaps
  const float* cv = coeffs + (long long)v * 20 * f_pad;
  const float* bv = bounds + (long long)v * 2 * n_chunks;

  float best = 0.f;   // background: 1/z <= 0
  int fid = -1;
  float sbest = NEG_INIT;
  int sid = 0;
  bool near = false;  // every pixel of the block has sbest >= -margin
  int cur = SKIP && !SOFT ? next_wanted<SOFT>(bv, n_chunks, c_lo - 1, c_hi,
                                              row0, row1, margin, near)
                          : c_lo;
  int nxt = c_hi + 1;
  if (cur <= c_hi) {
    stage<NROWS>(buf[0], cv, f_pad, cur);
    nxt = SKIP ? next_wanted<SOFT>(bv, n_chunks, cur, c_hi, row0, row1,
                                   margin, near)
               : cur + 1;
  }
  int slot = 0, n_tested = 0;
  while (cur <= c_hi) {
    if (nxt <= c_hi) {
      stage<NROWS>(buf[slot ^ 1], cv, f_pad, nxt);
      cp_async_wait<1>();   // chunk cur has landed, nxt may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*sc)[CHUNK] = buf[slot];
    // The chunk's faces this warp keeps, 32 a ballot, in its own
    // registers: hard, those whose bbox comes within 1 of the block's rows
    // and of the warp's columns (fl(ymax - row0) > -1, fl(row1 - ymin) >
    // -1, the same in x against the warp's first and last column, so every
    // face left out has bb <= -1 at every pixel of the warp); soft, all but
    // those out by the margin once every pixel of the block is near a face
    // (as the chunk skip). Faces stay in sorted order.
    unsigned keep[CHUNK / 32];
    const int lane = threadIdx.x & 31;
    float col0 = __shfl_sync(0xffffffffu, px, 0);
    float col1 = __shfl_sync(0xffffffffu, px, 31);
    if (__shfl_sync(0xffffffffu, py, 0) != __shfl_sync(0xffffffffu, py, 31)) {
      col0 = 0.f;                         // the warp wraps a row
      col1 = (float)(W - 1);
    }
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w) {
      bool k = true;
      if (SKIP) {
        const float lim = SOFT ? -margin : -1.f;
        const int f = 32 * w + lane;
        const bool out =
            __fsub_rn(sc[BOX + 3][f], row0) <= lim ||
            __fsub_rn(row1, sc[BOX + 2][f]) <= lim ||
            __fsub_rn(sc[BOX + 1][f], col0) <= lim ||
            __fsub_rn(col1, sc[BOX][f]) <= lim;
        k = !out || (SOFT && !near);
      }
      keep[w] = __ballot_sync(0xffffffffu, k);
    }
    if (p < hw) {
#pragma unroll
      for (int w = 0; w < CHUNK / 32; ++w) {
        for (unsigned m = keep[w]; m; m &= m - 1) {
          const int f = 32 * w + __ffs(m) - 1;
          // Soft, the bbox distance first (the score's own rounding): at a
          // pixel 1 or more outside the bbox the face is not covered (a
          // barycentric's rounding error is some 1e-4 pixel here) and, once
          // bb <= sbest, d = min(sd, bb) cannot win the strict '>': skip
          // it there (SKIP only). Hard, the warp's face list is all the
          // cull (its pixels share a row at these widths).
          float bb = 0.f;
          if (SOFT) {
            bb = fminf(fminf(__fsub_rn(px, sc[BOX][f]),
                             __fsub_rn(sc[BOX + 1][f], px)),
                       fminf(__fsub_rn(py, sc[BOX + 2][f]),
                             __fsub_rn(sc[BOX + 3][f], py)));
            if (SKIP && bb <= -1.f && bb <= sbest) continue;
          }
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
            const float d = fminf(sd, bb);
            if (d > sbest) {
              sbest = d;
              sid = cur * CHUNK + f;
            }
          }
        }
      }
    }
    ++n_tested;
    // Slot `slot` is refilled once every thread is past this barrier.
    if (SOFT && SKIP) {
      near = __syncthreads_and(p >= hw || sbest >= -margin) != 0;
    } else {
      __syncthreads();
    }
    cur = nxt;
    slot ^= 1;
    if (cur <= c_hi)
      nxt = SKIP ? next_wanted<SOFT>(bv, n_chunks, cur, c_hi, row0, row1,
                                     margin, near)
                 : cur + 1;
  }
  if (tested != nullptr && threadIdx.x == 0)
    atomicAdd(tested, (unsigned long long)n_tested);
  if (p < hw) {
    const bool hit = best > 0.f;
    p2f[(long long)v * hw + p] = hit ? fid : -1;
    zbuf[(long long)v * hw + p] =
        hit ? __fdiv_rn(1.f, fmaxf(best, 1e-12f)) : BIG_Z;
    if (SOFT) near_out[(long long)v * hw + p] = sid;
  }
}

template <bool SKIP>
int launch(const void* coeffs, const void* bounds, const void* ranges,
           void* p2f, void* zbuf, void* near, void* tested, int N, int H,
           int W, int f_pad, int n_tiles, int cull, int soft, float margin,
           void* stream) {
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + TILE - 1) / TILE), (unsigned)N);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = f_pad / CHUNK;
  if (soft) {
    raster_stream_kernel<true, SKIP><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const float*)bounds, (const int*)ranges,
        (int*)p2f, (float*)zbuf, (int*)near, (unsigned long long*)tested, H,
        W, f_pad, n_chunks, n_tiles, cull, margin);
  } else {
    raster_stream_kernel<false, SKIP><<<grid, TILE, 0, st>>>(
        (const float*)coeffs, (const float*)bounds, (const int*)ranges,
        (int*)p2f, (float*)zbuf, (int*)near, (unsigned long long*)tested, H,
        W, f_pad, n_chunks, n_tiles, cull, margin);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// coeffs (N, 20, f_pad) float32, 16-byte aligned; bounds (N, 2, f_pad /
// 128) float32, the chunks' [ymin; ymax]; ranges (N, n_tiles, 2) int32
// [c_lo, c_hi] per `cull`-pixel tile (a multiple of 256, or at least H*W),
// made with `margin` in soft mode; p2f (N, H*W) int32 sorted ids; zbuf
// (N, H*W) float32; near (N, H*W) int32, written only when soft != 0;
// tested, if not null, a uint64 the chunks tested are added to (one atomic
// a block).
extern "C" int st3d_raster_stream(const void* coeffs, const void* bounds,
                                  const void* ranges, void* p2f, void* zbuf,
                                  void* near, void* tested, int N, int H,
                                  int W, int f_pad, int n_tiles, int cull,
                                  int soft, float margin, void* stream) {
  return launch<true>(coeffs, bounds, ranges, p2f, zbuf, near, tested, N, H,
                      W, f_pad, n_tiles, cull, soft, margin, stream);
}

// The same outputs by the TPU kernel's walk: every chunk of each range is
// staged and tested (bounds unread).
extern "C" int st3d_raster_stream_every_chunk(
    const void* coeffs, const void* bounds, const void* ranges, void* p2f,
    void* zbuf, void* near, void* tested, int N, int H, int W, int f_pad,
    int n_tiles, int cull, int soft, float margin, void* stream) {
  return launch<false>(coeffs, bounds, ranges, p2f, zbuf, near, tested, N, H,
                       W, f_pad, n_tiles, cull, soft, margin, stream);
}
