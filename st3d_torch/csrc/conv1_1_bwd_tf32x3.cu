// Input gradient of VGG conv1_1 with its Gram statistics folded in, on
// Hopper's tensor cores, float32 by the 3xTF32 split. With P the
// zero-padded 3x3 patches of x (B, H, W, 3), patch order (dy, dx, c), the
// forward gave z = relu(P W + b), PtP = P^T P and s27 = P^T 1 per image.
// Given their cotangents dz (B, H, W, Cout), S = dPtP + dPtP^T (B, 27, 27)
// and ds27 (B, 27), the patch cotangent of each pixel is
//     dP = (dz * [z > 0]) W^T + P S + ds27            (27 values)
// and dx (B, H, W, 3) is its col2im, one float32 store.
//
// Replaces the TPU kernel st3d/kernels/stage1_pallas.py::_conv1_1_bwd_kernel
// (entry conv1_1_bwd_dx, K4c) for float32 with Cout a multiple of 4, at
// most 64 (kernels/stage1.py::c11_route). The TPU ran dot(d, w) and
// dot(p, sym) in
// float32 (stage1_pallas.py:607-617).
//
// Numerics: csrc/conv3x3_tf32x3.cu's. Every factor is split exactly into
// tf32 hi + lo and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, three
// wgmma; each slab's products and the P S' products sum into a fresh
// partial that the CUDA cores add to the running dP.
//
// Work layout: csrc/conv1_1_bwd_wgmma.cu's. Persistent blocks, one an SM
// (kernels/stage1.py::c11_bwd_blocks), each walking dx tiles blockIdx.x, +
// gridDim.x, ... in raster order (image, tile row, tile column), so that
// the halo re-reads come from L2. A tile is TW x TH = 22 x 14 dx pixels;
// dP is computed on its 24 x 16 halo, 384 pixels (a 1.25x recompute). Per
// tile and 32-channel slab (a 128-byte row of float32):
//   - dz and z arrive by TMA as (32, 24, 16, 1) boxes of the 4-D (C, W, H,
//     B) tensors at (c0, x0 - 1, y0 - 1, b) with the 128-byte swizzle, 48 KB
//     each, into one of two stages; one thread issues a slab's loads two
//     slabs ahead. TMA's zero fill gives d = 0 outside the image and past
//     Cout. The x window of the next tile (26 x 18 pixels) is loaded into
//     registers while this tile's products run (XWindow);
//   - the A operands never touch shared memory: three warpgroups, two
//     64-row groups of the halo each, read their register fragments of dz
//     and z from the stage (16-byte loads, no bank conflict: thread (l/4,
//     l%4) reads chunk 2*(l%4) + m of its row, m = 0, 1, and the k order
//     of a slab is permuted to match, position 8kk + col <-> channel 8t +
//     4m + 2e + h for kk = 2m + e, col = t + 4h), mask d = dz * [z > 0],
//     and split it in registers. A stage that holds a tile's last slab
//     stays for the dP staging; any other is handed back to TMA as soon as
//     its fragments are read;
//   - d W^T: wgmma m64n32k8, B = W^T hi and lo (N = 27 dP columns padded to
//     32, K-major, the slab's channels in the permuted order; resident,
//     laid out by each block from the (27, Cout) weights);
//   - on a tile's last slab, P S': the patch rows' fragments (column 27 =
//     1, columns 28-31 = 0, rows of halo pixels outside the image zero)
//     read from the x window and split in registers; B = S' hi and lo (S
//     with ds27 as row 27, K-major as it stands since S is symmetric: row
//     n holds S[k][n] for k < 27 and ds27[n] in column 27), laid out when
//     the image changes. A halo pixel outside the image has d = 0 and a
//     zero P row, so its dP is 0;
//   - dP (float32, k-major, rows padded to 388 floats so the accumulator
//     stores hit 32 banks) is staged over the stage's dz box; each dx value
//     then gathers its nine taps in a fixed order. No atomics.
//
// Shared memory (1024-byte aligned): two stages of a dz and a z box, 2 x
// 96 KB; S' hi and lo, 2 x 4 KB; W^T hi and lo, 2 x 4 KB a slab (16 KB at
// Cout = 64); the x window, 5.5 KB in a 6 KB slot: 223 KB (+1 KB for the
// alignment) of the 227 KB a block may have, which is what caps Cout at 64.
// Registers: two groups' dP partials and running sums (4 x 16) and one
// group pair's A fragments (hi and lo, 2 x 32) a thread.
//
// What bounds it on an H100: reading dz and z, 2 x 268 MB in float32 at
// 512^2 x 4 views (160 us at 3.35 TB/s); the products are 3 x 8.4 GFLOP
// of TF32 work with the halo and the padding to 32 (51 us at 495
// TFLOP/s). The CUDA-core kernel it replaced spent about 2.5 k
// shared-memory loads a pixel (0.80 ms at that shape).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int K = 27;
constexpr int TW = 22, TH = 14;          // dx tile
constexpr int HX = TW + 2, HY = TH + 2;  // dP halo box
constexpr int M = HX * HY;               // 384 halo pixels
constexpr int WGS = 3;                   // warpgroups
constexpr int GROUPS = M / 64 / WGS;     // 64-row groups per warpgroup
constexpr int THREADS = WGS * 128;
constexpr int BOX_BYTES = M * 128;       // one (32, 24, 16, 1) float32 box
constexpr int STAGE_BYTES = 2 * BOX_BYTES;   // dz, then z
constexpr int BT_BYTES = 32 * 128;       // a 32 x 32 K-major B tile
constexpr int DP_PITCH = M + 4;          // floats per dP row of the staging
constexpr int MAX_COUT = 64;
constexpr int MAX_SLABS = MAX_COUT / 32;
static_assert(M == 64 * GROUPS * WGS && M == THREADS,
              "one halo row a thread, whole 64-row groups per warpgroup");
static_assert(K * DP_PITCH * 4 <= BOX_BYTES, "dP fits over the dz box");
using XWin = XWindow<HX + 2, HY + 2, THREADS, float>;

// Shared memory, 1024-byte aligned: two stages, S' hi and lo, W^T hi and
// lo by slab, the x window.
constexpr int S_OFF = 2 * STAGE_BYTES;
constexpr int W_OFF = S_OFF + 2 * BT_BYTES;
constexpr int X_OFF = W_OFF + MAX_SLABS * 2 * BT_BYTES;
constexpr int SMEM = X_OFF + 6144 + 1024;
static_assert(XWin::VALUES * 4 <= 6144, "the x window fits its slot");
static_assert(SMEM + 64 <= 232448, "a block's shared memory");

// The channel of slab position p (0-31) of the permuted k order: p = 8kk +
// col, kk = 2m + e, col = t + 4h holds channel 8t + 4m + 2e + h, so that
// thread (l/4, t = l%4) finds the channels of its fragments of k8 steps 2m
// and 2m + 1 in one 16-byte chunk, 2t + m, of its row.
__device__ __forceinline__ int slab_channel(int p) {
  const int kk = p >> 3, col = p & 7;
  return 8 * (col & 3) + 4 * (kk >> 1) + 2 * (kk & 1) + (col >> 2);
}

// W^T's K-major B tiles of every slab, hi and lo, with the 128-byte
// swizzle: row n < 27 of slab s holds W[n][32s + slab_channel(p)] at
// position p, rows 27-31 and channels past Cout zero.
__device__ __forceinline__ void load_w_tiles(uint8_t* dst, const float* w,
                                             int Cout, int slabs, int tid) {
  for (int i = tid; i < slabs * 32 * 8; i += THREADS) {
    const int s = i >> 8, n = (i >> 3) & 31, j = i & 7;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 32 * s + slab_channel(4 * j + e);
      const float v =
          n < K && c < Cout ? __ldg(w + (long long)n * Cout + c) : 0.f;
      split_tf32(v, hi[e], lo[e]);
    }
    uint8_t* const tile = dst + s * 2 * BT_BYTES;
    *reinterpret_cast<uint4*>(tile + sw128_chunk(n, j)) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(tile + BT_BYTES + sw128_chunk(n, j)) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// S' of one image as two K-major B tiles, hi and lo, with the 128-byte
// swizzle: row n < 27, column k holds S'[k][n] = S[k][n] (k < 27) or
// ds27[n] (k = 27); everything else zero.
__device__ __forceinline__ void load_s_tiles(uint8_t* dst, const float* sym,
                                             const float* ds27, int tid) {
  for (int i = tid; i < 32 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * j + e;
      const float v = n >= K   ? 0.f
                      : k < K  ? __ldg(sym + k * K + n)
                      : k == K ? __ldg(ds27 + n)
                               : 0.f;
      split_tf32(v, hi[e], lo[e]);
    }
    *reinterpret_cast<uint4*>(dst + sw128_chunk(n, j)) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + BT_BYTES + sw128_chunk(n, j)) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

struct Tile {
  int b, x0, y0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  Tile r;
  r.x0 = (t % tiles_x) * TW;
  t /= tiles_x;
  r.y0 = (t % tiles_y) * TH;
  r.b = t / tiles_y;
  return r;
}

// Three products of one k8 step into a 64 x 32 partial, the small ones
// first.
__device__ __forceinline__ void three_products(float (&d)[16],
                                               const uint32_t (&ahi)[4],
                                               const uint32_t (&alo)[4],
                                               uint32_t b_hi, uint32_t b_lo) {
  const uint64_t bh = desc_sw128(b_hi, 16), bl = desc_sw128(b_lo, 16);
  wgmma_m64n32k8_tf32_rs(d, alo, bh);
  wgmma_m64n32k8_tf32_rs(d, ahi, bl);
  wgmma_m64n32k8_tf32_rs(d, ahi, bh);
}

__global__ void __launch_bounds__(THREADS, 1)
conv1_1_bwd_tf32x3_kernel(__grid_constant__ const CUtensorMap dzmap,
                          __grid_constant__ const CUtensorMap zmap,
                          const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ sym,
                          const float* __restrict__ ds27,
                          float* __restrict__ dx, int H, int W, int Cout,
                          int tiles_x, int tiles_y, int tiles) {
  __shared__ __align__(8) uint64_t full[2];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  float* const win = reinterpret_cast<float*>(base_ptr + X_OFF);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slabs = (Cout + 31) / 32;
  const int nblk = gridDim.x;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - (int)blockIdx.x + nblk - 1) / nblk : 0;
  const int units = mine * slabs;          // (tile, slab) loads, in order

  // Unit u: tile blockIdx.x + (u / slabs) * nblk, slab u % slabs, stage
  // u % 2, that stage's (u / 2)-th fill.
  auto issue = [&](int u) {
    const Tile tl = tile_at(blockIdx.x + (u / slabs) * nblk, tiles_x,
                            tiles_y);
    const uint32_t st = base + (u & 1) * STAGE_BYTES;
    const uint32_t bar = smem_u32(&full[u & 1]);
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load_4d(st, &dzmap, bar, 32 * (u % slabs), tl.x0 - 1, tl.y0 - 1,
                tl.b);
    tma_load_4d(st + BOX_BYTES, &zmap, bar, 32 * (u % slabs), tl.x0 - 1,
                tl.y0 - 1, tl.b);
  };
  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int u = 0; u < 2 && u < units; ++u) issue(u);
  }
  load_w_tiles(base_ptr + W_OFF, w, Cout, slabs, tid);
  // A tile's first wgmma may come before any other barrier.
  fence_proxy_async();
  __syncthreads();

  XWin xw;
  if (mine > 0) {
    const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_y);
    xw.load(x + (long long)tl.b * H * W * 3, H, W, tl.x0 - 2, tl.y0 - 2,
            tid);
  }
  // This thread's rows of its warpgroup's groups: row0 + 64 * grp (+ 8).
  const int row0 = wg * GROUPS * 64 + 16 * warp + g;
  int s_image = -1;                        // the image whose S' is loaded
  float acc[GROUPS][16], part[GROUPS][16];
  for (int u = 0; u < units; ++u) {
    const int i = u / slabs, slab = u % slabs;
    const Tile tl = tile_at(blockIdx.x + i * nblk, tiles_x, tiles_y);
    uint8_t* const st_ptr = base_ptr + (u & 1) * STAGE_BYTES;
    const bool last = slab == slabs - 1;
    if (slab == 0) {
#pragma unroll
      for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[grp][e] = part[grp][e] = 0.f;
    }
    if (last) {
      // The x window and S' of this tile; the previous tile's readers
      // finished before its last barrier.
      xw.store(win, tid);
      if (tl.b != s_image) {
        load_s_tiles(base_ptr + S_OFF, sym + (long long)tl.b * K * K,
                     ds27 + (long long)tl.b * K, tid);
        s_image = tl.b;
      }
      fence_proxy_async();
    }
    mbar_wait(smem_u32(&full[u & 1]), (u >> 1) & 1);
    // d's fragments: a[grp][kk][v] holds d at row row0 + 64 grp + 8*(v &
    // 1) and slab position 8kk + t4 + 4*(v >> 1), i.e. element 2e + (v >>
    // 1) of chunk 2*t4 + m (kk = 2m + e) of that row, masked by z > 0.
    uint32_t ahi[GROUPS][4][4], alo[GROUPS][4][4];
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
      for (int rsel = 0; rsel < 2; ++rsel)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int row = row0 + 64 * grp + 8 * rsel;
          const uint32_t off = sw128_chunk(row, 2 * t4 + m);
          const float4 dv = *reinterpret_cast<const float4*>(st_ptr + off);
          const float4 zv =
              *reinterpret_cast<const float4*>(st_ptr + BOX_BYTES + off);
          const float d[4] = {zv.x > 0.f ? dv.x : 0.f,
                              zv.y > 0.f ? dv.y : 0.f,
                              zv.z > 0.f ? dv.z : 0.f,
                              zv.w > 0.f ? dv.w : 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int kk = 2 * m + (q >> 1), v = rsel + 2 * (q & 1);
            split_tf32(d[q], ahi[grp][kk][v], alo[grp][kk][v]);
          }
        }
    if (!last) {
      // Every fragment of this stage is read: hand it back to TMA.
      __syncthreads();
      if (tid == 0 && u + 2 < units) issue(u + 2);
    }
    // d W^T for this slab into fresh partials.
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      fence_acc(part[grp]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ahi[grp][kk]);
        fence_regs(alo[grp][kk]);
      }
    }
    wgmma_fence();
    const uint32_t wt = base + W_OFF + slab * 2 * BT_BYTES;
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        three_products(part[grp], ahi[grp][kk], alo[grp][kk], wt + kk * 32,
                       wt + BT_BYTES + kk * 32);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      fence_acc(part[grp]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ahi[grp][kk]);
        fence_regs(alo[grp][kk]);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        acc[grp][e] += part[grp][e];
        part[grp][e] = 0.f;
      }
    }
    if (!last) continue;

    // P S': the x window and S' of every thread are in shared memory, and
    // no thread reads the dz box of this stage any more.
    __syncthreads();
    if (i + 1 < mine) {
      const Tile tn = tile_at(blockIdx.x + (i + 1) * nblk, tiles_x, tiles_y);
      xw.load(x + (long long)tn.b * H * W * 3, H, W, tn.x0 - 2, tn.y0 - 2,
              tid);
    }
    // P's fragments: a[grp][kk][v] holds P'[row0 + 64 grp + 8*(v & 1)][8kk
    // + t4 + 4*(v >> 1)]; halo row r is pixel (y0 - 1 + r / HX, x0 - 1 +
    // r % HX), its 3 x 3 window at (r / HX, r % HX) of the x window.
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
      for (int rsel = 0; rsel < 2; ++rsel) {
        const int r = row0 + 64 * grp + 8 * rsel;
        const int hy = r / HX, hx = r % HX;
        const int gy = tl.y0 - 1 + hy, gx = tl.x0 - 1 + hx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kk = j >> 1, v = rsel + 2 * (j & 1);
          split_tf32(patch_value<HX + 2>(win, hy, hx,
                                         8 * kk + t4 + 4 * (j & 1), in),
                     ahi[grp][kk][v], alo[grp][kk][v]);
        }
      }
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      fence_acc(part[grp]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ahi[grp][kk]);
        fence_regs(alo[grp][kk]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        three_products(part[grp], ahi[grp][kk], alo[grp][kk],
                       base + S_OFF + kk * 32,
                       base + S_OFF + BT_BYTES + kk * 32);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      fence_acc(part[grp]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ahi[grp][kk]);
        fence_regs(alo[grp][kk]);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[grp][e] += part[grp][e];
    }

    // dP (k-major) over the dz box. Accumulator v of thread (warp w, lane
    // l): row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3)
    // + (v & 1).
    float* dps = reinterpret_cast<float*>(st_ptr);
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        const int row = row0 + 64 * grp + 8 * ((v >> 1) & 1);
        const int k = 8 * (v >> 2) + 2 * t4 + (v & 1);
        if (k < K) dps[k * DP_PITCH + row] = acc[grp][v];
      }
    __syncthreads();

    // col2im by gather: dx pixel (oy, ox) of the tile takes tap (dy, dx)
    // from halo pixel (oy + 2 - dy, ox + 2 - dx).
    for (int item = tid; item < 3 * TW * TH; item += THREADS) {
      const int c = item / (TW * TH), pix = item % (TW * TH);
      const int oy = pix / TW, ox = pix % TW;
      const int y = tl.y0 + oy, xg = tl.x0 + ox;
      if (y >= H || xg >= W) continue;
      float sum = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int ddx = 0; ddx < 3; ++ddx)
          sum += dps[((dy * 3 + ddx) * 3 + c) * DP_PITCH +
                     (oy + 2 - dy) * HX + ox + 2 - ddx];
      dx[(((long long)tl.b * H + y) * W + xg) * 3 + c] = sum;
    }
    // The stage, the x window and S' are free; the generic writes to the
    // stage are ordered before the next TMA writes into it.
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && u + 2 < units) issue(u + 2);
  }
}

CUresult encode_box(CUtensorMap* map, const void* t, int B, int H, int W,
                    int C) {
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {32, HX, HY, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(t), dim,
      stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// x (B, H, W, 3), dz and z (B, H, W, Cout) float32, dz and z 16-byte
// aligned; w (27, Cout) float32 (the HWIO weights flattened); sym (B, 27,
// 27) and ds27 (B, 27) float32; dx (B, H, W, 3) float32; Cout a multiple of
// 4, at most 64; blocks the persistent blocks. Returns a cudaError_t, or
// ENCODE_ERROR + the CUresult of a tensor-map encoding.
extern "C" int st3d_conv1_1_bwd_tf32x3_f32(const void* x, const void* dz,
                                           const void* z, const void* w,
                                           const void* sym, const void* ds27,
                                           void* dx, int B, int H, int W,
                                           int Cout, int blocks,
                                           void* stream) {
  if (Cout % 4 || Cout > MAX_COUT || blocks < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap dzmap, zmap;
  CUresult r = encode_box(&dzmap, dz, B, H, W, Cout);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_box(&zmap, z, B, H, W, Cout);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      conv1_1_bwd_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  conv1_1_bwd_tf32x3_kernel<<<(unsigned)blocks, THREADS, SMEM,
                              (cudaStream_t)stream>>>(
      dzmap, zmap, (const float*)x, (const float*)w, (const float*)sym,
      (const float*)ds27, (float*)dx, H, W, Cout, tiles_x, tiles_y,
      B * tiles_x * tiles_y);
  return (int)cudaGetLastError();
}
