// Input gradient of VGG conv1_1 with the direct Gram of its pre-ReLU output
// folded in, on Hopper's tensor cores, float32 by the 3xTF32 split (the
// forward is csrc/conv1_1_gram_tf32x3.cu). The forward gave z = relu(y) and
// g64 = y^T y, y = conv3x3_same(x, W) + b. Given the cotangent dz (B, H, W,
// 64) of z and S = dG + dG^T (B, 64, 64) float32 of g64, each pixel's conv
// cotangent is d = dz * [y > 0] + y S, and dx (B, H, W, 3) is col2im(d W^T)
// in float32. In float32 d is not rounded, so its fold is taken as
//     dP = (dz * [y > 0]) W^T + y M,   M = S W^T (64 x 27, padded to 32),
// the same function up to the order of float32 additions.
//
// Replaces the TPU kernel st3d/kernels/stage1v3_pallas.py::_c11_bwd_kernel
// (entry _c11_v3_bwd, K10b) for float32 (kernels/stage1v3.py::v3_route);
// csrc/conv1_1_gram_bwd_wgmma.cu takes bf16. The TPU recomputed y in
// float32, masked on it and
// took y S and d W^T as float32 dots (stage1v3_pallas.py:388-403).
//
// Numerics: csrc/conv3x3_tf32x3.cu's. Every factor is split exactly into
// tf32 hi + lo and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, three
// wgmma; y M and each 32-channel slab of (dz * mask) W^T sum into fresh
// partials that the CUDA cores add to the running dP.
//
// Work layout: kernel B f32's (csrc/conv1_1_bwd_tf32x3.cu). Persistent
// blocks, one an SM (kernels/stage1.py::c11_bwd_blocks), each walking dx
// tiles blockIdx.x, + gridDim.x, ... in raster order (image, tile row,
// tile column). A tile is TW x TH = 22 x 14 dx pixels; dP is computed on
// its 24 x 16 halo, 384 pixels, two 64-row groups for each of three
// warpgroups. Per tile:
//   - dz arrives by TMA as two (32, 24, 16, 1) boxes (one a 32-channel
//     slab, a 128-byte row of float32) of the 4-D (64, W, H, B) tensor at
//     (32s, x0 - 1, y0 - 1, b) with the 128-byte swizzle, 48 KB each, into
//     one of two stages; one thread issues a slab's load two slabs ahead.
//     TMA's zero fill gives dz = 0 outside the image. There is no z box: y
//     is recomputed, as on the TPU. The x window of the next tile (26 x 18
//     pixels) is loaded into registers while this tile's products run;
//   - at the tile's first slab, group by group: y by hopper.cuh's
//     conv1_1_y_tf32x3, the forward's instructions on the same patch rows
//     and W' tiles, so the mask [y > 0] (kept as 32 bits a thread) is the
//     forward's z > 0 bit for bit; a halo pixel outside the image has a
//     zero patch row, so its y and mask are 0. Then y M with y's A
//     fragments taken from the accumulator in registers: the accumulator
//     holds columns 8j + 2t + {0, 1} where the tf32 A fragment wants 8j + t
//     + {0, 4}, so the k order of M's B tile is permuted to match
//     (hopper.cuh's acc_k_channel);
//   - per slab, group by group: dz read from the stage in the
//     accumulator's layout (8-byte loads) and masked, split in registers,
//     times W^T (the slab's K-major B tile, k order permuted the same way),
//     12 wgmma m64n32k8. A first slab's stage is handed back to TMA once
//     its fragments are read; the last one stays for the dP staging;
//   - M = S W^T of the tile's image is computed by each block in float32
//     on the CUDA cores when its image changes (S staged over M's tiles,
//     each thread's row of W, read back from the W^T tiles, in registers;
//     64 FMAs an entry in a fixed order), then split into hi and lo;
//   - dP (float32, k-major, rows padded to 388 floats) is staged over the
//     last stage's box; each dx value then gathers its nine taps in a
//     fixed order. No atomics.
//
// Shared memory (1024-byte aligned): two dz stages 2 x 48 KB; W' hi and lo
// 2 x 8 KB; W^T hi and lo, 2 x 4 KB a slab; M hi and lo, 2 x 4 KB a
// k-block of 32 channels; the x window, 5.5 KB in a 6 KB slot: 150 KB (+1
// KB for the alignment). Registers: two groups' running dP (2 x 16), a
// fresh partial (16), one group's A fragments of four k8 steps (hi and lo,
// 2 x 16) and the masks (2) a thread; each unit recomputes its lane's
// shared-memory offsets. 162 registers, no spills (ptxas, sm_90a); both
// groups' fragments of a slab at once, y M's eight k8 steps in one batch
// and offsets held across the loop spilled.
//
// What bounds it on an H100: reading dz, 268 MB in float32 at 512^2 x 4
// views (80 us at 3.35 TB/s; 88 us with x and dx); the products, with the
// 1.31x halo and the padding of K to 32 and of dP to 32 columns, are 3 x
// 1.38 M halo pixels x (32 x 64 + 64 x 32 + 64 x 32) MACs, ~51 GFLOP of
// TF32 work (0.10 ms at 495 TFLOP/s). The CUDA-core kernel it replaced ran
// them on the fp32 cores (1.02 ms at that shape).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int K = 27;
constexpr int C = 64;
constexpr int TW = 22, TH = 14;          // dx tile
constexpr int HX = TW + 2, HY = TH + 2;  // dP halo box
constexpr int M = HX * HY;               // 384 halo pixels
constexpr int WGS = 3;                   // warpgroups
constexpr int GROUPS = M / 64 / WGS;     // 64-row groups per warpgroup
constexpr int THREADS = WGS * 128;
constexpr int SLABS = C / 32;            // 32-channel dz boxes a tile
constexpr int STAGES = 2;
constexpr int BOX_BYTES = M * 128;       // one (32, 24, 16, 1) float32 box
constexpr int WB_BYTES = 64 * 128;       // W' (64 x 32, K-major), one part
constexpr int BT_BYTES = 32 * 128;       // a 32 x 32 K-major B tile
constexpr int DP_PITCH = M + 4;          // floats per dP row of the staging
static_assert(M == 64 * GROUPS * WGS && M == THREADS,
              "one halo row a thread, whole 64-row groups per warpgroup");
static_assert(K * DP_PITCH * 4 <= BOX_BYTES, "dP fits over a dz box");
using XWin = XWindow<HX + 2, HY + 2, THREADS, float>;

// Shared memory, 1024-byte aligned: the stages, W' hi and lo, W^T and M
// (k-block s, part h at (2s + h) * BT_BYTES), the x window.
constexpr int WB_OFF = STAGES * BOX_BYTES;
constexpr int WT_OFF = WB_OFF + 2 * WB_BYTES;
constexpr int MT_OFF = WT_OFF + 2 * SLABS * BT_BYTES;
constexpr int X_OFF = MT_OFF + 2 * SLABS * BT_BYTES;
constexpr int SMEM = X_OFF + 6144 + 1024;
static_assert(XWin::VALUES * 4 <= 6144, "the x window fits its slot");
static_assert(SMEM + 64 <= 232448, "a block's shared memory");
static_assert(C * C * 4 <= 2 * SLABS * BT_BYTES, "S fits over M's tiles");
// M's entries a thread: row n = tid % 32, positions tid / 32 + 12q.
constexpr int M_ENTRIES = (C + THREADS / 32 - 1) / (THREADS / 32);

// W^T's K-major B tiles, hi and lo, with the 128-byte swizzle: row n < 27
// of k-block s holds W[n][32s + acc_k_channel(p)] at position p; rows
// 27-31 zero.
__device__ __forceinline__ void load_wt_tiles(uint8_t* dst, const float* w,
                                              int tid) {
  for (int i = tid; i < SLABS * 32 * 8; i += THREADS) {
    const int s = i >> 8, n = (i >> 3) & 31, j = i & 7;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 32 * s + acc_k_channel(4 * j + e);
      split_tf32(n < K ? __ldg(w + n * C + c) : 0.f, hi[e], lo[e]);
    }
    *reinterpret_cast<uint4*>(dst + 2 * s * BT_BYTES + sw128_chunk(n, j)) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + (2 * s + 1) * BT_BYTES +
                              sw128_chunk(n, j)) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// M = S W^T of one image into M's K-major B tiles, hi and lo, with the
// 128-byte swizzle: row n < 27 of k-block s holds M[32s + acc_k_channel(p)]
// [n] at position p; rows 27-31 zero. M[c][n] is the float32 sum of S[c][k]
// W[n][k] over k in the k order of the W^T tiles (position 0 .. 63). S
// (row-major, 16 KB) is first staged over M's tiles; thread (n = tid % 32)
// reads W's row n from the W^T tiles (hi + lo is W exactly; no bank
// conflict) into registers, and a warp's lanes share their position, so
// each S read is a broadcast. Every thread of the block calls it; the
// first barrier also orders the W^T tiles' writes before the reads.
__device__ __forceinline__ void load_m_tiles(uint8_t* dst, const float* sym,
                                             const uint8_t* wt, int tid) {
  float* const ss = reinterpret_cast<float*>(dst);
  for (int i = tid; i < C * C / 4; i += THREADS)
    reinterpret_cast<float4*>(ss)[i] =
        __ldg(reinterpret_cast<const float4*>(sym) + i);
  __syncthreads();
  const int n = tid & 31;
  float wr[C];                             // W[n][acc_k_channel(q)]
#pragma unroll
  for (int q = 0; q < C; q += 4) {
    const uint32_t off = 2 * (q >> 5) * BT_BYTES +
                         sw128_chunk(n, (q & 31) >> 2);
    const float4 hi = *reinterpret_cast<const float4*>(wt + off);
    const float4 lo = *reinterpret_cast<const float4*>(wt + off + BT_BYTES);
    wr[q] = hi.x + lo.x;
    wr[q + 1] = hi.y + lo.y;
    wr[q + 2] = hi.z + lo.z;
    wr[q + 3] = hi.w + lo.w;
  }
  float m[M_ENTRIES];
#pragma unroll
  for (int e = 0; e < M_ENTRIES; ++e) {
    const int p = (tid >> 5) + (THREADS / 32) * e;
    float sum = 0.f;
    if (p < C) {
      const float* srow = ss + acc_k_channel(p) * C;
#pragma unroll
      for (int k8 = 0; k8 < C; k8 += 8) {
        const float4 s0 = *reinterpret_cast<const float4*>(srow + k8);
        const float4 s1 = *reinterpret_cast<const float4*>(srow + k8 + 4);
        const float s8[8] = {s0.x, s0.y, s0.z, s0.w,
                             s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int q = k8; q < k8 + 8; ++q)
          sum = fmaf(s8[acc_k_channel(q) & 7], wr[q], sum);
      }
    }
    m[e] = sum;
  }
  __syncthreads();                         // every read of S is done
#pragma unroll
  for (int e = 0; e < M_ENTRIES; ++e) {
    const int p = (tid >> 5) + (THREADS / 32) * e;
    if (p < C) {
      uint32_t hi, lo;
      split_tf32(n < K ? m[e] : 0.f, hi, lo);
      const uint32_t off = sw128_chunk(n, (p & 31) >> 2) + 4 * (p & 3);
      *reinterpret_cast<uint32_t*>(dst + 2 * (p >> 5) * BT_BYTES + off) = hi;
      *reinterpret_cast<uint32_t*>(dst + (2 * (p >> 5) + 1) * BT_BYTES +
                                   off) = lo;
    }
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
conv1_1_gram_bwd_tf32x3_kernel(__grid_constant__ const CUtensorMap dzmap,
                               const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               const float* __restrict__ sym,
                               float* __restrict__ dx, int H, int W,
                               int tiles_x, int tiles_y, int tiles) {
  __shared__ __align__(8) uint64_t full[STAGES];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  float* const win = reinterpret_cast<float*>(base_ptr + X_OFF);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int nblk = gridDim.x;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - (int)blockIdx.x + nblk - 1) / nblk : 0;
  const int units = mine * SLABS;          // (tile, slab) loads, in order

  // Unit u: tile blockIdx.x + (u / SLABS) * nblk, slab u % SLABS, stage
  // u % STAGES, that stage's (u / STAGES)-th fill.
  auto issue = [&](int u) {
    const Tile tl = tile_at(blockIdx.x + (u / SLABS) * nblk, tiles_x,
                            tiles_y);
    const uint32_t bar = smem_u32(&full[u % STAGES]);
    mbar_expect_tx(bar, BOX_BYTES);
    tma_load_4d(base + (u % STAGES) * BOX_BYTES, &dzmap, bar,
                32 * (u % SLABS), tl.x0 - 1, tl.y0 - 1, tl.b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int u = 0; u < STAGES && u < units; ++u) issue(u);
  }
  // W' (y's B tiles) and W^T (the slabs'); the first tile's barriers order
  // these writes before their readers.
  load_conv1_1_wb_tf32x3<THREADS>(base_ptr + WB_OFF, w, bias, tid);
  load_wt_tiles(base_ptr + WT_OFF, w, tid);

  XWin xw;
  if (mine > 0) {
    const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_y);
    xw.load(x + (long long)tl.b * H * W * 3, H, W, tl.x0 - 2, tl.y0 - 2,
            tid);
  }
  // This thread's rows of its warpgroup's groups: row0 + 64 * grp (+ 8),
  // and its column t4 of the fragments.
  const int lane_row0 = wg * GROUPS * 64 + 16 * warp + (lane >> 2);
  int m_image = -1;                        // the image whose M is loaded
  float acc[GROUPS][16], part[16];
  uint32_t mask[GROUPS];
  for (int u = 0; u < units; ++u) {
    // Fresh copies each unit: the shared-memory offsets derived from them
    // are recomputed, not held in registers across the loop (held, they
    // spilled).
    int row0 = lane_row0, t4 = lane & 3;
    asm volatile("" : "+r"(row0), "+r"(t4));
    const int i = u / SLABS, slab = u % SLABS;
    const Tile tl = tile_at(blockIdx.x + i * nblk, tiles_x, tiles_y);
    uint8_t* const st_ptr = base_ptr + (u % STAGES) * BOX_BYTES;
    const bool last = slab == SLABS - 1;
    if (slab == 0) {
      // The x window and M of this tile; the previous tile's readers
      // finished before its last barrier.
      xw.store(win, tid);
      if (tl.b != m_image) {
        load_m_tiles(base_ptr + MT_OFF, sym + (long long)tl.b * C * C,
                     base_ptr + WT_OFF, tid);
        m_image = tl.b;
      }
      fence_proxy_async();
      __syncthreads();
      if (i + 1 < mine) {
        const Tile tn = tile_at(blockIdx.x + (i + 1) * nblk, tiles_x,
                                tiles_y);
        xw.load(x + (long long)tn.b * H * W * 3, H, W, tn.x0 - 2, tn.y0 - 2,
                tid);
      }
      // Group by group: y, its mask, then y M into the group's running dP.
      // Halo row r is pixel (y0 - 1 + r / HX, x0 - 1 + r % HX), its 3 x 3
      // window at (r / HX, r % HX) of the x window.
#pragma unroll
      for (int grp = 0; grp < GROUPS; ++grp) {
        int pix[2];
        bool in[2];
#pragma unroll
        for (int rsel = 0; rsel < 2; ++rsel) {
          const int r = row0 + 64 * grp + 8 * rsel;
          const int hy = r / HX, hx = r % HX;
          const int gy = tl.y0 - 1 + hy, gx = tl.x0 - 1 + hx;
          in[rsel] = gy >= 0 && gy < H && gx >= 0 && gx < W;
          pix[rsel] = (hy * (HX + 2) + hx) * 3;
        }
        float y[32];
        conv1_1_y_tf32x3<HX + 2>(y, win, pix[0], pix[1], in[0], in[1], t4,
                                 base + WB_OFF);
        uint32_t bits = 0u;
#pragma unroll
        for (int v = 0; v < 32; ++v) bits |= (y[v] > 0.f ? 1u : 0u) << v;
        mask[grp] = bits;
        // y M in two halves of four k8 steps (channels 0-31, 32-63), one
        // after the other (both halves' fragments at once spilled); y's A
        // fragments: a[kk][rsel + 2h] = y[4kk + 2rsel + h].
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[grp][e] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t yhi[4][4], ylo[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              split_tf32(y[16 * half + 4 * kk + 2 * (v & 1) + (v >> 1)],
                         yhi[kk][v], ylo[kk][v]);
          fence_acc(acc[grp]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(yhi[kk]);
            fence_regs(ylo[kk]);
          }
          wgmma_fence();
          const uint32_t mt = base + MT_OFF + half * 2 * BT_BYTES;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            three_products(acc[grp], yhi[kk], ylo[kk], mt + kk * 32,
                           mt + BT_BYTES + kk * 32);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc[grp]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(yhi[kk]);
            fence_regs(ylo[kk]);
          }
        }
      }
    }
    mbar_wait(smem_u32(&full[u % STAGES]), (u / STAGES) & 1);
    // (dz * mask) W^T for this slab, group by group, each into a fresh
    // partial. d's fragments: a[m][rsel + 2h] holds d at row row0 + 64 grp
    // + 8 rsel and slab channel 8m + 2 t4 + h, element h of the 8-byte pair
    // at chunk 2m + t4 / 2, byte 8 (t4 % 2) of that row; the mask bit of
    // channel 32 slab + 8m + 2 t4 + h is y's accumulator 4 (4 slab + m) +
    // 2 rsel + h.
    const uint32_t wt = base + WT_OFF + slab * 2 * BT_BYTES;
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int rsel = 0; rsel < 2; ++rsel)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int row = row0 + 64 * grp + 8 * rsel;
          const float2 dv = *reinterpret_cast<const float2*>(
              st_ptr + sw128_chunk(row, 2 * m + (t4 >> 1)) + 8 * (t4 & 1));
          const uint32_t mb = mask[grp] >> (16 * slab + 4 * m + 2 * rsel);
          split_tf32((mb & 1u) ? dv.x : 0.f, ahi[m][rsel], alo[m][rsel]);
          split_tf32((mb & 2u) ? dv.y : 0.f, ahi[m][rsel + 2],
                     alo[m][rsel + 2]);
        }
      if (grp == GROUPS - 1 && !last) {
        // Every fragment of this stage is read: hand it back to TMA.
        __syncthreads();
        if (tid == 0 && u + STAGES < units) issue(u + STAGES);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = 0.f;
      fence_acc(part);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        fence_regs(ahi[m]);
        fence_regs(alo[m]);
      }
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < 4; ++m)
        three_products(part, ahi[m], alo[m], wt + m * 32,
                       wt + BT_BYTES + m * 32);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(part);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        fence_regs(ahi[m]);
        fence_regs(alo[m]);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[grp][e] += part[e];
    }
    if (!last) continue;

    // No thread reads the dz box of this stage any more.
    __syncthreads();
    // dP (k-major) over the box. Accumulator v of thread (warp w, lane l):
    // row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) +
    // (v & 1).
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
      const int yy = tl.y0 + oy, xg = tl.x0 + ox;
      if (yy >= H || xg >= W) continue;
      float sum = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int ddx = 0; ddx < 3; ++ddx)
          sum += dps[((dy * 3 + ddx) * 3 + c) * DP_PITCH +
                     (oy + 2 - dy) * HX + ox + 2 - ddx];
      dx[(((long long)tl.b * H + yy) * W + xg) * 3 + c] = sum;
    }
    // The stage, the x window and M are free; the generic writes to the
    // stage are ordered before the next TMA writes into it.
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && u + STAGES < units) issue(u + STAGES);
  }
}

}  // namespace

// x (B, H, W, 3) float32; dz (B, H, W, 64) float32, 16-byte aligned; w (27,
// 64) float32 (the HWIO weights flattened); b (64,) float32; sym (B, 64, 64)
// float32, 16-byte aligned (S itself, not assumed symmetric: row c holds
// S[c][:]); dx (B, H, W, 3) float32; blocks the persistent blocks. Returns
// a cudaError_t, or ENCODE_ERROR + the CUresult of the tensor-map encoding.
extern "C" int st3d_conv1_1_gram_bwd_tf32x3_f32(const void* x, const void* dz,
                                                const void* w, const void* b,
                                                const void* sym, void* dx,
                                                int B, int H, int W,
                                                int blocks, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap dzmap;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {32, HX, HY, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &dzmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(dz), dim,
      stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      conv1_1_gram_bwd_tf32x3_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  conv1_1_gram_bwd_tf32x3_kernel<<<(unsigned)blocks, THREADS, SMEM,
                                   (cudaStream_t)stream>>>(
      dzmap, (const float*)x, (const float*)w, (const float*)b,
      (const float*)sym, (float*)dx, H, W, tiles_x, tiles_y,
      B * tiles_x * tiles_y);
  return (int)cudaGetLastError();
}
