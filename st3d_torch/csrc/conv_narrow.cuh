// K2 at the widths TMA cannot stride, on Hopper's tensor cores: the kernel
// body shared by conv3x3_narrow_wgmma.cu (bf16) and
// conv3x3_narrow_tf32x3.cu (float32 by the 3xTF32 split). It computes
// kernels/conv.py::conv3x3_nhwc_plain: y = relu?(conv3x3_same(x, w) + b),
// x (B, H, W, Cin) NHWC, float32 accumulation, one rounding into x's
// dtype, for any Cin and Cout (kernels/conv.py::conv_route sends the widths
// that are not multiples of 8 in bf16 or 4 in float32 here).
//
// Why not the TMA kernels (conv3x3_wgmma.cu, conv3x3_tf32x3.cu): their
// operands and output all go through TMA, whose strides are multiples of 16
// bytes, and a 3-channel pixel is 6 or 12. So each operand takes the path
// its width allows:
//   - The tile is a BW x BH box of 128 output pixels, BW the smallest power
//     of two that covers the width, at most 64 (a 64 x 2 box reloads 2.1x
//     its pixels as halo, a 128 x 1 box 3x); its x halo, (BW + 2) x (BH +
//     2) pixels, goes into a ring of two stages, a tile ahead of the
//     products (more stages were no faster at 3 -> 64 and cost 64 -> 3
//     its second block an SM).
//     * "raw" halo (Cin * esize not a multiple of 32 bytes, conv1_1's 3
//       channels): each halo row is one contiguous run of global memory,
//       copied by every thread as whole 16-byte cp.async chunks (the run's
//       start shifted in shared memory to its address mod 16; the tensor's
//       end zero-filled). Halo pixels outside the image are never read: the
//       fragment loads test each tap against the image and give 0 there
//       (the SAME padding).
//     * "padded" halo (Cin a multiple of the 32-byte k-step, the 64 -> 3
//       input gradient): slabs of 64 bf16 / 32 float32 channels, each the
//       (slab, BW + 2, BH + 2, 1) box of x by one TMA load on the stage's
//       mbarrier, with the 128-byte swizzle (a warp's 16-byte fragment
//       loads of 8 pixels hit distinct banks) and TMA's zero fill for the
//       SAME padding and the channels past Cin; the slabs are walked in
//       turn. (16-byte cp.async from every thread moved these halos
//       markedly slower.)
//   - A from registers. The A operand (pixels x K) is never laid out in
//     shared memory: each thread loads its wgmma register fragment straight
//     from the halo (PTX's A fragment layout, hopper.cuh), so a tap is an
//     address offset and K needs no per-tap padding. K is the dense im2col
//     order k = (dy * 3 + dx) * Cin + c, padded at its end to one k-step
//     (16 bf16, 8 tf32): conv1_1's 27 taps are 2 bf16 k-steps, not 9. A
//     raw halo's threads look k up in a table (tap, dy, byte offset); a
//     padded halo's k-steps never straddle a tap.
//   - B, the weights of the block's NB output channels (NB of 8, 16, 32
//     or 64: wgmma's n granularity; Cout past 64 takes more blocks along
//     grid y), laid out by the wrapper K-major (NB * chunks, KT) with zero
//     rows past Cout, resident in shared memory in 128-byte-swizzled
//     panels of 4 k-steps (float32: the hi and lo parts of
//     kernels/conv.py::split_tf32, each).
//   - Two consumer warpgroups, 64 tile rows each, persistent blocks
//     walking tiles blockIdx.x + i * gridDim.x (raster order over image,
//     tile row, tile column) and, per tile, the halo's slabs. Per slab the
//     k-steps go in batches of 4 whose fragments are double-buffered in
//     registers: a batch's loads overlap the previous batch's wgmma.
//   - Epilogue: bias, optional ReLU, one rounding into the output dtype.
//     Where an output pixel is 128 or 256 bytes (Cout = 64, conv1_1), the
//     tile is staged as one or two (128 bytes, BW, BH, 1) boxes of y with
//     the 128-byte swizzle and leaves by TMA from one of two buffers, so it
//     drains while the next tile is computed (plain 16-byte stores from
//     every thread set the kernel's pace at 3 -> 64). Other widths
//     (Cout = 3 cannot be a TMA row): each tile row of the output is one
//     contiguous run of Cout-wide pixels, staged and written with 16-byte
//     stores (the staging shifted to the run's address mod 16), or element
//     by element where a block holds only some channels (Cout > 64).
//
// kernels/build.py hashes every csrc/*.cuh into each library, so an edit
// here rebuilds both sources.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace narrow {

using namespace hopper;

constexpr int THREADS = 256;          // two warpgroups
constexpr int BM = 128;               // output pixels per tile
constexpr int MAX_BW = 64;            // widest tile box: 64 x 2 pixels
constexpr int KB = 4;                 // k-steps per batch (a panel row)
constexpr int STAGES = 2;             // halo stages of the ring
constexpr int SMEM_LIMIT = 232448;    // a block's dynamic shared memory

// The launch plan: shapes, the tile box, the halo's form and the
// shared-memory layout (offsets from the 1024-byte aligned base), made on
// the host by make_plan.
struct Plan {
  int B, H, W, Cin, Cout, relu;
  int bw, bh, tiles_x, tiles_y, tiles;
  int padded;      // 1: TMA boxes of 128-byte channel slabs; 0: raw rows
  int slabs;       // channel slabs of a padded halo (raw: 1)
  int pitch;       // padded: bytes per halo pixel (128); raw: per halo row
  int kt, ksteps;  // K = 9 * Cin rounded up to a k-step, and its k-steps
  int tma_out;     // output boxes of 128-byte pixel slices a tile by TMA
                   // (1 or 2: a pixel of 128 or 256 bytes), else 0
  int w_off, w_lo_off, st_off, st_bytes, out_off, out_pitch, bias_off,
      tab_off, smem;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

template <bool TF32>
struct Dtype {
  static constexpr int ESIZE = TF32 ? 4 : 2;
  static constexpr int KSTEP = TF32 ? 8 : 16;   // a k-step: 32 bytes
  static constexpr int SLAB = TF32 ? 32 : 64;   // a slab: 128 bytes
};

// Host: the plan for NB output channels a block; false when its shared
// memory exceeds a block's (kernels/conv.py::narrow_smem mirrors the sum).
template <bool TF32>
inline bool make_plan(Plan& p, int B, int H, int W, int Cin, int Cout,
                      int relu, int nb) {
  using D = Dtype<TF32>;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.relu = relu;
  p.bw = 1;
  while (p.bw < (W < MAX_BW ? W : MAX_BW)) p.bw *= 2;
  p.bh = BM / p.bw;
  p.tiles_x = (W + p.bw - 1) / p.bw;
  p.tiles_y = (H + p.bh - 1) / p.bh;
  p.tiles = B * p.tiles_x * p.tiles_y;
  p.padded = Cin % D::KSTEP == 0;
  p.slabs = p.padded ? (Cin + D::SLAB - 1) / D::SLAB : 1;
  p.pitch = p.padded ? 128 : round_up((p.bw + 2) * Cin * D::ESIZE, 16) + 32;
  p.kt = round_up(9 * Cin, D::KSTEP);
  p.ksteps = p.kt / D::KSTEP;
  const int w_bytes = (p.kt * D::ESIZE + 127) / 128 * nb * 128;
  p.w_off = 0;
  p.w_lo_off = TF32 ? w_bytes : 0;
  p.st_off = TF32 ? 2 * w_bytes : w_bytes;
  p.st_bytes = round_up(
      (p.bh + 2) * (p.padded ? (p.bw + 2) * p.pitch : p.pitch), 1024);
  p.tma_out = nb == Cout && (Cout * D::ESIZE == 128 || Cout * D::ESIZE == 256)
                  ? Cout * D::ESIZE / 128
                  : 0;
  p.out_off = round_up(p.st_off + STAGES * p.st_bytes, 1024);
  p.out_pitch = round_up(p.bw * nb * D::ESIZE, 16) + 16;
  p.bias_off = p.out_off + (p.tma_out ? 2 * p.tma_out * BM * 128
                                      : round_up(p.bh * p.out_pitch, 128));
  p.tab_off = p.bias_off + round_up(4 * nb, 128);
  p.smem = p.tab_off + (p.padded ? 0 : 4 * p.kt) + 1024;
  return p.smem <= SMEM_LIMIT;
}

template <int NB>
__device__ __forceinline__ void mma_bf16(float (&d)[NB / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NB == 64) wgmma_m64n64k16_rs(d, a, b);
  else if constexpr (NB == 32) wgmma_m64n32k16_rs(d, a, b);
  else if constexpr (NB == 16) wgmma_m64n16k16_rs(d, a, b);
  else wgmma_m64n8k16_rs(d, a, b);
}

template <int NB>
__device__ __forceinline__ void mma_tf32(float (&d)[NB / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NB == 64) wgmma_m64n64k8_tf32_rs(d, a, b);
  else if constexpr (NB == 32) wgmma_m64n32k8_tf32_rs(d, a, b);
  else if constexpr (NB == 16) wgmma_m64n16k8_tf32_rs(d, a, b);
  else wgmma_m64n8k8_tf32_rs(d, a, b);
}

// This thread's two fragment rows (tile rows r and r + 8) in one tile: the
// taps inside the image (bit dy * 3 + dx) and where their halo data sit.
struct Rows {
  uint32_t taps[2];
  uint32_t at[2][3];   // raw: halo row py + dy at pixel px; padded: [r][0]
                       // the halo pixel index of (py, px), [r][1] the stage
};

// Raw halo: the descriptor of position k of the dense K, -1 past 9 * Cin,
// else tap << 26 | dy << 24 | its byte offset from the tap row's pixel,
// (dx * Cin + c) * esize.
__device__ __forceinline__ int k_desc(int k, int Cin, int esize) {
  if (k >= 9 * Cin) return -1;
  const int tap = k / Cin, c = k % Cin;
  return tap << 26 | (tap / 3) << 24 | ((tap % 3) * Cin + c) * esize;
}

// Raw halo: the element of descriptor d at fragment row rs, as its bits
// (the low 16 in bf16).
template <int ESIZE>
__device__ __forceinline__ uint32_t raw_element(const uint8_t* bp,
                                                const Rows& rw, int rs,
                                                int d) {
  const int tap = (d >> 26) & 15, dy = (d >> 24) & 3;
  const bool in = d >= 0 && ((rw.taps[rs] >> tap) & 1u);
  // Selects, not branches or an index (a run-time index would put Rows in
  // local memory): every load is issued, the ones outside read offset 0.
  const uint32_t row = dy == 0 ? rw.at[rs][0]
                       : dy == 1 ? rw.at[rs][1] : rw.at[rs][2];
  const uint8_t* p = bp + (in ? row + (d & 0xFFFFFF) : 0u);
  const uint32_t v =
      ESIZE == 2 ? (uint32_t)*reinterpret_cast<const unsigned short*>(p)
                 : *reinterpret_cast<const uint32_t*>(p);
  return in ? v : 0u;
}

// One batch: the fragments of k-steps s < ns (weight k-steps q0 + s),
// loaded after the batch two back has finished with the registers, then
// issued as one wgmma group. Raw halo: the dense k-steps q0 + s. Padded
// halo: tap ``tap``, channels KSTEP * s of the stage's slab.
template <bool TF32, int NB>
__device__ __forceinline__ void batch(float (&acc)[NB / 2],
                                      uint32_t (&fh)[KB][4],
                                      uint32_t (&fl)[KB][4],
                                      const uint8_t* bp, uint32_t wb,
                                      uint32_t wb_lo, const int* tab,
                                      const Rows& rw, const Plan& pl,
                                      int ns, int q0, int tap, int t4) {
  using D = Dtype<TF32>;
  wgmma_wait<1>();
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    fence_regs(fh[s]);
    if (TF32) fence_regs(fl[s]);
  }
  // Padded halo: the tap's offset in halo pixels.
  const uint32_t tap_off = pl.padded ? (tap / 3) * (pl.bw + 2) + tap % 3 : 0u;
  if (pl.padded && ns == KB) {
    // A full slab in the permuted k order (kernels/conv.py::narrow_perm):
    // 16-byte chunk 2 * t4 + m of a halo pixel holds this thread's
    // fragment words of k-steps 2m and 2m + 1, word w of the chunk those
    // of k-step 2m + (w >> 1), register pair v = rs + 2 * (w & 1). The
    // chunk lies at TMA's 128-byte swizzle: chunk ^ (pixel % 8).
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const bool in = (rw.taps[rs] >> tap) & 1u;
      const uint32_t pix = rw.at[rs][0] + tap_off;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t at = rw.at[rs][1] + pix * 128 +
                            (((2 * t4 + m) ^ (pix & 7)) << 4);
        uint4 c = *reinterpret_cast<const uint4*>(bp + (in ? at : 0u));
        if (!in) c = make_uint4(0u, 0u, 0u, 0u);
        const uint32_t words[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int st = 2 * m + (w >> 1), v = rs + 2 * (w & 1);
          if (TF32) {
            split_tf32(__uint_as_float(words[w]), fh[st][v], fl[st][v]);
          } else {
            fh[st][v] = words[w];
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      if (s >= ns) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int rs = v & 1;
        uint32_t bits;
        if (!pl.padded) {
          const int q = q0 + s;
          if (TF32) {
            bits = raw_element<4>(bp, rw, rs,
                                  tab[q * D::KSTEP + t4 + 4 * (v >> 1)]);
          } else {
            const int k = q * D::KSTEP + 2 * t4 + 8 * (v >> 1);
            bits = raw_element<2>(bp, rw, rs, tab[k]) |
                   (raw_element<2>(bp, rw, rs, tab[k + 1]) << 16);
          }
        } else {
          // A part-filled slab, channels in order (at the swizzle).
          const int c = TF32 ? D::KSTEP * s + t4 + 4 * (v >> 1)
                             : D::KSTEP * s + 2 * t4 + 8 * (v >> 1);
          const uint32_t pix = rw.at[rs][0] + tap_off;
          const uint32_t byte = c * D::ESIZE;
          bits = ((rw.taps[rs] >> tap) & 1u)
                     ? *reinterpret_cast<const uint32_t*>(
                           bp + rw.at[rs][1] + pix * 128 +
                           (((byte >> 4) ^ (pix & 7)) << 4) + (byte & 15))
                     : 0u;
        }
        if (TF32) {
          split_tf32(__uint_as_float(bits), fh[s][v], fl[s][v]);
        } else {
          fh[s][v] = bits;
        }
      }
    }
  }
  fence_acc(acc);
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    fence_regs(fh[s]);
    if (TF32) fence_regs(fl[s]);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    if (s >= ns) break;
    const int q = q0 + s;
    // Weight k-step q: panel q / 4 (NB rows of 128 bytes), 32 bytes each.
    const uint32_t off = (q >> 2) * NB * 128 + (q & 3) * 32;
    const uint64_t bh = desc_sw128(wb + off, 16);
    if (TF32) {
      const uint64_t bl = desc_sw128(wb_lo + off, 16);
      mma_tf32<NB>(acc, fl[s], bh);       // the small products first
      mma_tf32<NB>(acc, fh[s], bl);
      mma_tf32<NB>(acc, fh[s], bh);
    } else {
      mma_bf16<NB>(acc, fh[s], bh);
    }
  }
  wgmma_commit();
}

// Two blocks an SM (at most 128 registers a thread), but for the widest
// float32 block, whose accumulators and split fragments need more.
template <bool TF32, int NB>
__global__ void __launch_bounds__(THREADS, TF32 && NB == 64 ? 1 : 2)
conv3x3_narrow_kernel(const Plan pl,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap ymap,
                      const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ w_hi,
                      const uint8_t* __restrict__ w_lo,
                      const uint8_t* __restrict__ bias,
                      uint8_t* __restrict__ y) {
  using D = Dtype<TF32>;
  constexpr int E = D::ESIZE;
  __shared__ __align__(8) uint64_t full[STAGES];   // padded halo: TMA
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const bp = smem_raw + (base - smem_u32(smem_raw));
  int* const tab = reinterpret_cast<int*>(bp + pl.tab_off);
  float* const bias_s = reinterpret_cast<float*>(bp + pl.bias_off);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.y * NB;
  const int ncols = min(NB, pl.Cout - n0);
  const int Cin = pl.Cin, H = pl.H, W = pl.W;
  const int bw = pl.bw, lbw = __ffs(bw) - 1, hxw = bw + 2;

  // The block's weights into 128-byte swizzled K-major panels: 16-byte
  // chunk j of row n goes to panel j / 8, chunk j % 8 of its row n.
  const int cpr = pl.kt * E / 16;
  for (int i = tid; i < NB * cpr; i += THREADS) {
    const int n = i / cpr, j = i % cpr;
    const long long src = ((long long)(n0 + n) * pl.kt) * E + 16 * j;
    const uint32_t dst = (j >> 3) * NB * 128 + sw128_chunk(n, j & 7);
    *reinterpret_cast<uint4*>(bp + pl.w_off + dst) =
        __ldg(reinterpret_cast<const uint4*>(w_hi + src));
    if (TF32)
      *reinterpret_cast<uint4*>(bp + pl.w_lo_off + dst) =
          __ldg(reinterpret_cast<const uint4*>(w_lo + src));
  }
  for (int n = tid; n < NB; n += THREADS) {
    float v = 0.f;
    if (n < ncols) {
      v = TF32 ? reinterpret_cast<const float*>(bias)[n0 + n]
               : __bfloat162float(
                     reinterpret_cast<const __nv_bfloat16*>(bias)[n0 + n]);
    }
    bias_s[n] = v;
  }
  // Raw halo: the k descriptors.
  if (!pl.padded) {
    for (int k = tid; k < pl.kt; k += THREADS) tab[k] = k_desc(k, Cin, E);
  }
  // The weights are read by wgmma (the async proxy) after the first
  // barrier of the loop.
  fence_proxy_async();

  const int nblk = gridDim.x;
  const int mine = pl.tiles > (int)blockIdx.x
                       ? (pl.tiles - (int)blockIdx.x + nblk - 1) / nblk
                       : 0;
  const int units = mine * pl.slabs;     // (tile, slab) pairs, in order
  const long long x_bytes = (long long)pl.B * H * W * Cin * E;
  // The output staging (but for the TMA path): where the block holds every
  // channel, a tile row is one run of the output, staged as it lies in
  // global memory from its 16-byte boundary.
  const bool whole = ncols == pl.Cout;

  // Start the copies of unit u into stage u % STAGES.
  auto issue = [&](int u) {
    int t = blockIdx.x + (u / pl.slabs) * nblk;
    const int slab = u % pl.slabs;
    const int x0 = (t % pl.tiles_x) * bw;
    t /= pl.tiles_x;
    const int y0 = (t % pl.tiles_y) * pl.bh;
    const int b = t / pl.tiles_y;
    const uint32_t st = pl.st_off + (u % STAGES) * pl.st_bytes;
    if (!pl.padded) {
      const int per_row = pl.pitch / 16;
      for (int i = tid; i < (pl.bh + 2) * per_row; i += THREADS) {
        const int hy = i / per_row, q = i % per_row;
        const int gy = y0 - 1 + hy;
        if (gy < 0 || gy >= H) continue;
        const long long row = ((long long)b * H + gy) * W;
        const int xa = max(x0 - 1, 0), xb = min(x0 + bw, W - 1);
        const long long r0 = (row + x0 - 1) * Cin * E;
        const long long ga = (row + xa) * Cin * E;
        const long long ge = (row + xb + 1) * Cin * E;
        const long long c = (ga & ~15LL) + 16 * q;
        if (c >= ge) continue;
        const long long left = x_bytes - c;
        cp_async16(base + st + hy * pl.pitch + (uint32_t)(c - (r0 & ~15LL)),
                   x + c, left < 16 ? (uint32_t)left : 16u);
      }
    } else if (tid == 0) {
      // The slab's (SLAB, BW + 2, BH + 2, 1) box of x at (cs, x0 - 1, y0 -
      // 1, b), by TMA with the 128-byte swizzle; the box's pixels outside
      // the image and its channels past Cin arrive as zeros.
      const uint32_t bar = smem_u32(&full[u % STAGES]);
      mbar_expect_tx(bar, 128 * hxw * (pl.bh + 2));
      tma_load_4d(base + st, &xmap, bar, slab * D::SLAB, x0 - 1, y0 - 1, b);
    }
  };

  if (pl.padded && tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The ring: unit u + 1 is in flight while unit u's products run; one
  // cp.async group a unit (empty for a padded halo).
  if (units > 0) issue(0);
  cp_async_commit();

  float acc[NB / 2];
  uint32_t f0h[KB][4], f0l[KB][4], f1h[KB][4], f1l[KB][4];
  int stores = 0;                        // TMA stores issued
  const uint32_t wb = base + pl.w_off, wb_lo = base + pl.w_lo_off;
  for (int u = 0; u < units; ++u) {
    if (pl.padded) {
      mbar_wait(smem_u32(&full[u % STAGES]), (u / STAGES) & 1);
    } else {
      cp_async_wait<0>();
    }
    // The TMA store two tiles back has read out the staging this tile
    // fills.
    if (pl.tma_out && tid == 0) bulk_wait_read<1>();
    __syncthreads();          // unit u is in; unit u - 1's stage is free
    if (u + 1 < units) issue(u + 1);
    cp_async_commit();

    int t = blockIdx.x + (u / pl.slabs) * nblk;
    const int slab = u % pl.slabs;
    const int x0 = (t % pl.tiles_x) * bw;
    t /= pl.tiles_x;
    const int y0 = (t % pl.tiles_y) * pl.bh;
    const int b = t / pl.tiles_y;
    const uint32_t st = pl.st_off + (u % STAGES) * pl.st_bytes;

    // This thread's rows m = wg * 64 + 16 * warp + g + 8 * rs: tile pixel
    // (m >> lbw, m & (bw - 1)).
    Rows rw;
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int m = wg * 64 + 16 * warp + g + 8 * rs;
      const int py = m >> lbw, px = m & (bw - 1);
      uint32_t taps = 0u;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int yy = y0 + py + dy - 1, xx = x0 + px + dx - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            taps |= 1u << (dy * 3 + dx);
        }
      rw.taps[rs] = taps;
      if (pl.padded) {
        rw.at[rs][0] = py * hxw + px;
        rw.at[rs][1] = st;
        rw.at[rs][2] = 0u;
      } else {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const long long r0 =
              (((long long)b * H + y0 - 1 + py + dy) * W + x0 - 1) * Cin * E;
          rw.at[rs][dy] = st + (py + dy) * pl.pitch + (uint32_t)(r0 & 15) +
                          px * Cin * E;
        }
      }
    }

    if (slab == 0) {
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    }
    if (!pl.padded) {
      const int nbatch = (pl.ksteps + KB - 1) / KB;
      for (int j = 0; j < nbatch; j += 2) {
        batch<TF32, NB>(acc, f0h, f0l, bp, wb, wb_lo, tab, rw, pl,
                        min(KB, pl.ksteps - KB * j), KB * j, 0, t4);
        if (j + 1 < nbatch)
          batch<TF32, NB>(acc, f1h, f1l, bp, wb, wb_lo, tab, rw, pl,
                          min(KB, pl.ksteps - KB * (j + 1)), KB * (j + 1),
                          0, t4);
      }
    } else {
      const int cs = slab * D::SLAB;
      const int ns = min(D::SLAB, Cin - cs) / D::KSTEP;
      for (int tap = 0; tap < 9; tap += 2) {
        batch<TF32, NB>(acc, f0h, f0l, bp, wb, wb_lo, tab, rw, pl, ns,
                        (tap * Cin + cs) / D::KSTEP, tap, t4);
        if (tap + 1 < 9)
          batch<TF32, NB>(acc, f1h, f1l, bp, wb, wb_lo, tab, rw, pl, ns,
                          ((tap + 1) * Cin + cs) / D::KSTEP, tap + 1, t4);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      fence_regs(f0h[s]);
      fence_regs(f1h[s]);
      if (TF32) {
        fence_regs(f0l[s]);
        fence_regs(f1l[s]);
      }
    }
    if (slab != pl.slabs - 1) continue;

    // Epilogue into the staging. Accumulator v of thread (warp w, lane l):
    // row 16w + 8*((v >> 1) & 1) + l/4 of the warpgroup's 64, column
    // 8*(v >> 2) + 2*(l & 3) + (v & 1).
    if (pl.tma_out) {
      // 128- or 256-byte pixels: the tile as one or two (128 bytes, BW, BH,
      // 1) boxes of y with the 128-byte swizzle (pixel m's 16-byte chunk j
      // at chunk j ^ (m % 8): the accumulator stores of 8 rows hit
      // distinct banks), stored by TMA from one of two buffers, so the
      // store drains while the next tile is computed; TMA clips the pixels
      // past the image.
      const uint32_t ob =
          pl.out_off + (stores & 1) * (pl.tma_out * BM * 128);
#pragma unroll
      for (int v = 0; v < NB / 2; v += 2) {
        const int m = wg * 64 + 16 * warp + 8 * ((v >> 1) & 1) + g;
        const int n = 8 * (v >> 2) + 2 * t4;
        float v0 = acc[v] + bias_s[n], v1 = acc[v + 1] + bias_s[n + 1];
        if (pl.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int byte = n * E;               // box byte >> 7, at byte % 128
        uint8_t* const dst = bp + ob + (byte >> 7) * (BM * 128) +
                             sw128_chunk(m, (byte & 127) >> 4) + (byte & 15);
        if (TF32) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        for (int k = 0; k < pl.tma_out; ++k)
          tma_store_4d(&ymap, base + ob + k * (BM * 128), k * (128 / E), x0,
                       y0, b);
        bulk_commit();
      }
      ++stores;
      continue;
    }
    uint8_t* const out = bp + pl.out_off;
    uint8_t* orow[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int m = wg * 64 + 16 * warp + g + 8 * rs;
      const int py = m >> lbw, px = m & (bw - 1);
      const long long g0 =
          (((long long)b * H + y0 + py) * W + x0) * pl.Cout * E;
      const int shift = whole ? (int)(g0 & 15) : 0;
      orow[rs] = out + py * pl.out_pitch + shift + px * ncols * E;
    }
#pragma unroll
    for (int v = 0; v < NB / 2; v += 2) {
      const int n = 8 * (v >> 2) + 2 * t4;
      if (n >= ncols) continue;
      uint8_t* const dst = orow[(v >> 1) & 1] + n * E;
      float v0 = acc[v] + bias_s[n], v1 = acc[v + 1] + bias_s[n + 1];
      if (pl.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const bool two = n + 1 < ncols;
      if (TF32) {
        *reinterpret_cast<float*>(dst) = v0;
        if (two) *reinterpret_cast<float*>(dst + 4) = v1;
      } else if (two && ((uintptr_t)dst & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(v0);
        if (two)
          *reinterpret_cast<__nv_bfloat16*>(dst + 2) =
              __float2bfloat16_rn(v1);
      }
    }
    __syncthreads();

    // The staging out: tile row py is the run of npx pixels at g0.
    const int npx = min(bw, W - x0);
    const int nrows = min(pl.bh, H - y0);
    if (whole) {
      const int run = npx * pl.Cout * E;          // bytes of a row's run
      const int per_row = (run + 31) / 16;        // 16-byte chunks, at most
      for (int i = tid; i < nrows * per_row; i += THREADS) {
        const int py = i / per_row, q = i % per_row;
        const long long g0 =
            (((long long)b * H + y0 + py) * W + x0) * pl.Cout * E;
        const long long gs = (g0 & ~15LL) + 16 * q;
        if (gs >= g0 + run) continue;
        const uint8_t* src = out + py * pl.out_pitch + 16 * q;
        if (gs >= g0 && gs + 16 <= g0 + run) {
          *reinterpret_cast<uint4*>(y + gs) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 16; e += E) {
            if (gs + e < g0 || gs + e >= g0 + run) continue;
            if (TF32) {
              *reinterpret_cast<float*>(y + gs + e) =
                  *reinterpret_cast<const float*>(src + e);
            } else {
              *reinterpret_cast<unsigned short*>(y + gs + e) =
                  *reinterpret_cast<const unsigned short*>(src + e);
            }
          }
        }
      }
    } else {
      for (int i = tid; i < nrows * bw * ncols; i += THREADS) {
        const int py = i / (bw * ncols), r = i % (bw * ncols);
        const int px = r / ncols, n = r % ncols;
        if (px >= npx) continue;
        const long long dst =
            ((((long long)b * H + y0 + py) * W + x0 + px) * pl.Cout + n0 +
             n) * E;
        const uint8_t* src =
            out + py * pl.out_pitch + (px * ncols + n) * E;
        if (TF32) {
          *reinterpret_cast<float*>(y + dst) =
              *reinterpret_cast<const float*>(src);
        } else {
          *reinterpret_cast<unsigned short*>(y + dst) =
              *reinterpret_cast<const unsigned short*>(src);
        }
      }
    }
  }
  if (pl.tma_out && tid == 0) bulk_wait<0>();
}

// Host: the launch on ``stream`` for NB output channels a block (w_hi,
// w_lo (NB * ceil(Cout / NB), KT) K-major; w_lo unused in bf16); returns a
// cudaError_t.
template <bool TF32, int NB>
inline int launch_nb(const void* x, const void* w_hi, const void* w_lo,
                     const void* b, void* y, int B, int H, int W, int Cin,
                     int Cout, int relu, cudaStream_t stream) {
  Plan pl;
  if (!make_plan<TF32>(pl, B, H, W, Cin, Cout, relu, NB))
    return (int)cudaErrorInvalidValue;
  // x's tensor map (a padded halo only; else unused): boxes of one slab
  // over the halo, SAME padding and channels past Cin by TMA's zero fill.
  CUtensorMap xmap = {};
  if (pl.padded) {
    const cuuint64_t e = TF32 ? 4 : 2;
    const cuuint64_t dim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
    const cuuint64_t stride[3] = {Cin * e, (cuuint64_t)W * Cin * e,
                                  (cuuint64_t)H * W * Cin * e};
    const cuuint32_t box[4] = {(cuuint32_t)Dtype<TF32>::SLAB,
                               (cuuint32_t)pl.bw + 2, (cuuint32_t)pl.bh + 2,
                               1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    const CUresult r = cuTensorMapEncodeTiled(
        &xmap,
        TF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        4, const_cast<void*>(x), dim, stride, box, ones,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  }
  // The output's tensor map (the 128-byte-pixel path only; else unused).
  CUtensorMap ymap = {};
  if (pl.tma_out) {
    const cuuint64_t dim[4] = {(cuuint64_t)Cout, (cuuint64_t)W,
                               (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t px = (cuuint64_t)Cout * (TF32 ? 4 : 2);
    const cuuint64_t stride[3] = {px, (cuuint64_t)W * px,
                                  (cuuint64_t)H * W * px};
    const cuuint32_t box[4] = {(cuuint32_t)(TF32 ? 32 : 64),
                               (cuuint32_t)pl.bw, (cuuint32_t)pl.bh, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    const CUresult r = cuTensorMapEncodeTiled(
        &ymap,
        TF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        4, y, dim, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  }
  auto kernel = conv3x3_narrow_kernel<TF32, NB>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, THREADS, pl.smem);
  if (err) return err;
  const int blocks = max(1, min(pl.tiles, max(per_sm, 1) * sms));
  kernel<<<dim3((unsigned)blocks, (unsigned)((Cout + NB - 1) / NB)),
           THREADS, pl.smem, stream>>>(
      pl, xmap, ymap, (const uint8_t*)x, (const uint8_t*)w_hi, (const uint8_t*)w_lo,
      (const uint8_t*)b, (uint8_t*)y);
  return (int)cudaGetLastError();
}

template <bool TF32>
inline int launch(const void* x, const void* w_hi, const void* w_lo,
                  const void* b, void* y, int B, int H, int W, int Cin,
                  int Cout, int relu, int nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 8:
      return launch_nb<TF32, 8>(x, w_hi, w_lo, b, y, B, H, W, Cin, Cout,
                                relu, st);
    case 16:
      return launch_nb<TF32, 16>(x, w_hi, w_lo, b, y, B, H, W, Cin, Cout,
                                 relu, st);
    case 32:
      return launch_nb<TF32, 32>(x, w_hi, w_lo, b, y, B, H, W, Cin, Cout,
                                 relu, st);
    case 64:
      return launch_nb<TF32, 64>(x, w_hi, w_lo, b, y, B, H, W, Cin, Cout,
                                 relu, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace narrow
