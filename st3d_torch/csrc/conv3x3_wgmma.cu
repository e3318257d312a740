// 3x3 SAME stride-1 convolution + bias (+ ReLU) on Hopper's tensor cores:
// bf16 NHWC activations, weights laid out (Cout, 9, Cin) by the wrapper,
// float32 accumulation, one rounding into bf16. The same mainloop with a
// second epilogue is C, conv + bias + ReLU + 2x2 max-pool with the window
// index (below).
//
// Replaces the TPU kernels st3d/kernels/conv_pallas.py::_conv_kernel,
// _conv_kernel_nopad and _conv_kernel_halo1 (entry _conv3x3_same_impl) for
// bf16 with Cin and Cout multiples of 8; csrc/conv3x3_tf32x3.cu takes
// float32 and csrc/conv3x3_narrow_wgmma.cu the other widths
// (kernels/conv.py::conv_route).
// With the pool epilogue it replaces, for bf16 with Cin and Cout multiples
// of 8 (kernels/conv.py::relu_pool_route), the TPU kernels
// st3d/kernels/stage1_pallas.py::_conv1_2_kernel (entry
// conv1_2_packed_pool, K4b; the same body as stage1v3_pallas.py's
// _c12_fwd_kernel, K10c), conv_pallas.py::_conv2x2_fwd_kernel (entry
// conv3x3_bias_relu_pool_packed, K5) and conv_pallas.py's
// conv3x3_bias_relu_pool with pool=True (K8); csrc/conv3x3_tf32x3.cu's pool
// epilogue takes float32.
//
// Work layout: an implicit GEMM with M = B*H*W output pixels, N = Cout,
// K = 9*Cin, walked tap by tap (dy, dx) and, inside a tap, in 64-channel
// slabs (64 bf16 = one 128-byte swizzle row). An output tile is 128 pixels
// x BN output channels:
//   - the 128 pixels are a BW x BH box of one image (BW*BH = 128, BW a
//     power of two): kernels/conv.py::tf32x3_tile's, the box whose tiles
//     cover the image with the fewest pixels past its edges (at 768², 64 x
//     2, 32 x 4 and 16 x 8 fit the 192-, 96- and 48-wide layers exactly,
//     where a 128-wide box ran a quarter past them); pool_tile's for C;
//   - BN (64, 128 or 256) is the wrapper's, kernels/conv.py::k2_bn: 64 and
//     128 for Cout up to 64 and 128; past that 256 unless 128's tiles fill
//     the SMs' waves enough better to make up for their smaller tile;
//   - x is described to TMA as the 4-D tensor (C, W, H, B), innermost
//     first. The A tile of tap (dy, dx) is the box (64, BW, BH, 1) at
//     (c0, x0 + dx, y0 + dy, b); TMA zero-fills the coordinates that fall
//     outside the tensor (-1, W, H, channels past Cin), which is exactly the
//     SAME padding, so no padded copy and no bounds test exist. The box lands
//     as a [128 x 64] K-major tile with the 128-byte swizzle, wgmma's A;
//   - the B tile is the box (64, 1, BN) of the (Cin, 9, Cout) weights, a
//     [BN x 64] K-major tile.
//
// Schedule: persistent. min(tiles, SMs) CTAs, one an SM, walk the output
// tiles t = CTA, CTA + CTAs, ..., channel tile by channel tile (pixel tile
// fastest), so the CTAs running at a time share B's slabs in L2; the ring's
// full and empty phases run on across tiles, so the producer loads the
// next tile's stages while the consumers run the epilogue.
//   - A stage holds A (16 KB) and B (BN * 128 bytes): as many stages as fit
//     beside the epilogue's buffer, 4 at BN = 256, 6 at 128, 8 at 64 (C: 5
//     and 8).
//   - One producer thread (warp 8) keeps the ring full with TMA; its
//     warpgroup gives up its registers (setmaxnreg 40) to the consumers
//     (232), which at BN = 256 hold 128 accumulators a thread.
//   - Two consumer warpgroups each run wgmma m64nBNk16 on their 64-row
//     half, A and B straight from the stage, keep one wgmma group in
//     flight, and free a stage on its "empty" mbarrier once the group that
//     read it has completed.
//   - Each output sums its products in one f32 accumulator in the same
//     order whatever the box, BN or schedule (tap, slab, k16 step), so the
//     outputs do not depend on them, bit for bit.
//   - Epilogue (STORE): accumulators + bias, optional ReLU, one rounding
//     into bf16, written to a buffer of its own as 64-channel boxes with
//     the 128-byte swizzle (a warp's writes hit 32 banks), up to 128
//     channels at a time, each box stored by TMA (which clips the pixels
//     and channels outside y); the consumers go on to the next tile while
//     the stores drain.
//   - Epilogue (POOL): the tile holds whole 2x2 windows (pool_tile: BW <=
//     64, so both sides are even; tile origins and H, W are even, so no
//     window straddles a tile or the image edge). The two rows of a window
//     lie 4 lanes apart in the accumulators, and at 64 x 2 in the two
//     warpgroups, so the pool goes through shared memory: bias, ReLU and
//     the bf16 rounding in registers; the rounded 128 x BN tile into C's
//     own buffer (rows padded by 16 bytes, so a warp's stores hit 32
//     banks); a 256-thread named barrier; then each thread pools whole
//     windows, 8 channels at a time, with conv_pallas.py::_pool4_first_max's
//     rule on the rounded values (w01 = c1 > c0, w23 = c3 > c2, idx = m23 >
//     m01 ? 2 + w23 : w01) and stores pooled (16 bytes) and idx (8 bytes)
//     along the channels. Only pooled and idx reach device memory.
//
// What bounds it on an H100: operations. Every VGG conv does 2*9*Cin*Cout
// flops per pixel against 2*(Cin + Cout) bytes, far above the 295 flops per
// byte of the bf16 roofline; the bf16 tensor cores (989 TFLOP/s) are the
// ceiling. Next in line is shared memory: per 64-channel slab TMA writes A
// and B and each warpgroup's wgmma read its half of A and all of B, 80 KB
// for 2.1 MFLOP at BN = 128, about 285 GB/s at the tensor cores' rate
// against the 234 GB/s (128 bytes a clock) an SM's shared memory delivers;
// at BN = 256, 128 KB for 4.2 MFLOP, a fifth fewer bytes a FLOP (analytic).
// TMA fetches each A box from L2 once per tap, nine times a slab. Then the
// fixed costs: the ring's fill at a CTA's first tile, the last wave's idle
// SMs (k2_bn weighs them), and the epilogue's writes to shared memory,
// during which the tensor cores wait. At the bf16 cells' shapes K2 runs at
// 55-65% of the tensor-core bound (H100 SXM, 700 W; PERF.md, section 6).
//
// The input gradient is this kernel on the cotangent with spatially
// flipped, IO-transposed weights and a zero bias (conv_pallas.py:468-475).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                          // output pixels per tile
constexpr int BK = 64;                           // channels per slab
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int PRODUCER = CONSUMERS * 128;        // the TMA thread
constexpr int THREADS = CONSUMERS * 128 + 128;   // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;             // 16 KB
// setmaxnreg budgets: each quarter of the SM's register file holds two
// consumer warps and one producer warp, 2 x 232 + 40 <= 512 a lane.
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

enum Epilogue { STORE = 0, POOL = 1 };

template <int BN, int EPI>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int POOL_ROW = 2 * BN + 16;   // bytes per staged row
  // The output channels STORE stages at a time: 128 at most, as 64-channel
  // boxes of 16 KB (TMA's 128-byte swizzle rows).
  static constexpr int OUT_N = BN < 128 ? BN : 128;
  // The epilogue's own buffer, after the ring.
  static constexpr int EPI_BYTES = EPI == POOL ? BM * POOL_ROW : BM * OUT_N * 2;
  // As many stages as fit beside it, 2 KB kept for the ring's alignment and
  // the barriers.
  static constexpr int STAGES = (232448 - 2048 - EPI_BYTES) / STAGE_BYTES;
  // + 1024: the ring is aligned to 1024 bytes inside the dynamic buffer,
  // as the 128-byte swizzle pattern repeats every 8 rows of 128 bytes.
  static constexpr int SMEM = STAGES * STAGE_BYTES + EPI_BYTES + 1024;
};

// The origin of output tile t: pixel tile t % tiles_m (its box
// bw x 128/bw of image b, tiles_x across) of channel tile t / tiles_m.
struct TileAt {
  int b, x0, y0, n0;
};

__device__ __forceinline__ TileAt tile_at(int t, int tiles_m, int tiles_x,
                                          int tiles_y, int bw_log2, int bn) {
  const int nt = t / tiles_m;
  int m = t - nt * tiles_m;
  const int tx = m % tiles_x;
  m /= tiles_x;
  TileAt at;
  at.x0 = tx << bw_log2;
  at.y0 = (m % tiles_y) * (BM >> bw_log2);
  at.b = m / tiles_y;
  at.n0 = nt * bn;
  return at;
}

// bf16 number k (0-7) of the 16 bytes q, as a float (exact).
__device__ __forceinline__ float bf16_at(const uint4& q, int k) {
  const uint32_t w = k < 2 ? q.x : k < 4 ? q.y : k < 6 ? q.z : q.w;
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// C's epilogue: relu(acc + bias) rounded to bf16, staged in C's own
// buffer, pooled 2x2 by whole windows. pooled and idx are (B, H/2, W/2,
// Cout); the tile's rows are (r >> bw_log2, r & (bw - 1)) from (y0, x0).
template <int BN>
__device__ __forceinline__ void pool_epilogue(
    const float (&acc)[BN / 2], uint8_t* stage,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ pooled,
    uint8_t* __restrict__ idx, int b, int x0, int y0, int n0, int H, int W,
    int Cout, int bw_log2) {
  constexpr int ROW = Tile<BN, POOL>::POOL_ROW;
  constexpr int CHUNKS = BN / 8;                 // 8-channel runs per pixel
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // Both warpgroups have pooled the previous tile out of the buffer.
  named_barrier(1, CONSUMERS * 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nl = 8 * j + 2 * (lane & 3);
    if (n0 + nl >= Cout) continue;
    const float b0 = __bfloat162float(bias[n0 + nl]);
    const float b1 = __bfloat162float(bias[n0 + nl + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + 16 * warp + 8 * h + (lane >> 2);
      *reinterpret_cast<__nv_bfloat162*>(stage + r * ROW + 2 * nl) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h] + b0, 0.f),
                                fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f));
    }
  }
  named_barrier(1, CONSUMERS * 128);
  // 32 windows of 2 x 2 per tile, BW/2 to a row of windows.
  const int bw = 1 << bw_log2;
  const int Hp = H >> 1, Wp = W >> 1;
  for (int item = threadIdx.x; item < 32 * CHUNKS; item += CONSUMERS * 128) {
    const int chunk = item % CHUNKS;
    const int win = item / CHUNKS;
    const int px = win & ((bw >> 1) - 1), py = win >> (bw_log2 - 1);
    const int n = n0 + 8 * chunk;
    const int yy = y0 + 2 * py, xx = x0 + 2 * px;
    if (n >= Cout || yy >= H || xx >= W) continue;
    // Window positions (0,0), (0,1), (1,0), (1,1): rows r, r+1, r+bw,
    // r+bw+1 of the tile.
    const uint8_t* s = stage + ((2 * py << bw_log2) + 2 * px) * ROW + 16 * chunk;
    const uint4 q0 = *reinterpret_cast<const uint4*>(s);
    const uint4 q1 = *reinterpret_cast<const uint4*>(s + ROW);
    const uint4 q2 = *reinterpret_cast<const uint4*>(s + bw * ROW);
    const uint4 q3 = *reinterpret_cast<const uint4*>(s + (bw + 1) * ROW);
    uint32_t out[4] = {0u, 0u, 0u, 0u}, id[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float a0 = bf16_at(q0, k), a1 = bf16_at(q1, k);
      const float a2 = bf16_at(q2, k), a3 = bf16_at(q3, k);
      const bool w01 = a1 > a0, w23 = a3 > a2;
      const float m01 = w01 ? a1 : a0, m23 = w23 ? a3 : a2;
      const bool wm = m23 > m01;
      // The winner is a bf16 value: its top 16 bits are exact.
      out[k >> 1] |= (__float_as_uint(wm ? m23 : m01) >> 16) << (16 * (k & 1));
      id[k >> 2] |= (uint32_t)(wm ? 2 + (int)w23 : (int)w01) << (8 * (k & 3));
    }
    const long long p = ((long long)b * Hp + (yy >> 1)) * Wp + (xx >> 1);
    *reinterpret_cast<uint4*>(pooled + p * Cout + n) =
        make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint2*>(idx + p * Cout + n) = make_uint2(id[0], id[1]);
  }
}

// K2's epilogue: acc + bias, optional ReLU, one rounding into bf16, staged
// OUT_N channels at a time in the buffer at out (generic) / out_s (shared)
// as 64-channel boxes with the 128-byte swizzle, each stored by one TMA
// store of the box (64, bw, 128/bw, 1) at (n, x0, y0, b) issued by thread
// 0, which clips the pixels and channels outside y. Thread 0 waits for a
// pass's stores to have read the buffer before the next pass writes it.
// Accumulator v of thread (warp w, lane l) of the warpgroup: row 16w +
// 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1); the
// writes of a warp hit 32 banks (the rows' chunks are swizzled apart).
template <int BN>
__device__ __forceinline__ void store_epilogue(
    const float (&acc)[BN / 2], uint8_t* out, uint32_t out_s,
    const CUtensorMap* ymap, const __nv_bfloat16* __restrict__ bias,
    const TileAt& at, int Cout, int relu) {
  constexpr int OUT_N = Tile<BN, STORE>::OUT_N;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int pass = 0; pass < BN / OUT_N; ++pass) {
    if (threadIdx.x == 0) bulk_wait_read<0>();
    named_barrier(2, CONSUMERS * 128);
#pragma unroll
    for (int jj = 0; jj < OUT_N / 8; ++jj) {
      const int j = pass * (OUT_N / 8) + jj;
      const int n = at.n0 + 8 * j + 2 * (lane & 3);
      if (n >= Cout) continue;
      const float b0 = __bfloat162float(bias[n]);
      const float b1 = __bfloat162float(bias[n + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + 16 * warp + 8 * h + (lane >> 2);
        float v0 = acc[4 * j + 2 * h] + b0;
        float v1 = acc[4 * j + 2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + (jj >> 3) * (BM * 128) + sw128_chunk(r, jj & 7) +
            4 * (lane & 3)) = __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_proxy_async();
    named_barrier(2, CONSUMERS * 128);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < OUT_N / 64; ++q) {
        const int n = at.n0 + pass * OUT_N + 64 * q;
        if (n < Cout)
          tma_store_4d(ymap, out_s + q * (BM * 128), n, at.x0, at.y0, at.b);
      }
      bulk_commit();
    }
  }
}

// Threads 0-255: the two consumer warpgroups; 256: the TMA producer (the
// rest of its warpgroup only lends its registers). EPI = POOL: y is
// pooled, idx the window index, relu is implied.
template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(__grid_constant__ const CUtensorMap xmap,
                     __grid_constant__ const CUtensorMap wmap,
                     __grid_constant__ const CUtensorMap ymap,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y,
                     uint8_t* __restrict__ idx, int H, int W, int Cin,
                     int Cout, int bw_log2, int tiles_x, int tiles_y,
                     int tiles_m, int relu) {
  using T = Tile<BN, EPI>;
  constexpr int STAGES = T::STAGES;
  constexpr int ACC = BN / 2;                    // f32 accumulators a thread
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  // The epilogue's buffer, shared and generic addresses.
  const uint32_t epi_s = ring + STAGES * T::STAGE_BYTES;
  uint8_t* const epi = smem_raw + (epi_s - smem_u32(smem_raw));
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[STAGES]);

  const int slabs = (Cin + BK - 1) / BK;
  const int n_iter = 9 * slabs;
  const int tiles = tiles_m * ((Cout + BN - 1) / BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMERS) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      // Producer: keep the ring full, across tiles.
      uint32_t g = 0;                            // ring position
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileAt at = tile_at(t, tiles_m, tiles_x, tiles_y, bw_log2, BN);
        for (int it = 0; it < n_iter; ++it, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty0 + 8 * s, ((g / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, T::STAGE_BYTES);
          const int tap = it / slabs;
          const int c0 = (it - tap * slabs) * BK;
          const uint32_t a_dst = ring + s * T::STAGE_BYTES;
          tma_load_4d(a_dst, &xmap, full, c0, at.x0 + tap % 3 - 1,
                      at.y0 + tap / 3 - 1, at.b);
          tma_load_3d(a_dst + A_BYTES, &wmap, full, c0, tap, at.n0);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows wg*64 .. wg*64+63 of each tile.
  regs_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  float acc[ACC];
  uint32_t g = 0;                                // ring position
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt at = tile_at(t, tiles_m, tiles_x, tiles_y, bw_log2, BN);
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_iter; ++it, ++g) {
      const int s = g % STAGES;
      mbar_wait(full0 + 8 * s, (g / STAGES) & 1);
      const uint32_t a = ring + s * T::STAGE_BYTES + wg * 64 * 128;
      const uint32_t bb = ring + s * T::STAGE_BYTES + A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // One k16 step is 32 bytes along the swizzled 128-byte row; the
        // leading offset of a K-major tile is unused (16).
        const uint64_t da = desc_sw128(a + kk * 32, 16);
        const uint64_t db = desc_sw128(bb + kk * 32, 16);
        if constexpr (BN == 256) {
          wgmma_m64n256k16<0, 0>(acc, da, db);
        } else if constexpr (BN == 128) {
          wgmma_m64n128k16<0, 0>(acc, da, db);
        } else {
          wgmma_m64n64k16<0, 0>(acc, da, db);
        }
      }
      wgmma_commit();
      fence_acc(acc);
      // The previous iteration's group has completed: free its stage.
      wgmma_wait<1>();
      if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));
    if constexpr (EPI == POOL) {
      pool_epilogue<BN>(acc, epi, bias, y, idx, at.b, at.x0, at.y0, at.n0, H,
                        W, Cout, bw_log2);
    } else {
      store_epilogue<BN>(acc, epi, epi_s, &ymap, bias, at, Cout, relu);
    }
  }
  // The last stores have read the buffer before the CTA's shared memory
  // goes.
  if (EPI == STORE && threadIdx.x == 0) bulk_wait<0>();
}

template <int BN, int EPI>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
           const CUtensorMap& ymap, const void* b, void* y, void* idx, int B,
           int H, int W, int Cin, int Cout, int bw_log2, int relu,
           cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN, EPI>::SMEM);
  if (err) return err;
  const int bw = 1 << bw_log2, bh = BM >> bw_log2;
  const int tiles_x = (W + bw - 1) / bw, tiles_y = (H + bh - 1) / bh;
  const int tiles_m = B * tiles_x * tiles_y;
  const int tiles = tiles_m * ((Cout + BN - 1) / BN);
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  conv3x3_wgmma_kernel<BN, EPI>
      <<<tiles < sms ? tiles : sms, THREADS, Tile<BN, EPI>::SMEM, stream>>>(
          xmap, wmap, ymap, (const __nv_bfloat16*)b, (__nv_bfloat16*)y,
          (uint8_t*)idx, H, W, Cin, Cout, bw_log2, tiles_x, tiles_y, tiles_m,
          relu);
  return (int)cudaGetLastError();
}

// Encodes the tensor maps of x, wk and (STORE) y and launches with BN = bn
// (64, 128 or, for STORE, 256).
template <int EPI>
int encode_and_launch(const void* x, const void* wk, const void* b, void* y,
                      void* idx, int B, int H, int W, int Cin, int Cout,
                      int bw_log2, int bn, int relu, void* stream) {
  const int bw = 1 << bw_log2;
  const cuuint64_t e = 2;                        // bytes per bf16
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap, ymap = {};
  // x and y as (C, W, H, B) tensors with the box (64, bw, 128/bw, 1).
  const auto encode = [&](CUtensorMap* map, const void* t, int C) {
    const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
    const cuuint64_t stride[3] = {C * e, (cuuint64_t)W * C * e,
                                  (cuuint64_t)H * W * C * e};
    const cuuint32_t box[4] = {BK, (cuuint32_t)bw, (cuuint32_t)(BM / bw), 1};
    return cuTensorMapEncodeTiled(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dim,
        stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode(&xmap, x, Cin);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  if (EPI == STORE) {
    r = encode(&ymap, y, Cout);
    if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  }
  r = encode_weights(&wmap, wk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, e, Cin, Cout,
                     BK, bn);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 64)
    return launch<64, EPI>(xmap, wmap, ymap, b, y, idx, B, H, W, Cin, Cout,
                           bw_log2, relu, st);
  if constexpr (EPI == STORE) {
    if (bn == 256)
      return launch<256, EPI>(xmap, wmap, ymap, b, y, idx, B, H, W, Cin,
                              Cout, bw_log2, relu, st);
  }
  return launch<128, EPI>(xmap, wmap, ymap, b, y, idx, B, H, W, Cin, Cout,
                          bw_log2, relu, st);
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// x (B, H, W, Cin) bf16, wk (Cout, 3, 3, Cin) bf16 (HWIO permuted so that K
// is innermost), b (Cout,) bf16, y (B, H, W, Cout) bf16; Cin and Cout
// multiples of 8, x and wk 16-byte aligned; bw the tile's width in pixels
// (a power of two, at most 128; the tile is bw x 128/bw pixels), bn its
// output channels (64, 128 or 256: kernels/conv.py::k2_bn). Returns a
// cudaError_t, or ENCODE_ERROR + the CUresult of a tensor-map encoding.
extern "C" int st3d_conv3x3_wgmma_bf16(const void* x, const void* wk,
                                       const void* b, void* y, int B, int H,
                                       int W, int Cin, int Cout, int bw,
                                       int bn, int relu, void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 0 || bw > BM || Cin % 8 || Cout % 8 ||
      (bn != 64 && bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<STORE>(x, wk, b, y, nullptr, B, H, W, Cin, Cout,
                                  bw_log2, bn, relu, stream);
}

// C: maxpool2x2(relu(conv3x3_same(x, wk) + b)) with the window index. x, wk
// and b as above; pooled (B, H/2, W/2, Cout) bf16 and idx (B, H/2, W/2,
// Cout) uint8, 16-byte aligned; H and W even; bw the tile's width (a power
// of two, 2 to 64: kernels/conv.py::pool_tile); BN 64 for Cout <= 64, else
// 128. Returns as above.
extern "C" int st3d_conv3x3_relu_pool_wgmma_bf16(const void* x, const void* wk,
                                                 const void* b, void* pooled,
                                                 void* idx, int B, int H,
                                                 int W, int Cin, int Cout,
                                                 int bw, void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 1 || bw > 64 || H % 2 || W % 2 || Cin % 8 || Cout % 8)
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<POOL>(x, wk, b, pooled, idx, B, H, W, Cin, Cout,
                                 bw_log2, Cout <= 64 ? 64 : 128, 1, stream);
}
