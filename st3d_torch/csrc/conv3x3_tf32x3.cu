// 3x3 SAME stride-1 convolution + bias (+ ReLU) in float32 on Hopper's
// tensor cores, by the 3xTF32 split: f32 NHWC activations, weights laid out
// (Cout, 9, Cin) and split into hi and lo parts by the wrapper, f32
// accumulation and output. The same mainloop with a second epilogue is C in
// float32, conv + bias + ReLU + 2x2 max-pool with the window index (below).
//
// Replaces the TPU kernels st3d/kernels/conv_pallas.py::_conv_kernel,
// _conv_kernel_nopad and _conv_kernel_halo1 (entry _conv3x3_same_impl) for
// float32 with Cin and Cout multiples of 4; csrc/conv3x3_narrow_tf32x3.cu
// takes the other widths (kernels/conv.py::conv_route). With the
// pool epilogue it replaces, for float32 with Cin and Cout multiples of 4
// (kernels/conv.py::relu_pool_route), the TPU kernels
// st3d/kernels/stage1_pallas.py::_conv1_2_kernel (entry conv1_2_packed_pool,
// K4b; K10c's _c12_fwd_kernel is the same body),
// conv_pallas.py::_conv2x2_fwd_kernel (entry conv3x3_bias_relu_pool_packed,
// K5) and conv_pallas.py's conv3x3_bias_relu_pool with pool=True (K8).
//
// Numerics. One TF32 product keeps about 11 bits of each factor, too few
// for the f32 tolerance (1e-4 of the largest output). Each factor is split
// exactly, x = x_hi + x_lo, where x_hi is x with its low 13 mantissa bits
// cleared (a TF32 value) and x_lo = x - x_hi (exact in f32), and
//   a * b ~= a_hi * b_hi + a_hi * b_lo + a_lo * b_hi,
// three TF32 products; a_lo * b_lo and the bits of a_lo, b_lo past TF32
// are below 2^-20 of a * b. The hi parts are cleared here, not left to the
// tensor core, so hi + lo == x holds exactly whatever the hardware does
// with the low bits. The tensor core's own f32 sum loses more: summed in
// one accumulator over 3 * 9 * Cin / 8 wgmma, the conv came 1.7e-5 of its
// largest output off a float64 conv at Cin = 256 (H100), as adds that
// truncate would. So each k-iteration's 12 wgmma sum into a fresh partial
// (the first overwrites it), which the CUDA cores add to the running sum
// (round to nearest), k-iteration by k-iteration in the k order below.
//
// Work layout: csrc/conv3x3_wgmma.cu's implicit GEMM (M = B*H*W output
// pixels, N = Cout, K = 9*Cin, tap by tap, 32-channel slabs inner; 32 f32
// = one 128-byte swizzle row): x is the 4-D TMA tensor (C, W, H, B); tap
// (dy, dx)'s A tile is the box (32, BW, BH, 1) at (c0, x0 + dx, y0 + dy, b),
// zero-filled outside the tensor, which is the SAME padding; B_hi and B_lo
// are boxes (32, 1, BN) of the two (Cout, 9, Cin) weight parts. The tile's
// box is kernels/conv.py::tf32x3_tile's, the 128-pixel box that pads the
// image least (at 768², 64 x 2, 32 x 4 and 16 x 8 fit the 192-, 96- and
// 48-wide layers exactly, where a 128-wide box ran a third past them).
//
// Schedule: persistent. min(tiles, SMs) CTAs, one an SM, walk the output
// tiles t = CTA, CTA + CTAs, ..., channel tile by channel tile (pixel tile
// fastest), so the CTAs running at a time share B's slabs in L2; the ring's
// full and empty phases run on across tiles, so the producer loads the
// next tile's stages while the consumers run the epilogue.
//   - A stage holds A (16 KB) and B_hi and B_lo (BN * 128 bytes each): 48
//     KB at BN = 128, 4 stages; 32 KB at BN = 64, 7 stages; C stages its
//     tile in a buffer of its own and keeps 3 and 5.
//   - One producer thread (warp 8) keeps the ring full with TMA; its
//     warpgroup gives up its registers (setmaxnreg 40) to the consumers
//     (232).
//   - Two consumer warpgroups, 64 rows each. Per stage a thread reads its
//     A fragments of the 4 k8 steps from the swizzled stage (16 four-byte
//     loads), splits them into hi and lo in registers, issues three
//     wgmma m64nBNk8 with A from registers per k8 step into the partial,
//     waits for them, frees the stage and folds the partial in; the other
//     warpgroup's group keeps the tensor cores busy meanwhile.
//   - Epilogue (STORE): accumulators + bias, optional ReLU, f32 stores from
//     registers; pixels of the box outside the image are not stored.
//   - Epilogue (POOL), csrc/conv3x3_wgmma.cu's pool in float32: the tile
//     holds whole 2x2 windows (kernels/conv.py::pool_tile: BW <= 64, both
//     sides even, origins and H, W even). The two rows of a window lie in
//     the two warpgroups, so bias and ReLU are applied in registers (f32,
//     no rounding step) and the 128 x BN f32 tile is staged in its own
//     buffer, rows padded by 32 bytes so that each half-warp's 8-byte
//     stores hit 32 banks (36 KB at BN = 64, 68 KB at BN = 128); after a
//     256-thread named barrier each thread pools whole windows, 4 channels
//     at a time, by conv_pallas.py::_pool4_first_max's strict comparisons
//     in scan order (w01 = c1 > c0, w23 = c3 > c2, idx = m23 > m01 ? 2 +
//     w23 : w01), so an all-zero window gives idx 0, and stores pooled (16
//     bytes) and idx (4 bytes) along the channels. Only pooled and idx
//     reach device memory: 5/16 of the bytes the STORE epilogue writes.
//
// What bounds it on an H100: operations, 3 * 2 * 9 * Cin * Cout flops per
// pixel on the TF32 tensor cores (495 TFLOP/s), against 4 * (Cin + Cout)
// bytes (C: 4 * Cin + 5/4 * Cout). Next in line is shared memory: a stage
// takes 48 KB from TMA and the wgmma of both warpgroups read B, 96 KB at
// BN = 128, for 3.1 MFLOP. Reading A from registers keeps the hi and lo
// copies of A (and the 48 KB a stage of splitting them in shared memory)
// off it. Measured alternatives (PERF.md, section 6): split warps writing
// a_hi and a_lo to shared memory, one wgmma group in flight on two
// partials, and B multicast over 2-CTA clusters each ran no faster.
//
// The input gradient is this kernel on the cotangent with spatially
// flipped, IO-transposed weights and a zero bias (conv_pallas.py:468-475).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                          // output pixels per tile
constexpr int BK = 32;                           // f32 channels per slab
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int PRODUCER = CONSUMERS * 128;        // the TMA thread
constexpr int THREADS = CONSUMERS * 128 + 128;   // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 4;             // 16 KB
// setmaxnreg budgets: each quarter of the SM's register file holds two
// consumer warps and one producer warp, 2 x 232 + 40 <= 512 a lane.
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

enum Epilogue { STORE = 0, POOL = 1 };

template <int BN, int EPI>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 4;
  // A, B_hi, B_lo, all filled by TMA.
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int POOL_ROW = 4 * BN + 32;   // bytes per staged row
  static constexpr int POOL_BYTES = EPI == POOL ? BM * POOL_ROW : 0;
  // As many stages as fit beside the pool buffer, 2 KB kept for the
  // ring's alignment and the barriers.
  static constexpr int STAGES = (232448 - 2048 - POOL_BYTES) / STAGE_BYTES;
  // + 1024: the ring is aligned to 1024 bytes inside the dynamic buffer,
  // as the 128-byte swizzle pattern repeats every 8 rows of 128 bytes.
  static constexpr int SMEM = STAGES * STAGE_BYTES + POOL_BYTES + 1024;
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

// One k-iteration of warpgroup wg on the stage at st (a: its generic
// address): this thread's A fragments of the 4 k8 steps (row r, float
// column c of the swizzled A tile at r * 128 + (((c / 4) ^ (r % 8)) << 4) +
// 4 * (c % 4); hopper.cuh's wgmma_m64n64k8_tf32_rs gives the fragment's
// rows and columns), split into tf32 hi and lo in registers; 12 wgmma into
// the partial p, the first overwriting it (per k8 step lo x hi, hi x lo,
// hi x hi: the small products first); waited for, so that the fragments
// stay live until the tensor cores have read them.
template <int BN>
__device__ __forceinline__ void k_iteration(float (&p)[BN / 2], uint32_t st,
                                            const uint8_t* a, int wg) {
  const int lane = threadIdx.x & 31;
  const int r0 = wg * 64 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      // Rows r0 and r0 + 8 (r % 8 = lane / 4), columns 8kk + lane % 4 and
      // 4 more: the 32 lanes hit 32 banks.
      const int r = r0 + 8 * (v & 1);
      const float x = *reinterpret_cast<const float*>(
          a + r * 128 + (((2 * kk + (v >> 1)) ^ (lane >> 2)) << 4) +
          4 * (lane & 3));
      split_tf32(x, ahi[kk][v], alo[kk][v]);
    }
    fence_regs(ahi[kk]);
    fence_regs(alo[kk]);
  }
  const uint32_t b_hi = st + A_BYTES;
  const uint32_t b_lo = b_hi + BN * BK * 4;
  fence_acc(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    // One k8 step is 32 bytes along the swizzled 128-byte row; the leading
    // offset of a K-major tile is unused (16).
    const uint64_t dbh = desc_sw128(b_hi + kk * 32, 16);
    const uint64_t dbl = desc_sw128(b_lo + kk * 32, 16);
    if constexpr (BN == 128) {
      wgmma_m64n128k8_tf32_rs(p, alo[kk], dbh, kk > 0);
      wgmma_m64n128k8_tf32_rs(p, ahi[kk], dbl);
      wgmma_m64n128k8_tf32_rs(p, ahi[kk], dbh);
    } else {
      wgmma_m64n64k8_tf32_rs(p, alo[kk], dbh, kk > 0);
      wgmma_m64n64k8_tf32_rs(p, ahi[kk], dbl);
      wgmma_m64n64k8_tf32_rs(p, ahi[kk], dbh);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(p);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    fence_regs(ahi[kk]);
    fence_regs(alo[kk]);
  }
}

// C's epilogue: relu(acc + bias) in f32, staged in its own buffer, pooled
// 2x2 by whole windows. pooled and idx are (B, H/2, W/2, Cout); the tile's
// rows are (r >> bw_log2, r & (bw - 1)) from (y0, x0).
template <int BN>
__device__ __forceinline__ void pool_epilogue(
    const float (&acc)[BN / 2], uint8_t* stage, const float* __restrict__ bias,
    float* __restrict__ pooled, uint8_t* __restrict__ idx, int b, int x0,
    int y0, int n0, int H, int W, int Cout, int bw_log2) {
  constexpr int ROW = 4 * BN + 32;               // bytes per staged row
  constexpr int CHUNKS = BN / 4;                 // 4-channel runs per pixel
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // Both warpgroups have pooled the previous tile out of the buffer.
  named_barrier(3, CONSUMERS * 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nl = 8 * j + 2 * (lane & 3);
    if (n0 + nl >= Cout) continue;
    const float b0 = bias[n0 + nl];
    const float b1 = bias[n0 + nl + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + 16 * warp + 8 * h + (lane >> 2);
      *reinterpret_cast<float2*>(stage + r * ROW + 4 * nl) =
          make_float2(fmaxf(acc[4 * j + 2 * h] + b0, 0.f),
                      fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f));
    }
  }
  named_barrier(3, CONSUMERS * 128);
  // 32 windows of 2 x 2 per tile, BW/2 to a row of windows.
  const int bw = 1 << bw_log2;
  const int Hp = H >> 1, Wp = W >> 1;
  for (int item = threadIdx.x; item < 32 * CHUNKS; item += CONSUMERS * 128) {
    const int chunk = item % CHUNKS;
    const int win = item / CHUNKS;
    const int px = win & ((bw >> 1) - 1), py = win >> (bw_log2 - 1);
    const int n = n0 + 4 * chunk;
    const int yy = y0 + 2 * py, xx = x0 + 2 * px;
    if (n >= Cout || yy >= H || xx >= W) continue;
    // Window positions (0,0), (0,1), (1,0), (1,1): rows r, r+1, r+bw,
    // r+bw+1 of the tile.
    const uint8_t* s = stage + ((2 * py << bw_log2) + 2 * px) * ROW + 16 * chunk;
    const float4 q0 = *reinterpret_cast<const float4*>(s);
    const float4 q1 = *reinterpret_cast<const float4*>(s + ROW);
    const float4 q2 = *reinterpret_cast<const float4*>(s + bw * ROW);
    const float4 q3 = *reinterpret_cast<const float4*>(s + (bw + 1) * ROW);
    const float a0[4] = {q0.x, q0.y, q0.z, q0.w};
    const float a1[4] = {q1.x, q1.y, q1.z, q1.w};
    const float a2[4] = {q2.x, q2.y, q2.z, q2.w};
    const float a3[4] = {q3.x, q3.y, q3.z, q3.w};
    float out[4];
    uint32_t id = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool w01 = a1[k] > a0[k], w23 = a3[k] > a2[k];
      const float m01 = w01 ? a1[k] : a0[k], m23 = w23 ? a3[k] : a2[k];
      const bool wm = m23 > m01;
      out[k] = wm ? m23 : m01;
      id |= (uint32_t)(wm ? 2 + (int)w23 : (int)w01) << (8 * k);
    }
    const long long p = ((long long)b * Hp + (yy >> 1)) * Wp + (xx >> 1);
    *reinterpret_cast<float4*>(pooled + p * Cout + n) =
        make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint32_t*>(idx + p * Cout + n) = id;
  }
}

// K2's epilogue: acc + bias, optional ReLU, f32 stores from registers;
// pixels of the box outside the image are not stored. Accumulator v of
// thread (warp w, lane l) of the warpgroup: row 16w + 8*((v >> 1) & 1) +
// l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1).
template <int BN>
__device__ __forceinline__ void store_epilogue(
    const float (&acc)[BN / 2], const float* __restrict__ bias,
    float* __restrict__ y, int b, int x0, int y0, int n0, int H, int W,
    int Cout, int bw_log2, int relu) {
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int bw = 1 << bw_log2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    if (n >= Cout) continue;
    const float b0 = bias[n];
    const float b1 = bias[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + 16 * warp + 8 * h + (lane >> 2);
      const int yy = y0 + (r >> bw_log2);
      const int xx = x0 + (r & (bw - 1));
      if (yy >= H || xx >= W) continue;
      float v0 = acc[4 * j + 2 * h] + b0;
      float v1 = acc[4 * j + 2 * h + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const long long pix = ((long long)b * H + yy) * W + xx;
      *reinterpret_cast<float2*>(y + pix * Cout + n) = make_float2(v0, v1);
    }
  }
}

// Threads 0-255: the two consumer warpgroups; 256: the TMA producer (the
// rest of its warpgroup only lends its registers). EPI = POOL: y is
// pooled, idx the window index, relu is implied.
template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_tf32x3_kernel(__grid_constant__ const CUtensorMap xmap,
                      __grid_constant__ const CUtensorMap whimap,
                      __grid_constant__ const CUtensorMap wlomap,
                      const float* __restrict__ bias, float* __restrict__ y,
                      uint8_t* __restrict__ idx, int H, int W, int Cin,
                      int Cout, int bw_log2, int tiles_x, int tiles_y,
                      int tiles_m, int relu) {
  using T = Tile<BN, EPI>;
  constexpr int STAGES = T::STAGES;
  constexpr int ACC = BN / 2;                    // f32 accumulators a thread
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  // The generic-proxy view of the ring, for the A fragments and the pool.
  uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
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
        const TileAt at =
            tile_at(t, tiles_m, tiles_x, tiles_y, bw_log2, BN);
        for (int it = 0; it < n_iter; ++it, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty0 + 8 * s, ((g / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, T::STAGE_BYTES);
          const int tap = it / slabs;
          const int c0 = (it - tap * slabs) * BK;
          const uint32_t st = ring + s * T::STAGE_BYTES;
          tma_load_4d(st, &xmap, full, c0, at.x0 + tap % 3 - 1,
                      at.y0 + tap / 3 - 1, at.b);
          tma_load_3d(st + A_BYTES, &whimap, full, c0, tap, at.n0);
          tma_load_3d(st + A_BYTES + T::B_BYTES, &wlomap, full, c0, tap,
                      at.n0);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows wg*64 .. wg*64+63 of each tile:
  // the running sum acc and one k-iteration's partial p.
  regs_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  float acc[ACC], p[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) p[i] = 0.f;
  uint32_t g = 0;                                // ring position
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt at = tile_at(t, tiles_m, tiles_x, tiles_y, bw_log2, BN);
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_iter; ++it, ++g) {
      const int s = g % STAGES;
      mbar_wait(full0 + 8 * s, (g / STAGES) & 1);
      const uint32_t st = ring + s * T::STAGE_BYTES;
      k_iteration<BN>(p, st, ring_ptr + s * T::STAGE_BYTES, wg);
      // The group has read the stage: free it, then fold the partial in.
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += p[i];
    }
    if constexpr (EPI == POOL) {
      pool_epilogue<BN>(acc, ring_ptr + STAGES * T::STAGE_BYTES, bias, y, idx,
                        at.b, at.x0, at.y0, at.n0, H, W, Cout, bw_log2);
    } else {
      store_epilogue<BN>(acc, bias, y, at.b, at.x0, at.y0, at.n0, H, W, Cout,
                         bw_log2, relu);
    }
  }
}

template <int BN, int EPI>
int launch(const CUtensorMap& xmap, const CUtensorMap& whimap,
           const CUtensorMap& wlomap, const void* b, void* y, void* idx, int B,
           int H, int W, int Cin, int Cout, int bw_log2, int relu,
           cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      conv3x3_tf32x3_kernel<BN, EPI>,
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
  conv3x3_tf32x3_kernel<BN, EPI>
      <<<tiles < sms ? tiles : sms, THREADS, Tile<BN, EPI>::SMEM, stream>>>(
          xmap, whimap, wlomap, (const float*)b, (float*)y, (uint8_t*)idx, H,
          W, Cin, Cout, bw_log2, tiles_x, tiles_y, tiles_m, relu);
  return (int)cudaGetLastError();
}

// Encodes the tensor maps of x and of the two weight parts and launches
// with BN = 64 for Cout <= 64, else 128.
template <int EPI>
int encode_and_launch(const void* x, const void* w_hi, const void* w_lo,
                      const void* b, void* y, void* idx, int B, int H, int W,
                      int Cin, int Cout, int bw_log2, int relu, void* stream) {
  const int bw = 1 << bw_log2;
  const cuuint64_t e = 4;                        // bytes per f32
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, whimap, wlomap;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t xstride[3] = {Cin * e, (cuuint64_t)W * Cin * e,
                                 (cuuint64_t)H * W * Cin * e};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)bw, (cuuint32_t)(BM / bw), 1};
  CUresult r = cuTensorMapEncodeTiled(
      &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), xdim,
      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  const int bn = Cout <= 64 ? 64 : 128;
  r = encode_weights(&whimap, w_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, e, Cin,
                     Cout, BK, bn);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_weights(&wlomap, w_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, e, Cin,
                     Cout, BK, bn);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 64 ? launch<64, EPI>(xmap, whimap, wlomap, b, y, idx, B, H, W,
                                    Cin, Cout, bw_log2, relu, st)
                  : launch<128, EPI>(xmap, whimap, wlomap, b, y, idx, B, H, W,
                                     Cin, Cout, bw_log2, relu, st);
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// x (B, H, W, Cin) f32; w_hi, w_lo (Cout, 3, 3, Cin) f32, the exact split of
// the HWIO weights permuted so that K is innermost (w_hi with its low 13
// mantissa bits clear); b (Cout,) f32; y (B, H, W, Cout) f32. Cin and Cout
// multiples of 4, x and the weights 16-byte aligned; bw the tile's width in
// pixels (a power of two, at most 128; the tile is bw x 128/bw pixels).
// Returns a cudaError_t, or ENCODE_ERROR + the CUresult of a tensor-map
// encoding.
extern "C" int st3d_conv3x3_tf32x3_f32(const void* x, const void* w_hi,
                                       const void* w_lo, const void* b,
                                       void* y, int B, int H, int W, int Cin,
                                       int Cout, int bw, int relu,
                                       void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 0 || bw > BM || Cin % 4 || Cout % 4)
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<STORE>(x, w_hi, w_lo, b, y, nullptr, B, H, W, Cin,
                                  Cout, bw_log2, relu, stream);
}

// C in float32: maxpool2x2(relu(conv3x3_same(x, w) + b)) with the window
// index. x, w_hi, w_lo and b as above; pooled (B, H/2, W/2, Cout) f32 and idx
// (B, H/2, W/2, Cout) uint8; H and W even; bw the tile's width (a power of
// two, 2 to 64: kernels/conv.py::pool_tile). Returns as above.
extern "C" int st3d_conv3x3_relu_pool_tf32x3_f32(const void* x,
                                                 const void* w_hi,
                                                 const void* w_lo,
                                                 const void* b, void* pooled,
                                                 void* idx, int B, int H,
                                                 int W, int Cin, int Cout,
                                                 int bw, void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 1 || bw > 64 || H % 2 || W % 2 || Cin % 4 || Cout % 4)
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<POOL>(x, w_hi, w_lo, b, pooled, idx, B, H, W, Cin,
                                 Cout, bw_log2, 1, stream);
}
