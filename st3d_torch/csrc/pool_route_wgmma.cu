// Input gradient of maxpool2x2(relu(conv3x3_same(z) + b)) on Hopper's tensor
// cores, bf16: dz = transpose-conv3x3(route(ct * [pooled > 0], idx), W).
// route() puts each pooled cotangent at the window position idx names and
// zeros the other three; a window whose max is 0 passes nothing back. ct,
// pooled and idx are (B, H/2, W/2, C); the weights arrive flipped and
// IO-transposed, laid out (Cout, 9, C) with K innermost; dz is (B, H, W,
// Cout) bf16, f32 accumulation, one rounding.
//
// Replaces the TPU kernels st3d/kernels/stage1_pallas.py::_conv1_2_bwd_kernel
// (entry conv1_2_bwd_dz5, K4d; the same body as stage1v3_pallas.py's
// _c12_bwd_kernel, K10d) and conv_pallas.py::_conv2x2_bwd_kernel (entry
// _prp_bwd, K5's backward; K8's backward _brp through
// kernels/conv.py::conv3x3_bias_relu_pool), for bf16 with C a multiple of
// 16 and Cout a multiple of 8 (kernels/conv.py::pool_route);
// csrc/pool_route_tf32x3.cu takes float32.
//
// Work layout: csrc/conv3x3_wgmma.cu's implicit GEMM (M = B*H*W pixels of
// dz, N = Cout, K = 9*C), walked slab by slab (64 channels, one 128-byte
// swizzle row), tap by tap inside a slab. A block owns a BW x BH box of 128
// full-resolution pixels (kernels/conv.py::conv_tile) and BN = 64 or 128
// output channels. The A tile of a tap is the routed cotangent, which no
// TMA box holds, so:
//   - per slab, one thread TMA-loads the block's pooled footprint: ct,
//     pooled and idx over the tile plus a one-pixel full-resolution halo,
//     the pooled box (64, PW, PH) at ((x0 - 1) >> 1, (y0 - 1) >> 1)
//     (kernels/conv.py::pool_footprint; TMA's zero fill covers the image
//     edge and the channels past C). The footprint is double-buffered, so
//     the next slab's load overlaps this slab's taps;
//   - two producer warpgroups mask ct by pooled > 0 in place once per
//     slab, then build each tap's 128 x 64 A tile from shared memory into
//     the ring with the 128-byte swizzle (row r's 16-byte chunk j goes to
//     chunk j ^ (r % 8)), each thread four 8-channel chunks, the index test
//     by byte-wise SIMD compares; each thread fences its writes for the
//     async proxy and arrives on the stage's "full" mbarrier; the first
//     producer thread also TMA-loads the stage's weight tile (64, 1, BN)
//     onto the same barrier;
//   - the two consumer warpgroups are K2's: wgmma m64nBNk16 on their 64-row
//     halves, one group in flight, the stage freed on its "empty" mbarrier.
// Each pooled value is read from device memory once per slab and block,
// where the CUDA-core kernel it replaced made three global loads per staged
// value, nine times over; the routed full-resolution tensor never exists
// in device memory.
//
// What bounds it on an H100: operations on the bf16 tensor cores (2 * 9 *
// C * Cout flops per dz pixel, against 2 * Cout + 5 / 4 * C bytes). Inside
// the block the producers' build is the cost: per tap it reads 24 bytes
// and writes 16 bytes of shared memory for each 8 staged values. With one
// producer warpgroup and a per-byte index test the kernel took 2.1x K2's
// dx at conv1_2's shape and 1.7-1.9x at K8's (H100); hence the second
// warpgroup and the SIMD test.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                          // dz pixels per tile
constexpr int BK = 64;                           // routed channels per slab
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int PRODUCERS = 2;                     // warpgroups building A
constexpr int P_THREADS = PRODUCERS * 128;
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int A_BYTES = BM * BK * 2;
// Pooled footprint of a tile: at most (128/2 + 2) x 2 = 132 pooled pixels
// (the 128 x 1 box); per pixel 64 ct and 64 pooled bf16 values and 64 idx
// bytes, each part 128-byte aligned, the buffer 1024-byte aligned.
constexpr int FP_PIXELS = 132;
constexpr int FP_CT = 0;
constexpr int FP_POOLED = FP_PIXELS * 128;
constexpr int FP_IDX = 2 * FP_PIXELS * 128;
constexpr int FP_BYTES = ((2 * FP_PIXELS * 128 + FP_PIXELS * 64) + 1023) & ~1023;
constexpr int PRODUCER_BAR = 1;                  // named barrier id

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // + 1024: alignment of the ring inside the dynamic buffer.
  static constexpr int SMEM = RING_BYTES + 2 * FP_BYTES + 1024;
};

__device__ __forceinline__ bool positive(uint32_t half_bits) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)half_bits)) >
         0.f;
}

// Threads 0-255: the consumer warpgroups; 256-511: the producer warpgroups.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
pool_route_wgmma_kernel(__grid_constant__ const CUtensorMap ctmap,
                        __grid_constant__ const CUtensorMap pmap,
                        __grid_constant__ const CUtensorMap imap,
                        __grid_constant__ const CUtensorMap wmap,
                        __nv_bfloat16* __restrict__ dz, int H, int W, int C,
                        int Cout, int bw_log2, int tiles_x, int tiles_y,
                        int pw, int ph) {
  constexpr int ACC = BN / 2;
  // full and empty per stage, then one per footprint buffer.
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 2];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t ring = base;
  const uint32_t fp0 = base + Tile<BN>::RING_BYTES;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[STAGES]);
  const uint32_t fpbar0 = smem_u32(&bars[2 * STAGES]);

  const int bw = 1 << bw_log2;
  const int bh = BM >> bw_log2;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const int x0 = tx * bw, y0 = ty * bh;
  const int px0 = (x0 - 1) >> 1, py0 = (y0 - 1) >> 1;
  const int n0 = blockIdx.y * BN;
  const int slabs = (C + BK - 1) / BK;
  const int n_iter = 9 * slabs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // The producer threads' arrivals after their A writes, plus the
      // weight load's arrive.expect_tx.
      mbar_init(full0 + 8 * s, P_THREADS + 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);  // lane 0 of each warp
    }
    mbar_init(fpbar0, 1);
    mbar_init(fpbar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg >= CONSUMERS) {
    // Producer warpgroups.
    const int p = threadIdx.x - CONSUMERS * 128;
    const uint32_t fp_bytes = (uint32_t)(pw * ph) * (128 + 128 + 64);
    if (p == 0) {
      mbar_expect_tx(fpbar0, fp_bytes);
      tma_load_4d(fp0 + FP_CT, &ctmap, fpbar0, 0, px0, py0, b);
      tma_load_4d(fp0 + FP_POOLED, &pmap, fpbar0, 0, px0, py0, b);
      tma_load_4d(fp0 + FP_IDX, &imap, fpbar0, 0, px0, py0, b);
    }
    // Thread p stages chunk j = p % 8 of rows r = p / 8 + 32 * i.
    const int j = p & 7;
    for (int slab = 0; slab < slabs; ++slab) {
      const int buf = slab & 1;
      uint8_t* const fp_ptr = base_ptr + Tile<BN>::RING_BYTES + buf * FP_BYTES;
      if (p == 0 && slab + 1 < slabs) {
        // The other buffer was released by the barrier that ended the
        // previous slab.
        const uint32_t nfp = fp0 + (buf ^ 1) * FP_BYTES;
        const uint32_t nbar = fpbar0 + 8 * (buf ^ 1);
        const int c0 = (slab + 1) * BK;
        mbar_expect_tx(nbar, fp_bytes);
        tma_load_4d(nfp + FP_CT, &ctmap, nbar, c0, px0, py0, b);
        tma_load_4d(nfp + FP_POOLED, &pmap, nbar, c0, px0, py0, b);
        tma_load_4d(nfp + FP_IDX, &imap, nbar, c0, px0, py0, b);
      }
      mbar_wait(fpbar0 + 8 * buf, (slab >> 1) & 1);
      // ct <- ct * [pooled > 0], in place, 8 channels at a time.
      for (int k = p; k < pw * ph * 8; k += P_THREADS) {
        uint4 c = *reinterpret_cast<const uint4*>(fp_ptr + FP_CT + 16 * k);
        const uint4 q = *reinterpret_cast<const uint4*>(fp_ptr + FP_POOLED +
                                                        16 * k);
        uint32_t* cw = reinterpret_cast<uint32_t*>(&c);
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(&q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t keep = (positive(qw[e] & 0xffffu) ? 0xffffu : 0u) |
                                (positive(qw[e] >> 16) ? 0xffff0000u : 0u);
          cw[e] &= keep;
        }
        *reinterpret_cast<uint4*>(fp_ptr + FP_CT + 16 * k) = c;
      }
      named_barrier(PRODUCER_BAR, P_THREADS);
      for (int tap = 0; tap < 9; ++tap) {
        const int it = slab * 9 + tap;
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = ring + s * Tile<BN>::STAGE_BYTES;
        if (p == 0) {
          mbar_expect_tx(full, Tile<BN>::B_BYTES);
          tma_load_3d(st + A_BYTES, &wmap, full, slab * BK, tap, n0);
        }
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        uint8_t* const a_ptr = base_ptr + s * Tile<BN>::STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (p >> 3) + 32 * i;
          const int xx = x0 + (r & (bw - 1)) + dx;
          const int yy = y0 + (r >> bw_log2) + dy;
          const int cell = ((yy >> 1) - py0) * pw + ((xx >> 1) - px0);
          // The window position of (yy, xx) in every byte.
          const uint32_t q4 = (uint32_t)(((yy & 1) << 1) | (xx & 1)) *
                              0x01010101u;
          uint4 c = *reinterpret_cast<const uint4*>(fp_ptr + FP_CT +
                                                    cell * 128 + j * 16);
          const uint2 id = *reinterpret_cast<const uint2*>(
              fp_ptr + FP_IDX + cell * 64 + j * 8);
          // 0xff in each byte whose index names this position, spread to
          // the 16-bit lanes of channels (0, 1), (2, 3) of each word.
          const uint32_t m0 = __vcmpeq4(id.x, q4), m1 = __vcmpeq4(id.y, q4);
          c.x &= __byte_perm(m0, 0, 0x1100);
          c.y &= __byte_perm(m0, 0, 0x3322);
          c.z &= __byte_perm(m1, 0, 0x1100);
          c.w &= __byte_perm(m1, 0, 0x3322);
          *reinterpret_cast<uint4*>(a_ptr + r * 128 + ((j ^ (r & 7)) << 4)) = c;
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
      // Every read of this footprint buffer is done before it is reloaded
      // (two slabs on), and the masked writes are ordered before that load.
      fence_proxy_async();
      named_barrier(PRODUCER_BAR, P_THREADS);
    }
    return;
  }

  // Consumers: K2's mainloop.
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t a = ring + s * Tile<BN>::STAGE_BYTES + wg * 64 * 128;
    const uint32_t bb = ring + s * Tile<BN>::STAGE_BYTES + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_sw128(a + kk * 32, 16);
      const uint64_t db = desc_sw128(bb + kk * 32, 16);
      if constexpr (BN == 128) {
        wgmma_m64n128k16<0, 0>(acc, da, db);
      } else {
        wgmma_m64n64k16<0, 0>(acc, da, db);
      }
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue: one rounding into bf16, stored from registers; pixels of the
  // box outside the image are not stored.
  const int warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int n = n0 + 8 * jn + 2 * (lane & 3);
    if (n >= Cout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + 16 * warp + 8 * h + (lane >> 2);
      const int yy = y0 + (r >> bw_log2);
      const int xx = x0 + (r & (bw - 1));
      if (yy >= H || xx >= W) continue;
      const long long pix = ((long long)b * H + yy) * W + xx;
      *reinterpret_cast<__nv_bfloat162*>(dz + pix * Cout + n) =
          __floats2bfloat162_rn(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
  }
}

template <int BN>
int launch(const CUtensorMap* maps, void* dz, int B, int H, int W, int C,
           int Cout, int bw_log2, int pw, int ph, cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      pool_route_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err) return err;
  const int bw = 1 << bw_log2, bh = BM >> bw_log2;
  const int tiles_x = (W + bw - 1) / bw, tiles_y = (H + bh - 1) / bh;
  dim3 grid((unsigned)(B * tiles_x * tiles_y), (unsigned)((Cout + BN - 1) / BN));
  pool_route_wgmma_kernel<BN><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (__nv_bfloat16*)dz, H, W, C, Cout,
      bw_log2, tiles_x, tiles_y, pw, ph);
  return (int)cudaGetLastError();
}

}  // namespace

// ct, pooled (B, H/2, W/2, C) bf16, idx (B, H/2, W/2, C) uint8, wk (Cout, 3,
// 3, C) bf16 (the flipped, IO-transposed HWIO weights permuted so that K is
// innermost), dz (B, H, W, Cout) bf16. H and W even, C a multiple of 16,
// Cout a multiple of 8, operands 16-byte aligned; bw the tile's width in
// pixels (a power of two, 2 to 128), (pw, ph) its pooled footprint
// (kernels/conv.py::pool_footprint). Returns a cudaError_t, or
// ENCODE_ERROR + the CUresult of a tensor-map encoding.
extern "C" int st3d_pool_route_wgmma_bf16(const void* ct, const void* pooled,
                                          const void* idx, const void* wk,
                                          void* dz, int B, int H, int W,
                                          int C, int Cout, int bw, int pw,
                                          int ph, void* stream) {
  int bw_log2 = 0;
  while ((1 << bw_log2) < bw) ++bw_log2;
  if ((1 << bw_log2) != bw || bw < 2 || bw > BM || H % 2 || W % 2 ||
      C % 16 || Cout % 8 || pw * ph > FP_PIXELS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const int Hp = H / 2, Wp = W / 2;
  CUresult r = encode_pooled(&maps[0], ct, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             2, B, Hp, Wp, C, BK, pw, ph);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_pooled(&maps[1], pooled, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B,
                    Hp, Wp, C, BK, pw, ph);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_pooled(&maps[2], idx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, Hp,
                    Wp, C, BK, pw, ph);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  const int bn = Cout <= 64 ? 64 : 128;
  r = encode_weights(&maps[3], wk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C,
                     Cout, BK, bn);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 64 ? launch<64>(maps, dz, B, H, W, C, Cout, bw_log2, pw, ph, st)
                  : launch<128>(maps, dz, B, H, W, C, Cout, bw_log2, pw, ph,
                                st);
}
