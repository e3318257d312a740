// Input gradient of maxpool2x2(relu(conv3x3_same(z) + b)) in float32 on
// Hopper's tensor cores, by the 3xTF32 split:
// dz = transpose-conv3x3(route(ct * [pooled > 0], idx), W). route() puts
// each pooled cotangent at the window position idx names and zeros the
// other three; a window whose max is 0 passes nothing back. ct, pooled and
// idx are (B, H/2, W/2, C); the weights arrive flipped, IO-transposed,
// laid out (Cout, 9, C) with K innermost and split into hi and lo parts by
// the wrapper (kernels/conv.py::split_tf32); dz is (B, H, W, Cout) f32.
//
// Replaces the TPU kernels st3d/kernels/stage1_pallas.py::_conv1_2_bwd_kernel
// (entry conv1_2_bwd_dz5, K4d; the same body as stage1v3_pallas.py's
// _c12_bwd_kernel, K10d) and conv_pallas.py::_conv2x2_bwd_kernel (entry
// _prp_bwd, K5's backward; K8's backward _brp through
// kernels/conv.py::conv3x3_bias_relu_pool), for float32 with C a multiple
// of 16 (the uint8 index rows are C bytes apart, and TMA strides are
// multiples of 16 bytes) and Cout a multiple of 4 (kernels/conv.py::
// pool_route).
//
// Numerics: csrc/conv3x3_tf32x3.cu's. Each factor is split exactly, x =
// x_hi + x_lo, x_hi with its low 13 mantissa bits cleared, and
//   a * b ~= a_hi * b_hi + a_hi * b_lo + a_lo * b_hi,
// three TF32 products; each k-iteration's products sum into a fresh
// partial that the CUDA cores fold into the running sum, because the
// tensor core's own f32 sum over a whole K drifted to 1.7e-5 of the
// largest output (conv3x3_tf32x3.cu's note).
//
// Work layout: csrc/pool_route_wgmma.cu's, with 32-channel slabs (32 f32 =
// one 128-byte swizzle row). A block owns a BW x BH box of 128
// full-resolution pixels (kernels/conv.py::conv_tile) and BN = 64 output
// channels:
//   - per slab, one thread TMA-loads the block's pooled footprint: ct and
//     pooled (f32) and idx (uint8, a 32-byte inner box) over the tile plus
//     a one-pixel full-resolution halo, the pooled box (32, PW, PH) at
//     ((x0 - 1) >> 1, (y0 - 1) >> 1) (kernels/conv.py::pool_footprint; TMA's
//     zero fill covers the image edge and the channels past C). The
//     footprint is double-buffered;
//   - two producer warpgroups mask ct by pooled > 0 and split it, once per
//     slab, in place: hi over ct, lo over pooled (the mask no longer needs
//     it). Routing selects whole values, and the split of a selected value
//     is the value's split, so the per-tap build only copies: for each tap
//     the producers write the routed hi into A and lo into A_lo at the same
//     swizzled offsets (row r's 16-byte chunk j goes to chunk j ^ (r % 8)),
//     the index test by byte-wise SIMD compares, fence their writes for the
//     async proxy and arrive on the stage's "full" mbarrier; the first
//     producer thread also TMA-loads the stage's weight tiles (32, 1, BN),
//     hi and lo, onto the same barrier;
//   - the two consumer warpgroups are conv3x3_tf32x3.cu's without its
//     split: three wgmma m64n64k8 tf32 per k8 step into the partial, wait,
//     free the stage, fold.
// The routed full-resolution tensor never exists in device memory.
//
// Why BN = 64 with 3 stages, not BN = 128 with 2: the 512-thread block
// caps a thread at 128 registers, and BN = 128's accumulator and partial
// alone take 128; at BN = 64 they take 64. Shared memory: a stage holds
// A, A_lo, B_hi and B_lo (48 KB at BN = 64), the footprint buffer 38 KB
// (132 pooled pixels x (128 + 128 + 32) bytes), so 3 stages and two
// buffers take 221 KB of the 227 KB a block may have.
//
// What bounds it on an H100: operations on the TF32 tensor cores (3 * 2 *
// 9 * C * Cout flops per dz pixel at 495 TFLOP/s, against 9 / 4 * C + 4 *
// Cout bytes). Inside the block the producers' build costs, per tap and 4
// staged values, one 16-byte shared read of hi and of lo, a 4-byte index
// read and two 16-byte writes: twice bf16 D's bytes for a third of its
// tensor-core rate, so the consumers set the pace.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                          // dz pixels per tile
constexpr int BK = 32;                           // routed f32 channels a slab
constexpr int BN = 64;                           // dz channels per tile
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int PRODUCERS = 2;                     // warpgroups building A
constexpr int P_THREADS = PRODUCERS * 128;
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int A_BYTES = BM * BK * 4;             // 16 KB
constexpr int B_BYTES = BN * BK * 4;             // 8 KB
// A (hi), A_lo, B_hi, B_lo.
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
// Pooled footprint of a tile: at most (128/2 + 2) x 2 = 132 pooled pixels
// (the 128 x 1 box); per pixel 32 ct and 32 pooled f32 values and 32 idx
// bytes, each part 128-byte aligned, the buffer 1024-byte aligned. After
// the mask, FP_HI holds ct's hi part and FP_LO its lo part.
constexpr int FP_PIXELS = 132;
constexpr int FP_HI = 0;
constexpr int FP_LO = FP_PIXELS * 128;
constexpr int FP_IDX = 2 * FP_PIXELS * 128;
constexpr int FP_BYTES = ((2 * FP_PIXELS * 128 + FP_PIXELS * 32) + 1023) & ~1023;
// + 1024: alignment of the ring inside the dynamic buffer.
constexpr int SMEM = RING_BYTES + 2 * FP_BYTES + 1024;
static_assert(SMEM <= 232448, "a block's shared memory on an H100");
constexpr uint32_t HI_MASK = 0xffffe000u;        // sign, exponent, 10 bits
constexpr int PRODUCER_BAR = 1;                  // named barrier id

__device__ __forceinline__ float masked(float c, float q) {
  return q > 0.f ? c : 0.f;
}

__device__ __forceinline__ float hi_part(float v) {
  return __uint_as_float(__float_as_uint(v) & HI_MASK);
}

// Threads 0-255: the consumer warpgroups; 256-511: the producer warpgroups.
__global__ void __launch_bounds__(THREADS, 1)
pool_route_tf32x3_kernel(__grid_constant__ const CUtensorMap ctmap,
                         __grid_constant__ const CUtensorMap pmap,
                         __grid_constant__ const CUtensorMap imap,
                         __grid_constant__ const CUtensorMap whimap,
                         __grid_constant__ const CUtensorMap wlomap,
                         float* __restrict__ dz, int H, int W, int C,
                         int Cout, int bw_log2, int tiles_x, int tiles_y,
                         int pw, int ph) {
  constexpr int ACC = BN / 2;                    // f32 accumulators a thread
  // full and empty per stage, then one per footprint buffer.
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 2];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t ring = base;
  const uint32_t fp0 = base + RING_BYTES;
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
      // weight loads' arrive.expect_tx.
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
    const uint32_t fp_bytes = (uint32_t)(pw * ph) * (128 + 128 + 32);
    if (p == 0) {
      mbar_expect_tx(fpbar0, fp_bytes);
      tma_load_4d(fp0 + FP_HI, &ctmap, fpbar0, 0, px0, py0, b);
      tma_load_4d(fp0 + FP_LO, &pmap, fpbar0, 0, px0, py0, b);
      tma_load_4d(fp0 + FP_IDX, &imap, fpbar0, 0, px0, py0, b);
    }
    // Thread p stages chunk j = p % 8 (4 channels) of rows r = p / 8 + 32 * i.
    const int j = p & 7;
    for (int slab = 0; slab < slabs; ++slab) {
      const int buf = slab & 1;
      uint8_t* const fp_ptr = base_ptr + RING_BYTES + buf * FP_BYTES;
      if (p == 0 && slab + 1 < slabs) {
        // The other buffer was released by the barrier that ended the
        // previous slab.
        const uint32_t nfp = fp0 + (buf ^ 1) * FP_BYTES;
        const uint32_t nbar = fpbar0 + 8 * (buf ^ 1);
        const int c0 = (slab + 1) * BK;
        mbar_expect_tx(nbar, fp_bytes);
        tma_load_4d(nfp + FP_HI, &ctmap, nbar, c0, px0, py0, b);
        tma_load_4d(nfp + FP_LO, &pmap, nbar, c0, px0, py0, b);
        tma_load_4d(nfp + FP_IDX, &imap, nbar, c0, px0, py0, b);
      }
      mbar_wait(fpbar0 + 8 * buf, (slab >> 1) & 1);
      // ct * [pooled > 0], split: hi over ct, lo over pooled, 4 channels
      // at a time.
      for (int k = p; k < pw * ph * 8; k += P_THREADS) {
        float4 c = *reinterpret_cast<const float4*>(fp_ptr + FP_HI + 16 * k);
        const float4 q = *reinterpret_cast<const float4*>(fp_ptr + FP_LO +
                                                          16 * k);
        c.x = masked(c.x, q.x);
        c.y = masked(c.y, q.y);
        c.z = masked(c.z, q.z);
        c.w = masked(c.w, q.w);
        const float4 hi = make_float4(hi_part(c.x), hi_part(c.y),
                                      hi_part(c.z), hi_part(c.w));
        *reinterpret_cast<float4*>(fp_ptr + FP_HI + 16 * k) = hi;
        *reinterpret_cast<float4*>(fp_ptr + FP_LO + 16 * k) =
            make_float4(c.x - hi.x, c.y - hi.y, c.z - hi.z, c.w - hi.w);
      }
      named_barrier(PRODUCER_BAR, P_THREADS);
      for (int tap = 0; tap < 9; ++tap) {
        const int it = slab * 9 + tap;
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = ring + s * STAGE_BYTES;
        if (p == 0) {
          mbar_expect_tx(full, 2 * B_BYTES);
          tma_load_3d(st + 2 * A_BYTES, &whimap, full, slab * BK, tap, n0);
          tma_load_3d(st + 2 * A_BYTES + B_BYTES, &wlomap, full, slab * BK,
                      tap, n0);
        }
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        uint8_t* const a_ptr = base_ptr + s * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (p >> 3) + 32 * i;
          const int xx = x0 + (r & (bw - 1)) + dx;
          const int yy = y0 + (r >> bw_log2) + dy;
          const int cell = ((yy >> 1) - py0) * pw + ((xx >> 1) - px0);
          // The window position of (yy, xx) in every byte.
          const uint32_t q4 = (uint32_t)(((yy & 1) << 1) | (xx & 1)) *
                              0x01010101u;
          const uint32_t id = *reinterpret_cast<const uint32_t*>(
              fp_ptr + FP_IDX + cell * 32 + j * 4);
          // 0xff in each byte whose index names this position, spread to
          // the 32-bit word of its channel.
          const uint32_t m = __vcmpeq4(id, q4);
          const uint32_t m0 = __byte_perm(m, 0, 0x0000);
          const uint32_t m1 = __byte_perm(m, 0, 0x1111);
          const uint32_t m2 = __byte_perm(m, 0, 0x2222);
          const uint32_t m3 = __byte_perm(m, 0, 0x3333);
          uint4 h = *reinterpret_cast<const uint4*>(fp_ptr + FP_HI +
                                                    cell * 128 + j * 16);
          uint4 l = *reinterpret_cast<const uint4*>(fp_ptr + FP_LO +
                                                    cell * 128 + j * 16);
          h.x &= m0;
          h.y &= m1;
          h.z &= m2;
          h.w &= m3;
          l.x &= m0;
          l.y &= m1;
          l.z &= m2;
          l.w &= m3;
          const int off = r * 128 + ((j ^ (r & 7)) << 4);
          *reinterpret_cast<uint4*>(a_ptr + off) = h;
          *reinterpret_cast<uint4*>(a_ptr + A_BYTES + off) = l;
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
      // Every read of this footprint buffer is done before it is reloaded
      // (two slabs on), and the split's writes are ordered before that load.
      fence_proxy_async();
      named_barrier(PRODUCER_BAR, P_THREADS);
    }
    return;
  }

  // Consumers: the running sum acc and one k-iteration's partial part.
  float acc[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t st = ring + s * STAGE_BYTES;
    const uint32_t a_hi = st + wg * 64 * 128;
    const uint32_t a_lo = a_hi + A_BYTES;
    const uint32_t b_hi = st + 2 * A_BYTES;
    const uint32_t b_lo = b_hi + B_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // One k8 step is 32 bytes along the swizzled 128-byte row. The small
      // products go first.
      const uint64_t dah = desc_sw128(a_hi + kk * 32, 16);
      const uint64_t dal = desc_sw128(a_lo + kk * 32, 16);
      const uint64_t dbh = desc_sw128(b_hi + kk * 32, 16);
      const uint64_t dbl = desc_sw128(b_lo + kk * 32, 16);
      wgmma_m64n64k8_tf32(part, dal, dbh);
      wgmma_m64n64k8_tf32(part, dah, dbl);
      wgmma_m64n64k8_tf32(part, dah, dbh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    // The group has read the stage: free it, then fold the partial in.
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      acc[i] += part[i];
      part[i] = 0.f;
    }
  }

  // Epilogue: f32 stores from registers; pixels of the box outside the
  // image are not stored. Accumulator v of thread (warp w, lane l) of the
  // warpgroup: row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) +
  // 2*(l & 3) + (v & 1).
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
      *reinterpret_cast<float2*>(dz + pix * Cout + n) =
          make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
  }
}

}  // namespace

// ct, pooled (B, H/2, W/2, C) f32, idx (B, H/2, W/2, C) uint8; w_hi, w_lo
// (Cout, 3, 3, C) f32, the exact split of the flipped, IO-transposed HWIO
// weights permuted so that K is innermost; dz (B, H, W, Cout) f32. H and W
// even, C a multiple of 16, Cout a multiple of 4, operands 16-byte aligned;
// bw the tile's width in pixels (a power of two, 2 to 128), (pw, ph) its
// pooled footprint (kernels/conv.py::pool_footprint). Returns a
// cudaError_t, or ENCODE_ERROR + the CUresult of a tensor-map encoding.
extern "C" int st3d_pool_route_tf32x3_f32(const void* ct, const void* pooled,
                                          const void* idx, const void* w_hi,
                                          const void* w_lo, void* dz, int B,
                                          int H, int W, int C, int Cout,
                                          int bw, int pw, int ph,
                                          void* stream) {
  int bw_log2 = 0;
  while ((1 << bw_log2) < bw) ++bw_log2;
  if ((1 << bw_log2) != bw || bw < 2 || bw > BM || H % 2 || W % 2 ||
      C % 16 || Cout % 4 || pw * ph > FP_PIXELS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  const int Hp = H / 2, Wp = W / 2;
  CUresult r = encode_pooled(&maps[0], ct, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             4, B, Hp, Wp, C, BK, pw, ph);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_pooled(&maps[1], pooled, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B,
                    Hp, Wp, C, BK, pw, ph);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_pooled(&maps[2], idx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, Hp,
                    Wp, C, BK, pw, ph);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_weights(&maps[3], w_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, C,
                     Cout, BK, BN);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_weights(&maps[4], w_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, C,
                     Cout, BK, BN);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      pool_route_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err) return err;
  const int bh = BM >> bw_log2;
  const int tiles_x = (W + bw - 1) / bw, tiles_y = (H + bh - 1) / bh;
  dim3 grid((unsigned)(B * tiles_x * tiles_y), (unsigned)((Cout + BN - 1) / BN));
  pool_route_tf32x3_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], (float*)dz, H, W, C, Cout,
      bw_log2, tiles_x, tiles_y, pw, ph);
  return (int)cudaGetLastError();
}
