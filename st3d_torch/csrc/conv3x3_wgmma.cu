// 3x3 SAME stride-1 convolution + bias (+ ReLU) on Hopper's tensor cores:
// bf16 NHWC activations, weights laid out (Cout, 9, Cin) by the wrapper,
// float32 accumulation, one rounding into bf16. The same mainloop with a
// second epilogue is C, conv + bias + ReLU + 2x2 max-pool with the window
// index (below).
//
// Replaces the TPU kernels st3d/kernels/conv_pallas.py::_conv_kernel,
// _conv_kernel_nopad and _conv_kernel_halo1 (entry _conv3x3_same_impl) for
// bf16 with Cin and Cout multiples of 8; csrc/conv3x3_tf32x3.cu takes
// float32 and csrc/conv3x3_nhwc.cu (CUDA cores) the other widths
// (kernels/conv.py::conv_route).
// With the pool epilogue it replaces, for bf16 with Cin and Cout multiples
// of 8 (kernels/conv.py::relu_pool_route), the TPU kernels
// st3d/kernels/stage1_pallas.py::_conv1_2_kernel (entry
// conv1_2_packed_pool, K4b; the same body as stage1v3_pallas.py's
// _c12_fwd_kernel, K10c), conv_pallas.py::_conv2x2_fwd_kernel (entry
// conv3x3_bias_relu_pool_packed, K5) and conv_pallas.py's
// conv3x3_bias_relu_pool with pool=True (K8); csrc/conv3x3_tf32x3.cu's pool
// epilogue takes float32 and csrc/conv3x3_relu_pool.cu (CUDA cores) the
// other widths.
//
// Work layout: an implicit GEMM with M = B*H*W output pixels, N = Cout,
// K = 9*Cin, walked tap by tap (dy, dx) and, inside a tap, in 64-channel
// slabs (64 bf16 = one 128-byte swizzle row). A block owns one tile of 128
// output pixels x BN output channels (BN = 64 or 128):
//   - the 128 pixels are a BW x BH box of one image (BW*BH = 128, BW a
//     power of two, kernels/conv.py::conv_tile; pool_tile for the pool);
//   - x is described to TMA as the 4-D tensor (C, W, H, B), innermost
//     first. The A tile of tap (dy, dx) is the box (64, BW, BH, 1) at
//     (c0, x0 + dx, y0 + dy, b); TMA zero-fills the coordinates that fall
//     outside the tensor (-1, W, H, channels past Cin), which is exactly the
//     SAME padding, so no padded copy and no bounds test exist. The box lands
//     as a [128 x 64] K-major tile with the 128-byte swizzle, wgmma's A;
//   - the B tile is the box (64, 1, BN) of the (Cin, 9, Cout) weights, a
//     [BN x 64] K-major tile;
//   - a ring of STAGES such (A, B) pairs is kept full by one producer warp
//     (one thread issues cp.async.bulk.tensor onto the stage's "full"
//     mbarrier); two consumer warpgroups each run wgmma m64nBNk16 on their
//     64-row half, keep one wgmma group in flight, and free a stage on its
//     "empty" mbarrier once the group that read it has completed;
//   - epilogue (STORE): accumulators + bias, optional ReLU, one rounding
//     into bf16, stored straight from registers; pixels of the box outside
//     the image are not stored.
//   - epilogue (POOL): the tile holds whole 2x2 windows (pool_tile: BW <=
//     64, so both sides are even; tile origins and H, W are even, so no
//     window straddles a tile or the image edge). The two rows of a window
//     lie 4 lanes apart in the accumulators, and at 64 x 2 in the two
//     warpgroups, so the pool goes through shared memory: bias, ReLU and
//     the bf16 rounding in registers; the rounded 128 x BN tile into the
//     drained ring (rows padded by 16 bytes, so a warp's stores hit 32
//     banks); a 256-thread named barrier; then each thread pools whole
//     windows, 8 channels at a time, with conv_pallas.py::_pool4_first_max's
//     rule on the rounded values (w01 = c1 > c0, w23 = c3 > c2, idx = m23 >
//     m01 ? 2 + w23 : w01) and stores pooled (16 bytes) and idx (8 bytes)
//     along the channels. Only pooled and idx reach device memory.
//
// What bounds it on an H100: operations. Every VGG conv does 2*9*Cin*Cout
// flops per pixel against 2*(Cin + Cout) bytes, far above the 295 flops per
// byte of the bf16 roofline; the bf16 tensor cores (989 TFLOP/s) are the
// ceiling. A 128 x BN tile reuses each staged A value BN times and each B
// value 128 times, so the 64-channel slab stays a small L2 stream. The
// pool writes 3/8 of the bytes the plain epilogue would. Persistent
// scheduling, clusters and the register split are later work.
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
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;    // + one producer warp
constexpr int A_BYTES = BM * BK * 2;

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // + 1024: the ring is aligned to 1024 bytes inside the dynamic buffer,
  // as the 128-byte swizzle pattern repeats every 8 rows of 128 bytes.
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

enum Epilogue { STORE = 0, POOL = 1 };

// bf16 number k (0-7) of the 16 bytes q, as a float (exact).
__device__ __forceinline__ float bf16_at(const uint4& q, int k) {
  const uint32_t w = k < 2 ? q.x : k < 4 ? q.y : k < 6 ? q.z : q.w;
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// C's epilogue: relu(acc + bias) rounded to bf16, staged in the drained
// ring, pooled 2x2 by whole windows. pooled and idx are (B, H/2, W/2,
// Cout); the tile's rows are (r >> bw_log2, r & (bw - 1)) from (y0, x0).
template <int BN>
__device__ __forceinline__ void pool_epilogue(
    const float (&acc)[BN / 2], uint8_t* stage,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ pooled,
    uint8_t* __restrict__ idx, int b, int x0, int y0, int n0, int H, int W,
    int Cout, int bw_log2) {
  constexpr int ROW = 2 * BN + 16;               // bytes per staged row
  constexpr int CHUNKS = BN / 8;                 // 8-channel runs per pixel
  static_assert(BM * ROW <= STAGES * Tile<BN>::STAGE_BYTES,
                "the staged tile fits in the ring");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // Both warpgroups' last wgmma have read the ring.
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

// One 128 x BN output tile. Threads 0-255: the two consumer warpgroups;
// threads 256-287: the producer warp. EPI = POOL: y is pooled, idx the
// window index, relu is implied.
template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(__grid_constant__ const CUtensorMap xmap,
                     __grid_constant__ const CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y,
                     uint8_t* __restrict__ idx, int H, int W, int Cin,
                     int Cout, int bw_log2, int tiles_x, int tiles_y,
                     int relu) {
  constexpr int ACC = BN / 2;                    // f32 accumulators a thread
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[STAGES]);

  const int bw = 1 << bw_log2;
  const int bh = BM >> bw_log2;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const int x0 = tx * bw, y0 = ty * bh;
  const int n0 = blockIdx.y * BN;
  const int slabs = (Cin + BK - 1) / BK;
  const int n_iter = 9 * slabs;

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
    // Producer: keep the ring full.
    if (threadIdx.x == CONSUMERS * 128) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const uint32_t round = it / STAGES;
        mbar_wait(empty0 + 8 * s, (round & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, Tile<BN>::STAGE_BYTES);
        const int tap = it / slabs;
        const int c0 = (it - tap * slabs) * BK;
        const uint32_t a_dst = ring + s * Tile<BN>::STAGE_BYTES;
        tma_load_4d(a_dst, &xmap, full, c0, x0 + tap % 3 - 1,
                    y0 + tap / 3 - 1, b);
        tma_load_3d(a_dst + A_BYTES, &wmap, full, c0, tap, n0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows wg*64 .. wg*64+63 of the tile.
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
      // One k16 step is 32 bytes along the swizzled 128-byte row; the
      // leading offset of a K-major tile is unused (16).
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
    // The previous iteration's group has completed: free its stage.
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  if constexpr (EPI == POOL) {
    pool_epilogue<BN>(acc, smem_raw + (ring - smem_u32(smem_raw)), bias, y,
                      idx, b, x0, y0, n0, H, W, Cout, bw_log2);
    return;
  }
  // Epilogue. Accumulator v of thread (warp w, lane l) of the warpgroup:
  // row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1).
  const int warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    if (n >= Cout) continue;
    const float b0 = __bfloat162float(bias[n]);
    const float b1 = __bfloat162float(bias[n + 1]);
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
      *reinterpret_cast<__nv_bfloat162*>(y + pix * Cout + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int BN, int EPI>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const void* b,
           void* y, void* idx, int B, int H, int W, int Cin, int Cout,
           int bw_log2, int relu, cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err) return err;
  const int bw = 1 << bw_log2, bh = BM >> bw_log2;
  const int tiles_x = (W + bw - 1) / bw, tiles_y = (H + bh - 1) / bh;
  dim3 grid((unsigned)(B * tiles_x * tiles_y), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_wgmma_kernel<BN, EPI><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      xmap, wmap, (const __nv_bfloat16*)b, (__nv_bfloat16*)y, (uint8_t*)idx,
      H, W, Cin, Cout, bw_log2, tiles_x, tiles_y, relu);
  return (int)cudaGetLastError();
}

// Encodes x's and wk's tensor maps and launches with BN = 64 for Cout <= 64,
// else 128.
template <int EPI>
int encode_and_launch(const void* x, const void* wk, const void* b, void* y,
                      void* idx, int B, int H, int W, int Cin, int Cout,
                      int bw_log2, int relu, void* stream) {
  const int bw = 1 << bw_log2;
  const cuuint64_t e = 2;                        // bytes per bf16
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t xstride[3] = {Cin * e, (cuuint64_t)W * Cin * e,
                                 (cuuint64_t)H * W * Cin * e};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)bw, (cuuint32_t)(BM / bw), 1};
  CUresult r = cuTensorMapEncodeTiled(
      &xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim,
      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  const int bn = Cout <= 64 ? 64 : 128;
  r = encode_weights(&wmap, wk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, e, Cin, Cout,
                     BK, bn);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 64 ? launch<64, EPI>(xmap, wmap, b, y, idx, B, H, W, Cin, Cout,
                                    bw_log2, relu, st)
                  : launch<128, EPI>(xmap, wmap, b, y, idx, B, H, W, Cin,
                                     Cout, bw_log2, relu, st);
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
// (a power of two, at most 128; the tile is bw x 128/bw pixels). Returns a
// cudaError_t, or ENCODE_ERROR + the CUresult of a tensor-map encoding.
extern "C" int st3d_conv3x3_wgmma_bf16(const void* x, const void* wk,
                                       const void* b, void* y, int B, int H,
                                       int W, int Cin, int Cout, int bw,
                                       int relu, void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 0 || bw > BM || Cin % 8 || Cout % 8)
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<STORE>(x, wk, b, y, nullptr, B, H, W, Cin, Cout,
                                  bw_log2, relu, stream);
}

// C: maxpool2x2(relu(conv3x3_same(x, wk) + b)) with the window index. x, wk
// and b as above; pooled (B, H/2, W/2, Cout) bf16 and idx (B, H/2, W/2,
// Cout) uint8, 16-byte aligned; H and W even; bw the tile's width (a power
// of two, 2 to 64: kernels/conv.py::pool_tile). Returns as above.
extern "C" int st3d_conv3x3_relu_pool_wgmma_bf16(const void* x, const void* wk,
                                                 const void* b, void* pooled,
                                                 void* idx, int B, int H,
                                                 int W, int Cin, int Cout,
                                                 int bw, void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 1 || bw > 64 || H % 2 || W % 2 || Cin % 8 || Cout % 8)
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<POOL>(x, wk, b, pooled, idx, B, H, W, Cin, Cout,
                                 bw_log2, 1, stream);
}
