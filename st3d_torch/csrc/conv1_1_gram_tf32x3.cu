// VGG conv1_1 with the direct Gram of its pre-ReLU output on Hopper's
// tensor cores, float32 by the 3xTF32 split: one pass over the image x (B,
// H, W, 3) writes z = relu(y) (B, H, W, 64) in float32, where y =
// conv3x3_same(x, W) + b, and per image the float32 Gram g64 = y^T y (64,
// 64).
//
// Replaces the TPU kernel st3d/kernels/stage1v3_pallas.py::_c11_fwd_kernel
// (entry conv1_1_packed_v3, K10a) for float32 (kernels/stage1v3.py::
// v3_route); csrc/conv1_1_gram_wgmma.cu takes bf16. In float32 the TPU ran
// y and the Gram as float32
// dots and took y_r = y (stage1v3_pallas.py:264-275).
//
// Numerics: csrc/conv3x3_tf32x3.cu's. Every factor is split exactly, v =
// v_hi + v_lo (v_hi with its low 13 mantissa bits cleared), and a * b ~=
// a_hi b_hi + a_lo b_hi + a_hi b_lo.
//   - y: hopper.cuh's conv1_1_y_tf32x3, kernel A f32's z product (P' with
//     the ones column times W' with the bias as row 27, 12 wgmma m64n64k8
//     with the A fragments split in registers), which the backward kernel
//     (csrc/conv1_1_gram_bwd_tf32x3.cu) shares: its mask is z > 0 bit for
//     bit. A tile pixel past the image has a zero patch row, ones column
//     included, so its y is 0 and it adds nothing to the Gram.
//   - The Gram: the tf32 wgmma reads K-major shared operands only, and here
//     K is the pixels, so the tile's y goes transposed into shared memory,
//     split: Y^T hi and Y^T lo, 64 channel rows x 128 pixels each (four
//     k-blocks of 32 pixels, a 128-byte row). Both operands of y^T y are
//     K-major in that layout, so one tile serves as A and as B. Two
//     products, not three: warpgroup 0 runs HH = Yhi^T Yhi and warpgroup 1
//     LH = Ylo^T Yhi over the tile's 128 pixels (16 wgmma m64n64k8 each),
//     and g = HH + LH + LH^T (Yhi^T Ylo = LH^T). Each tile's product starts
//     from zero and is added to the warpgroup's running sum on the CUDA
//     cores (one accumulator over hundreds of tf32 products drifts to
//     ~1e-5: conv3x3_tf32x3.cu's note). A warpgroup then holds one fresh
//     and one running 64 x 64 sum.
//
// Work layout: kernel A f32's (csrc/conv1_1_stats_tf32x3.cu). Persistent
// blocks, blocksPerImage of them per image (kernels/stage1.py::
// c11_stats_blocks, one block an SM over the batch); block c of image b
// walks the image's 32 x 4 pixel tiles c, c + blocksPerImage, ... Per tile:
//   - the x halo (34 x 6 pixels x 3 channels) is loaded with coalesced
//     plain loads into registers while the previous tile's products run,
//     then stored to shared memory;
//   - each warpgroup computes y for its 64 pixels (tile pixel rows 2wg,
//     2wg + 1), writes Y^T hi and lo of them (k-blocks 2wg, 2wg + 1) and
//     relu(y) into one of two z staging buffers, with the 128-byte swizzle
//     as two (32, 32, 4, 1) boxes of z seen as (64, W, H, B), each written by
//     one TMA store that clips the pixels past the image; a buffer is
//     rewritten only after its store has read it (bulk_wait_read);
//   - after a barrier, each warpgroup's 16 Gram wgmma, one wait, the fold
//     into the running sum.
// At the end the block's partial is (HH + LH) + LH^T of its two running
// sums; a second pass (hopper.cuh's gram_reduce_upper) adds an image's
// partials in a fixed order. Nothing is added atomically: g64 is the same on
// every run.
//
// Shared memory (1024-byte aligned): Y^T hi and lo 2 x 32 KB, two z
// staging buffers 2 x 32 KB, W' hi and lo 2 x 8 KB, the halo 3 KB: 147 KB
// (+1 KB for the alignment), one block an SM
// (kernels/stage1.py::C11_TF32_STATS_BLOCKS_PER_SM). Registers: the
// running sum (32) and the fresh Gram (32) or y (32) with its A fragments
// (16 hi + 16 lo) a thread.
//
// What bounds it on an H100: writing z, 268 MB in float32 at 512^2 x 4
// views (80 us at 3.35 TB/s; 84 us with x); the products are 3 x 2 x
// 1.05 M pixels x 64 x (32 + 64) MACs with K padded to 32, ~26 GFLOP of
// TF32 work (52 us at 495 TFLOP/s) with the Gram's two products.
// The CUDA-core kernel it replaced ran y and the Gram on the fp32 cores
// (0.62 ms at that shape).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C = 64;                  // conv1_1's output channels
constexpr int TW = 32, TH = 4;         // tile: TW x TH pixels
constexpr int BM = TW * TH;            // 128 pixels
constexpr int HX = TW + 2, HY = TH + 2;
constexpr int THREADS = 256;           // two warpgroups, 64 tile pixels each
constexpr int KB_BYTES = C * 128;      // a k-block of Y^T: 64 rows x 32 px
constexpr int YT_BYTES = 4 * KB_BYTES; // Y^T of a tile, one part
constexpr int BOX_BYTES = BM * 128;    // a (32, 32, 4, 1) float32 z box
constexpr int W_BYTES = 64 * 128;      // W' (64 x 32, K-major), one part
constexpr int SUM_PITCH = C + 1;       // floats per row of the final sums
// One block to an SM: its shared memory (148 KB) leaves no room for two.
constexpr int BLOCKS_PER_SM = 1;

// Shared memory, 1024-byte aligned: Y^T hi and lo, two z staging buffers
// (two boxes each), W' hi and lo, the x halo.
constexpr int YT_OFF = 0;
constexpr int Z_OFF = 2 * YT_BYTES;
constexpr int W_OFF = Z_OFF + 4 * BOX_BYTES;
constexpr int X_OFF = W_OFF + 2 * W_BYTES;
constexpr int SMEM = X_OFF + 3072 + 1024;
static_assert(HX * HY * 3 * 4 <= 3072, "the x halo fits its slot");
static_assert(SMEM <= 232448, "a block's shared memory");
static_assert(2 * C * SUM_PITCH * 4 <= 2 * YT_BYTES,
              "the block's two 64 x 64 sums fit over Y^T");

using Halo = XWindow<HX, HY, THREADS, float>;

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
conv1_1_gram_tf32x3_kernel(__grid_constant__ const CUtensorMap zmap,
                           const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ partial, int H, int W) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  float* const halo = reinterpret_cast<float*>(base_ptr + X_OFF);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH);
  const float* xb = x + (long long)b * H * W * 3;

  // The first tile's first barrier orders these writes before the wgmma
  // that read them.
  load_conv1_1_wb_tf32x3<THREADS>(base_ptr + W_OFF, w, bias, tid);
  fence_proxy_async();

  float run[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = 0.f;
  // This thread's two y rows: tile pixels m0 and m0 + 8.
  const int m0 = wg * 64 + 16 * warp + g;
  const int ry0 = m0 / TW, rx0 = m0 % TW;
  const int ry1 = (m0 + 8) / TW, rx1 = (m0 + 8) % TW;
  Halo hv;
  int t = blk;
  if (t < tiles)
    hv.load(xb, H, W, (t % tiles_x) * TW - 1, (t / tiles_x) * TH - 1, tid);
  int s = 0;                               // this tile's z staging buffer
  for (; t < tiles; t += nblk, s ^= 1) {
    const int x0 = (t % tiles_x) * TW, y0 = (t / tiles_x) * TH;
    hv.store(halo, tid);
    // Staging buffer s was read out by the store two tiles ago.
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();
    const int tn = t + nblk;
    if (tn < tiles)
      hv.load(xb, H, W, (tn % tiles_x) * TW - 1, (tn / tiles_x) * TH - 1,
              tid);

    float acc[32];
    conv1_1_y_tf32x3<HX>(acc, halo, (ry0 * HX + rx0) * 3,
                         (ry1 * HX + rx1) * 3,
                         y0 + ry0 < H && x0 + rx0 < W,
                         y0 + ry1 < H && x0 + rx1 < W, t4, base + W_OFF);

    // Y^T hi and lo: accumulator v of thread (warp w, lane l) is pixel m0 +
    // 8*((v >> 1) & 1), channel 8*(v >> 2) + 2*(l & 3) + (v & 1); entry
    // (channel c, pixel m) lies in k-block m / 32, row c, float m % 32 (a
    // warp's 32 stores of one v hit 32 banks).
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int m = m0 + 8 * ((v >> 1) & 1);
      const int c = 8 * (v >> 2) + 2 * t4 + (v & 1);
      const uint32_t off = (m >> 5) * KB_BYTES +
                           sw128_chunk(c, (m & 31) >> 2) + 4 * (m & 3);
      uint32_t hi, lo;
      split_tf32(acc[v], hi, lo);
      *reinterpret_cast<uint32_t*>(base_ptr + YT_OFF + off) = hi;
      *reinterpret_cast<uint32_t*>(base_ptr + YT_OFF + YT_BYTES + off) = lo;
    }
    // relu(y) into staging buffer s; channel n lies in box n / 32, chunk
    // (n % 32) / 4.
    uint8_t* const zs = base_ptr + Z_OFF + s * 2 * BOX_BYTES;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int rsel = 0; rsel < 2; ++rsel) {
        const int row = m0 + 8 * rsel;
        *reinterpret_cast<float2*>(
            zs + (jj >> 2) * BOX_BYTES +
            sw128_chunk(row, 2 * (jj & 3) + (t4 >> 1)) + 8 * (t4 & 1)) =
            make_float2(fmaxf(acc[4 * jj + 2 * rsel], 0.f),
                        fmaxf(acc[4 * jj + 2 * rsel + 1], 0.f));
      }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      const uint32_t zsa = base + Z_OFF + s * 2 * BOX_BYTES;
      tma_store_4d(&zmap, zsa, 0, x0, y0, b);
      tma_store_4d(&zmap, zsa + BOX_BYTES, 32, x0, y0, b);
      bulk_commit();
    }

    // This tile's Gram: warpgroup 0 HH (A = Y^T hi), warpgroup 1 LH (A =
    // Y^T lo), B = Y^T hi; one k8 step is 32 bytes along a row.
    float gt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gt[i] = 0.f;
    const uint32_t a_part = base + YT_OFF + wg * YT_BYTES;
    fence_acc(gt);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k8_tf32(
            gt, desc_sw128(a_part + kb * KB_BYTES + kk * 32, 16),
            desc_sw128(base + YT_OFF + kb * KB_BYTES + kk * 32, 16));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(gt);
#pragma unroll
    for (int i = 0; i < 32; ++i) run[i] += gt[i];
  }
  if (tid == 0) bulk_wait<0>();

  // The block's partial: each warpgroup's running sum (row i of the
  // accumulator: channel i) goes to shared memory over Y^T, then entry
  // (i, j) is (HH[i][j] + LH[i][j]) + LH[j][i].
  __syncthreads();
  float* const sums = reinterpret_cast<float*>(base_ptr + YT_OFF);
#pragma unroll
  for (int v = 0; v < 32; ++v)
    sums[wg * C * SUM_PITCH +
         (16 * warp + 8 * ((v >> 1) & 1) + g) * SUM_PITCH + 8 * (v >> 2) +
         2 * t4 + (v & 1)] = run[v];
  __syncthreads();
  float* out = partial + ((long long)b * nblk + blk) * C * C;
  const float* hh = sums;
  const float* lh = sums + C * SUM_PITCH;
  for (int e = tid; e < C * C; e += THREADS) {
    const int i = e / C, j = e % C;
    out[e] = (hh[i * SUM_PITCH + j] + lh[i * SUM_PITCH + j]) +
             lh[j * SUM_PITCH + i];
  }
}

}  // namespace

// x (B, H, W, 3), w (27, 64) (the HWIO weights flattened) and b (64,)
// float32; z (B, H, W, 64) float32, 16-byte aligned; partial (B, blocks,
// 64, 64) float32 scratch; g64 (B, 64, 64) float32; blocks the persistent
// blocks per image. Returns a cudaError_t, or ENCODE_ERROR + the CUresult
// of the tensor-map encoding.
extern "C" int st3d_conv1_1_gram_tf32x3_f32(const void* x, const void* w,
                                            const void* b, void* z,
                                            void* partial, void* g64, int B,
                                            int H, int W, int blocks,
                                            void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap zmap;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {32, TW, TH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &zmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, z, dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      conv1_1_gram_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  conv1_1_gram_tf32x3_kernel<<<dim3((unsigned)blocks, (unsigned)B), THREADS,
                               SMEM, st>>>(
      zmap, (const float*)x, (const float*)w, (const float*)b,
      (float*)partial, H, W);
  err = (int)cudaGetLastError();
  if (err) return err;
  // One 64 x 64 tile: the upper-tile pass adds every entry of the partials.
  return gram_reduce_upper<C>(partial, g64, B, C, blocks, st);
}
