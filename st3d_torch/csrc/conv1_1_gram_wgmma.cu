// VGG conv1_1 with the direct Gram of its pre-ReLU output on Hopper's
// tensor cores, bf16: one pass over the image x (B, H, W, 3) writes z =
// relu(y) (B, H, W, 64) in bf16, where y = conv3x3_same(x, W) + b with
// float32 accumulation, and per image the float32 Gram g64 = y_r^T y_r
// (64, 64) of y rounded once to bf16.
//
// Replaces the TPU kernel st3d/kernels/stage1v3_pallas.py::_c11_fwd_kernel
// (entry conv1_1_packed_v3, K10a) for bf16 (kernels/stage1v3.py::v3_route);
// csrc/conv1_1_gram_tf32x3.cu takes float32. The TPU ran y as an
// MXU dot in bf16 with float32 accumulation, rounded it once for z and once
// for the Gram's operand, and ran the Gram as a bf16 dot with float32
// accumulation (stage1v3_pallas.py:262-272): bf16 wgmma with float32
// accumulators is that arithmetic.
//
// Work layout: kernel A's (csrc/conv1_1_stats_wgmma.cu). Persistent
// blocks, blocksPerImage of them per image (kernels/stage1.py::
// c11_stats_blocks); block c of image b walks the image's 32 x 4 pixel
// tiles c, c + blocksPerImage, ... Per tile:
//   - the x halo (34 x 6 pixels x 3 channels) is loaded with coalesced
//     plain loads into registers while the previous tile's products run,
//     then stored to shared memory;
//   - both warpgroups build the patch tile P, 128 rows x 64 bf16 columns
//     with the 128-byte swizzle: columns 0-26 the patch, column 27 the
//     constant 1, 28-31 zero (a row of a pixel past the image all zero,
//     the ones column included, so the bias stays out of the Gram);
//   - y: wgmma m64n64k16 per warpgroup (64 pixel rows), two k16 steps,
//     against the resident W' (row n: W[:, n], then b[n] in column 27),
//     through hopper.cuh's conv1_1_y, which the backward kernel
//     (csrc/conv1_1_gram_bwd_wgmma.cu) shares;
//   - y_r: the accumulator rounded once to bf16, staged as a 128 x 64
//     swizzled tile in one of two staging buffers;
//   - the Gram: wgmma m64n64k16 with A = y_r^T and B = y_r, both read
//     MN-major from the staged rows of the warpgroup (K = its 64 pixels,
//     four k16 steps), as A reads P for P^T P; a named barrier over the
//     warpgroup orders the staging before it. Each tile's product starts
//     from zero and is added to a float32 sum in registers;
//   - z: bf16 rounding is monotone and keeps the sign, so z = relu(y_r)
//     exactly; once the Gram's wgmma has been waited for, each thread
//     zeroes the negative halves it staged, in place, and one TMA store of
//     the (64, 32, 4, 1) box of z seen as (64, W, H, B) writes the tile,
//     clipping the pixels past the image. The store of the other buffer
//     drains meanwhile; a buffer is rewritten only after its store has
//     read it (bulk_wait_read).
// Each (block, warpgroup) writes its 64 x 64 partial once; a second pass
// (hopper.cuh's gram_reduce_upper) adds an image's partials in a fixed
// order. Nothing is added atomically: g64 is the same on every run.
//
// What bounds it on an H100: writing z, 134 MB in bf16 at 512^2 x 4 views
// (40 us at 3.35 TB/s); the products are 12.2 GFLOP of tensor work (12 us
// at the bf16 peak). The CUDA-core kernel it replaced ran the Gram on the
// fp32 cores (0.70 ms at that shape).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C = 64;                  // conv1_1's output channels
constexpr int TW = 32, TH = 4;         // tile: TW x TH pixels
constexpr int BM = TW * TH;            // 128 pixels, P's rows
constexpr int HX = TW + 2, HY = TH + 2;
constexpr int THREADS = 256;           // two warpgroups, 64 tile rows each
constexpr int TILE_BYTES = BM * 128;   // a 128 x 64 bf16 tile (P or y_r)
constexpr int W_BYTES = 64 * 128;      // W', 64 x 64 K-major

// Shared memory, 1024-byte aligned: P, two y_r / z staging tiles, the x
// halo, W'.
constexpr int P_OFF = 0;
constexpr int Y_OFF = TILE_BYTES;
constexpr int X_OFF = 3 * TILE_BYTES;
constexpr int W_OFF = X_OFF + 2048;
constexpr int SMEM_BYTES = W_OFF + W_BYTES + 1024;
static_assert(HX * HY * 3 * 2 <= 2048, "the x halo fits its slot");
// Two blocks to an SM (each block also holds 1 KB the runtime keeps).
static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two blocks to an SM");

using Halo = XWindow<HX, HY, THREADS>;

__global__ void __launch_bounds__(THREADS, 2)
conv1_1_gram_wgmma_kernel(__grid_constant__ const CUtensorMap zmap,
                          const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const __nv_bfloat16* __restrict__ bias,
                          float* __restrict__ partial, int H, int W) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  unsigned short* const halo =
      reinterpret_cast<unsigned short*>(base_ptr + X_OFF);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH);
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (long long)b * H * W * 3;
  // This thread's P row: tile pixel (ry, rx).
  const int r = tid & (BM - 1);
  const int ry = r / TW, rx = r % TW;
  // Rows of this thread's accumulator entries: row0 and row0 + 8.
  const int row0 = wg * 64 + 16 * warp + (lane >> 2);

  // The first tile's barriers order W' before its readers.
  load_conv1_1_wb<THREADS>(base_ptr + W_OFF,
                           reinterpret_cast<const unsigned short*>(w),
                           reinterpret_cast<const unsigned short*>(bias),
                           tid);

  float g[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) g[i] = 0.f;
  Halo hv;
  int t = blk;
  if (t < tiles)
    hv.load(xb, H, W, (t % tiles_x) * TW - 1, (t / tiles_x) * TH - 1, tid);
  int s = 0;                               // this tile's staging buffer
  for (; t < tiles; t += nblk, s ^= 1) {
    const int x0 = (t % tiles_x) * TW, y0 = (t / tiles_x) * TH;
    hv.store(halo, tid);
    __syncthreads();
    const int tn = t + nblk;
    if (tn < tiles)
      hv.load(xb, H, W, (tn % tiles_x) * TW - 1, (tn / tiles_x) * TH - 1,
              tid);
    // Warpgroup 0 builds chunks 0 and 2 of every row, warpgroup 1 chunks 1
    // and 3; y's two k16 steps read no other chunk.
    const bool valid = y0 + ry < H && x0 + rx < W;
    uint4 c_lo, c_hi;
    if (wg == 0) {
      c_lo = patch_row_chunk<HX, 0>(halo, ry, rx, valid);
      c_hi = patch_row_chunk<HX, 2>(halo, ry, rx, valid);
    } else {
      c_lo = patch_row_chunk<HX, 1>(halo, ry, rx, valid);
      c_hi = patch_row_chunk<HX, 3>(halo, ry, rx, valid);
    }
    *reinterpret_cast<uint4*>(base_ptr + P_OFF + sw128_chunk(r, wg)) = c_lo;
    *reinterpret_cast<uint4*>(base_ptr + P_OFF + sw128_chunk(r, wg + 2)) =
        c_hi;
    fence_proxy_async();
    // Staging buffer s was read out by the store two tiles ago.
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();

    // y for this warpgroup's 64 pixels.
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_acc(acc);
    wgmma_fence();
    conv1_1_y(acc, base + P_OFF + wg * 64 * 128, base + W_OFF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    // y_r into the staging tile: accumulator v of thread (warp w, lane l)
    // is row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3)
    // + (v & 1); yr[2*jj + h] holds columns 8jj + 2(l & 3), +1 of row
    // row0 + 8h.
    uint8_t* const ys = base_ptr + Y_OFF + s * TILE_BYTES;
    uint32_t yr[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        yr[2 * jj + h] =
            pack_bf16x2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(ys + sw128_chunk(row0 + 8 * h, jj) +
                                     4 * (lane & 3)) = yr[2 * jj + h];
      }
    fence_proxy_async();
    named_barrier(1 + wg, 128);            // the warpgroup's rows staged

    // This tile's Gram over the warpgroup's 64 pixels, then into the sum.
    float gt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gt[i] = 0.f;
    const uint32_t y_rows = base + Y_OFF + s * TILE_BYTES + wg * 64 * 128;
    fence_acc(gt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc_sw128(y_rows + kk * 2048, 8192);
      wgmma_m64n64k16<1, 1>(gt, d, d);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(gt);
#pragma unroll
    for (int i = 0; i < 32; ++i) g[i] += gt[i];

    // z = relu(y_r) in place: a half whose sign bit is set becomes +0.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = yr[2 * jj + h];
        const uint32_t neg = (v >> 15) & 0x00010001u;
        if (neg)
          *reinterpret_cast<uint32_t*>(ys + sw128_chunk(row0 + 8 * h, jj) +
                                       4 * (lane & 3)) = v & ~(neg * 0xFFFFu);
      }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&zmap, base + Y_OFF + s * TILE_BYTES, 0, x0, y0, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();

  // This warpgroup's 64 x 64 partial (row i of the accumulator: channel i).
  float* out = partial + (((long long)b * nblk + blk) * 2 + wg) * C * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * warp + 8 * h + (lane >> 2);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * jj + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + i * C + j) =
          make_float2(g[4 * jj + 2 * h], g[4 * jj + 2 * h + 1]);
    }
  }
}

}  // namespace

// x (B, H, W, 3), w (27, 64) (the HWIO weights flattened) and b (64,)
// bf16; z (B, H, W, 64) bf16, 16-byte aligned; partial (B, blocks, 2, 64,
// 64) float32 scratch; g64 (B, 64, 64) float32; blocks the persistent
// blocks per image. Returns a cudaError_t, or ENCODE_ERROR + the CUresult
// of the tensor-map encoding.
extern "C" int st3d_conv1_1_gram_wgmma_bf16(const void* x, const void* w,
                                            const void* b, void* z,
                                            void* partial, void* g64, int B,
                                            int H, int W, int blocks,
                                            void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap zmap;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {C, TW, TH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &zmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, z, dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      conv1_1_gram_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  conv1_1_gram_wgmma_kernel<<<dim3((unsigned)blocks, (unsigned)B), THREADS,
                              SMEM_BYTES, st>>>(
      zmap, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)b, (float*)partial, H, W);
  err = (int)cudaGetLastError();
  if (err) return err;
  // One 64 x 64 tile: the upper-tile pass adds every entry of the partials.
  return gram_reduce_upper<C>(partial, g64, B, C, 2 * blocks, st);
}
