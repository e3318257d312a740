// Per-image unnormalised Gram matrix G[b] = y[b]^T y[b] of a bf16 NHWC
// activation y (B, P = H*W, C) on Hopper's tensor cores, accumulated in
// float32.
//
// Replaces the Gram half of st3d/kernels/conv_pallas.py::_conv_gram_kernel
// and _conv_gram_kernel_halo (entry _conv_gram_impl) for bf16 with C a
// multiple of 8; csrc/gram_tf32x3.cu takes float32 and csrc/gram_narrow.cu
// the other widths up to 32, such as conv1_1's 27-wide patch Gram
// (kernels/conv.py::gram_route).
//
// The GEMM: M = N = C, K = the pixels. y is described to TMA as the 3-D
// tensor (C, P, B), innermost first; the box (64 channels, 64 pixels, 1)
// lands as a [64 pixels x 64 channels] tile with the 128-byte swizzle. As
// an operand of G = y^T y that tile is MN-major (the channels, M or N, are
// contiguous), so both wgmma operands are read with the transpose bits set,
// which wgmma allows for 16-bit inputs only: this route is bf16 only.
//
// Work layout: a block owns one 128 x 128 tile of G, of the upper triangle
// only (tile row <= tile column), for one image and one pixel slice.
//   - Per 64-pixel step a stage holds the two 64-channel boxes of the tile's
//     rows (A0, A1) and of its columns (B0, B1); a diagonal tile loads A0,
//     A1 alone and reads them as B too.
//   - One producer warp keeps STAGES steps in flight (TMA onto the stage's
//     "full" mbarrier); two consumer warpgroups each run wgmma m64n128k16
//     on 64 rows (A0 or A1) against the 128 columns (B0, B1: leading offset
//     8192 bytes), one group in flight, freeing a stage on its "empty"
//     mbarrier.
//   - Pass 1 writes each slice's float32 partial tile to scratch; pass 2
//     adds the slices in a fixed order, one thread per entry of the upper
//     tiles, and writes the entry and its mirror. Blocks run in no order on
//     the card and nothing is added atomically, so the Gram is the same on
//     every run. Slices are whole 64-pixel boxes (kernels/conv.py::
//     gram_split), so a box never reads the next slice's pixels; the last
//     box of an image reads past P, which TMA fills with zeros.
//
// What bounds it on an H100: operations (2*P*C*C flops against 2*P*C
// bytes). The partial scratch (B * slices * C * C floats) is written and
// read once, mostly in L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 128;                        // Gram rows/columns a block
constexpr int BP = 64;                           // pixels per box
constexpr int CH = 64;                           // channels per box
constexpr int BOX_BYTES = BP * CH * 2;
constexpr int STAGE_BYTES = 4 * BOX_BYTES;       // A0, A1, B0, B1
constexpr int STAGES = 4;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;   // + 1024-byte alignment
constexpr int CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;    // + one producer warp

// Pass 1. blockIdx.x: upper-triangle tile (row-major over tile rows),
// blockIdx.y: image * S + slice. Threads 0-255: the two consumer
// warpgroups; threads 256-287: the producer warp.
__global__ void __launch_bounds__(THREADS, 1)
gram_wgmma_partial_kernel(__grid_constant__ const CUtensorMap ymap,
                          float* __restrict__ partial, int P, int C, int S,
                          int slice_len, int tiles) {
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[STAGES]);

  int k = blockIdx.x, ti = 0;
  while (k >= tiles - ti) {
    k -= tiles - ti;
    ++ti;
  }
  const int tj = ti + k;
  const bool diag = ti == tj;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int b = blockIdx.y / S, s = blockIdx.y % S;
  const int p_begin = s * slice_len;
  const int p_end = min(P, p_begin + slice_len);
  const int n_iter = (p_end - p_begin + BP - 1) / BP;

  if (threadIdx.x == 0) {
    for (int q = 0; q < STAGES; ++q) {
      mbar_init(full0 + 8 * q, 1);
      mbar_init(empty0 + 8 * q, CONSUMERS * 4);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMERS) {
    if (threadIdx.x == CONSUMERS * 128) {
      for (int it = 0; it < n_iter; ++it) {
        const int q = it % STAGES;
        mbar_wait(empty0 + 8 * q, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * q;
        const uint32_t dst = ring + q * STAGE_BYTES;
        const int p = p_begin + it * BP;
        mbar_expect_tx(full, (diag ? 2 : 4) * BOX_BYTES);
        tma_load_3d(dst, &ymap, full, i0, p, b);
        tma_load_3d(dst + BOX_BYTES, &ymap, full, i0 + CH, p, b);
        if (!diag) {
          tma_load_3d(dst + 2 * BOX_BYTES, &ymap, full, j0, p, b);
          tma_load_3d(dst + 3 * BOX_BYTES, &ymap, full, j0 + CH, p, b);
        }
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < n_iter; ++it) {
    const int q = it % STAGES;
    mbar_wait(full0 + 8 * q, (it / STAGES) & 1);
    const uint32_t stage = ring + q * STAGE_BYTES;
    const uint32_t a = stage + wg * BOX_BYTES;
    const uint32_t bb = stage + (diag ? 0 : 2 * BOX_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BP / 16; ++kk) {
      // One k16 step is 16 pixel rows of 128 bytes.
      wgmma_m64n128k16<1, 1>(acc, desc_sw128(a + kk * 2048, BOX_BYTES),
                             desc_sw128(bb + kk * 2048, BOX_BYTES));
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator v of thread (warp w, lane l) of the warpgroup: row
  // 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1).
  const int warp = (threadIdx.x >> 5) & 3;
  float* out = partial + ((long long)b * S + s) * C * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + wg * 64 + 16 * warp + 8 * h + (lane >> 2);
    if (i >= C) continue;
#pragma unroll
    for (int jj = 0; jj < TILE / 8; ++jj) {
      const int j = j0 + 8 * jj + 2 * (lane & 3);
      if (j >= C) continue;
      *reinterpret_cast<float2*>(out + (long long)i * C + j) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
  }
}

}  // namespace

// y (B, P, C) bf16, 16-byte aligned, C a multiple of 8; partial (B, S, C, C)
// float32 scratch; g (B, C, C) float32; slice s covers pixels
// [s*slice_len, min(P, (s+1)*slice_len)), slice_len a multiple of 64.
// Returns a cudaError_t, or ENCODE_ERROR + the CUresult of the tensor-map
// encoding.
extern "C" int st3d_gram_wgmma_bf16(const void* y, void* partial, void* g,
                                    int B, int P, int C, int S,
                                    int slice_len, void* stream) {
  if (C % 8 || slice_len % BP) return (int)cudaErrorInvalidValue;
  CUtensorMap ymap;
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t stride[2] = {(cuuint64_t)C * 2, (cuuint64_t)P * C * 2};
  const cuuint32_t box[3] = {CH, BP, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(y), dim,
      stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      gram_wgmma_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (C + TILE - 1) / TILE;
  dim3 grid((unsigned)(tiles * (tiles + 1) / 2), (unsigned)(B * S));
  gram_wgmma_partial_kernel<<<grid, THREADS, SMEM, st>>>(
      ymap, (float*)partial, P, C, S, slice_len, tiles);
  err = (int)cudaGetLastError();
  if (err) return err;
  return gram_reduce_upper<TILE>(partial, g, B, C, S, st);
}
