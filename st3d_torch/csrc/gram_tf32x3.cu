// Per-image unnormalised Gram matrix G[b] = y[b]^T y[b] of a float32 NHWC
// activation y (B, P = H*W, C) on Hopper's tensor cores, by the 3xTF32
// split, accumulated in float32.
//
// Replaces the Gram half of st3d/kernels/conv_pallas.py::_conv_gram_kernel
// and _conv_gram_kernel_halo (entry _conv_gram_impl) for float32 with C a
// multiple of 4 (the pixel rows of y are C * 4 bytes apart, and TMA strides
// are multiples of 16 bytes); csrc/gram_narrow.cu takes the other widths up
// to 32, such as conv1_1's 27-wide patch Gram (kernels/conv.py::gram_route).
//
// Numerics: csrc/conv3x3_tf32x3.cu's. Each factor is split exactly, y =
// y_hi + y_lo, y_hi with its low 13 mantissa bits cleared, and
//   a * b ~= a_hi * b_hi + a_hi * b_lo + a_lo * b_hi,
// three TF32 products; each 32-pixel box's products sum into a fresh
// partial that the CUDA cores fold into the running sum, as the tensor
// core's own f32 sum over a whole K drifts (conv3x3_tf32x3.cu's note).
//
// Work layout: csrc/gram_wgmma.cu's. A block owns one 128 x 128 tile of G,
// of the upper triangle only (tile row <= tile column), for one image and
// one pixel slice; pass 1 writes each slice's partial tile to scratch and
// pass 2 adds the slices in a fixed order, so a second call gives the same
// bits (no atomics). Slices are whole 32-pixel boxes
// (kernels/conv.py::gram_split); the last box of an image reads past P,
// which TMA fills with zeros.
//
// The layout problem. A tf32 wgmma operand in shared memory must be
// K-major, here pixel-contiguous per channel, while a TMA box of NHWC y is
// channel-contiguous (gram_wgmma.cu reads that MN-major layout with the
// transpose bits, which wgmma allows for 16-bit inputs only). So the
// consumers build the operands:
//   - one producer warp TMA-loads, per 32-pixel box, the tile's row
//     channels and (off the diagonal) its column channels as unswizzled
//     boxes (128 channels, 32 pixels): 16 KB each, a ring of 3 stages;
//   - the two consumer warpgroups (256 threads) turn each box into K-major
//     tiles with the 128-byte swizzle, hi and lo: thread (c, j) reads the
//     four pixels 4j .. 4j+3 of channel c (a warp reads 32 consecutive
//     channels of one pixel: one 128-byte row, no bank conflict), splits
//     them, and writes one 16-byte chunk of hi and one of lo at row c, chunk
//     j ^ (c % 8) (8 consecutive channels hit the 8 chunk positions: no
//     conflict). A diagonal tile builds one operand and reads it as both;
//   - the built tiles are double-buffered, so the consumers build box it+1
//     while the tensor cores run box it: each warpgroup issues the box's
//     three wgmma m64n128k8 tf32 per k8 step (rows wg*64 .. +63 against the
//     128 columns) into the partial, commits, builds the next box (then
//     fences it for the async proxy and frees its TMA stage), waits, folds
//     the partial in, and meets the other warpgroup on a named barrier.
//
// Why this layout and not wgmma's register-A form for the row operand:
// register A would halve the build (the row operand split in registers),
// but its 32 A registers per box on top of the 64 accumulators and 64
// partials leave no room for the build's registers at 288 threads, and it
// would still need the column operand built in shared memory. Budget of the
// chosen form per 32-pixel box: the build reads 16 KB of raw box and writes
// 32 KB of hi and lo per operand (one operand on the diagonal); the three
// products of the two warpgroups read 144 KB of operand tiles and do
// 3 * 2 * 128 * 128 * 32 flops (1,536 cycles of an SM's TF32 rate), so
// shared memory, not the build's arithmetic, is the next limit. Shared
// memory: 3 raw stages of 32 KB and 2 built buffers of 64 KB (A_hi, A_lo,
// B_hi, B_lo): 224 KB of the 227 KB a block may have. Registers: 64
// accumulators and 64 partials a thread, the build's ~20 beside them.
// No transposed copy of y is written to device memory.
//
// What bounds it on an H100: operations (3 * 2 * P * C * C flops on the
// TF32 tensor cores at 495 TFLOP/s, against 4 * P * C bytes). The partial
// scratch (B * slices * C * C floats) is written and read once, mostly in
// L2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 128;                        // Gram rows/columns a block
constexpr int BP = 32;                           // pixels per box
constexpr int RAW_BYTES = TILE * BP * 4;         // one raw box: 16 KB
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 2 * RAW_BYTES;       // rows box, columns box
constexpr int OP_BYTES = TILE * BP * 4;          // one built tile: 16 KB
constexpr int BUF_BYTES = 4 * OP_BYTES;          // A_hi, A_lo, B_hi, B_lo
constexpr int TILES_OFF = STAGES * STAGE_BYTES;
// + 1024: the built tiles are aligned to 1024 bytes, as the 128-byte
// swizzle pattern repeats every 8 rows of 128 bytes.
constexpr int SMEM = TILES_OFF + 2 * BUF_BYTES + 1024;
static_assert(SMEM + 64 <= 232448, "a block's shared memory on an H100");
constexpr int CONSUMERS = 2;
constexpr int C_THREADS = CONSUMERS * 128;
constexpr int THREADS = C_THREADS + 32;          // + one producer warp
constexpr uint32_t HI_MASK = 0xffffe000u;        // sign, exponent, 10 bits
constexpr int BUILT_BAR = 1;                     // named barrier id

__device__ __forceinline__ float hi_part(float v) {
  return __uint_as_float(__float_as_uint(v) & HI_MASK);
}

// One operand: the raw box (32 pixel rows of 128 channels, 512 bytes each)
// into K-major swizzled tiles hi and lo (128 channel rows of 32 pixels,
// 128 bytes each). t is the consumer thread, 0-255.
__device__ __forceinline__ void build_operand(const uint8_t* raw, uint8_t* hi,
                                              uint8_t* lo, int t) {
  const int c = t & (TILE - 1);
  const float* src = reinterpret_cast<const float*>(raw) + c;
#pragma unroll
  for (int i = 0; i < BP / 8; ++i) {
    const int j = (t >> 7) + 2 * i;              // 4-pixel chunk, 0-7
    const float4 v = make_float4(src[(4 * j) * TILE], src[(4 * j + 1) * TILE],
                                 src[(4 * j + 2) * TILE],
                                 src[(4 * j + 3) * TILE]);
    const float4 h = make_float4(hi_part(v.x), hi_part(v.y), hi_part(v.z),
                                 hi_part(v.w));
    const int off = c * 128 + ((j ^ (c & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
}

// Pass 1. blockIdx.x: upper-triangle tile (row-major over tile rows),
// blockIdx.y: image * S + slice. Threads 0-255: the two consumer
// warpgroups; threads 256-287: the producer warp.
__global__ void __launch_bounds__(THREADS, 1)
gram_tf32x3_partial_kernel(__grid_constant__ const CUtensorMap ymap,
                           float* __restrict__ partial, int P, int C, int S,
                           int slice_len, int tiles) {
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
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
    if (threadIdx.x == C_THREADS) {
      for (int it = 0; it < n_iter; ++it) {
        const int q = it % STAGES;
        mbar_wait(empty0 + 8 * q, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * q;
        const uint32_t dst = base + q * STAGE_BYTES;
        const int p = p_begin + it * BP;
        mbar_expect_tx(full, (diag ? 1 : 2) * RAW_BYTES);
        tma_load_3d(dst, &ymap, full, i0, p, b);
        if (!diag) tma_load_3d(dst + RAW_BYTES, &ymap, full, j0, p, b);
      }
    }
    return;
  }

  const int t = threadIdx.x;                     // 0-255
  const int lane = t & 31;
  // Waits for box it's raw stage, builds its operands into buffer it % 2,
  // fences the writes for the async proxy and frees the stage.
  auto build = [&](int it) {
    const int q = it % STAGES;
    mbar_wait(full0 + 8 * q, (it / STAGES) & 1);
    const uint8_t* raw = base_ptr + q * STAGE_BYTES;
    uint8_t* buf = base_ptr + TILES_OFF + (it & 1) * BUF_BYTES;
    build_operand(raw, buf, buf + OP_BYTES, t);
    if (!diag)
      build_operand(raw + RAW_BYTES, buf + 2 * OP_BYTES, buf + 3 * OP_BYTES,
                    t);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * q);
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  build(0);
  named_barrier(BUILT_BAR, C_THREADS);
  for (int it = 0; it < n_iter; ++it) {
    const uint32_t buf = base + TILES_OFF + (it & 1) * BUF_BYTES;
    const uint32_t a_hi = buf + wg * 64 * 128;
    const uint32_t a_lo = a_hi + OP_BYTES;
    const uint32_t b_hi = diag ? buf : buf + 2 * OP_BYTES;
    const uint32_t b_lo = b_hi + OP_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BP / 8; ++kk) {
      // One k8 step is 32 bytes along the swizzled 128-byte row; the
      // leading offset of a K-major tile is unused (16). The small
      // products go first.
      const uint64_t dah = desc_sw128(a_hi + kk * 32, 16);
      const uint64_t dal = desc_sw128(a_lo + kk * 32, 16);
      const uint64_t dbh = desc_sw128(b_hi + kk * 32, 16);
      const uint64_t dbl = desc_sw128(b_lo + kk * 32, 16);
      wgmma_m64n128k8_tf32(part, dal, dbh);
      wgmma_m64n128k8_tf32(part, dah, dbl);
      wgmma_m64n128k8_tf32(part, dah, dbh);
    }
    wgmma_commit();
    // The other buffer was last read by box it-1's wgmma, which both
    // warpgroups waited for before the barrier that ended box it-1.
    if (it + 1 < n_iter) build(it + 1);
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] += part[i];
      part[i] = 0.f;
    }
    // Box it+1 is built by both warpgroups, and box it's wgmma are done.
    named_barrier(BUILT_BAR, C_THREADS);
  }

  // Accumulator v of thread (warp w, lane l) of the warpgroup: row
  // 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1).
  const int warp = (t >> 5) & 3;
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

// y (B, P, C) float32, 16-byte aligned, C a multiple of 4; partial (B, S,
// C, C) float32 scratch; g (B, C, C) float32; slice s covers pixels
// [s*slice_len, min(P, (s+1)*slice_len)), slice_len a multiple of 32.
// Returns a cudaError_t, or ENCODE_ERROR + the CUresult of the tensor-map
// encoding.
extern "C" int st3d_gram_tf32x3_f32(const void* y, void* partial, void* g,
                                    int B, int P, int C, int S,
                                    int slice_len, void* stream) {
  if (C % 4 || slice_len % BP || slice_len <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ymap;
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t stride[2] = {(cuuint64_t)C * 4, (cuuint64_t)P * C * 4};
  const cuuint32_t box[3] = {TILE, BP, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &ymap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(y), dim,
      stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      gram_tf32x3_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (C + TILE - 1) / TILE;
  dim3 grid((unsigned)(tiles * (tiles + 1) / 2), (unsigned)(B * S));
  gram_tf32x3_partial_kernel<<<grid, THREADS, SMEM, st>>>(
      ymap, (float*)partial, P, C, S, slice_len, tiles);
  err = (int)cudaGetLastError();
  if (err) return err;
  return gram_reduce_upper<TILE>(partial, g, B, C, S, st);
}
