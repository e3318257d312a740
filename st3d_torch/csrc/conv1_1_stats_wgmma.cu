// VGG conv1_1 with the statistics of its Gram on Hopper's tensor cores,
// bf16: one pass over the image x (B, H, W, 3) writes z = relu(conv3x3_same
// (x, W) + b) (B, H, W, Cout) in bf16, and per image the float32 patch
// statistics PtP (27, 27) and s27 (27,) of the zero-padded 3x3 patches P
// (H*W, 27), patch order (dy, dx, c) as in the HWIO flatten of W
// (models/vgg.py::gram1_closed_form folds the Gram out of them).
//
// Replaces the TPU kernel st3d/kernels/stage1_pallas.py::_conv1_1_kernel
// (entry conv1_1_packed via _conv1_1_call / _packed_call, K4a) for bf16
// with Cout a multiple of 8 (kernels/stage1.py::c11_route);
// csrc/conv1_1_stats_tf32x3.cu takes float32. The TPU ran both products as
// MXU dots in the input dtype with float32 accumulation
// (stage1_pallas.py:461 dot(p, w), :467 dot(p.T, p)); bf16 wgmma with
// float32 accumulators is that arithmetic.
//
// Work layout: persistent blocks, blocksPerImage of them per image (the
// wrapper's kernels/stage1.py::c11_stats_blocks); block c of image b walks
// the image's 32 x 4 pixel tiles c, c + blocksPerImage, ... (row-major
// over the tiles; the right and bottom tiles may be ragged). Per tile:
//   - the x halo, 34 x 6 pixels x 3 channels (1224 bytes; TMA's 16-byte
//     inner box does not fit a 6-byte pixel), is loaded with coalesced
//     plain loads, zero outside the image, into registers while the
//     previous tile's products run, then into shared memory;
//   - both warpgroups build the patch tile P from it, 128 rows x 64 bf16
//     columns with the 128-byte swizzle: columns 0-26 the patch, column 27
//     the constant 1, columns 28-63 zero (rows of pixels past the image
//     all zero, the ones column included);
//   - z: wgmma m64n64k16 per warpgroup (64 pixel rows), A = P (K-major,
//     two k16 steps over columns 0-31), B = the resident weights W' (32 x
//     64 per 64-channel chunk, K-major, laid out by each block from the
//     (27, Cout) weights and the bias: row n holds W[:, n], then b[n] in
//     column 27), so the bias rides the product and z = relu(acc) rounds
//     once into bf16. The tile is staged in shared memory with the
//     128-byte swizzle (conflict-free stores) and written by one TMA store
//     of the (64, 32, 4, 1) box of z seen as (Cout, W, H, B), which clips
//     the pixels past the image. Two staging buffers, so one store drains
//     while the next tile is computed;
//   - PtP: wgmma m64n64k16 with both operands the same P tile read
//     MN-major (A = P^T, B = P, K = the warpgroup's 64 pixels), accumulated
//     in registers over every tile the block owns. Row 27 of P^T P is the
//     ones column against P: s27. Each warpgroup writes its float32 28 x 28
//     partial once; a second pass adds the partials of an image in a fixed
//     order. The tile assignment is static and nothing is added atomically,
//     so the statistics are the same on every run.
//
// What bounds it on an H100: writing z, 134 MB in bf16 at 512^2 x 4 views
// (40 us at 3.35 TB/s); the products are 13 GFLOP of tensor work (13 us at
// the bf16 peak). The CUDA-core kernel it replaced spent one shared-memory
// load per FMA (0.39 ms at that shape).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int K = 27;                  // 3x3 taps x 3 channels
constexpr int KS = 28;                 // statistics rows kept: P^T P and s27
constexpr int NSTAT = K * K + K;
constexpr int TW = 32, TH = 4;         // tile: TW x TH pixels
constexpr int BM = TW * TH;            // 128 pixels, P's rows
constexpr int HX = TW + 2, HY = TH + 2;
constexpr int THREADS = 256;           // two warpgroups, 64 tile rows each
constexpr int TILE_BYTES = BM * 128;   // a 128 x 64 bf16 tile (P or z)
constexpr int W_BYTES = 64 * 128;      // a 64 x 64 K-major weight chunk
constexpr int MAX_COUT = 128;

// Shared memory, 1024-byte aligned: P, two z staging tiles, the x halo,
// the weights.
constexpr int P_OFF = 0;
constexpr int Z_OFF = TILE_BYTES;
constexpr int X_OFF = 3 * TILE_BYTES;
constexpr int W_OFF = X_OFF + 2048;
static_assert(HX * HY * 3 * 2 <= 2048, "the x halo fits its slot");

__host__ __device__ constexpr int smem_bytes(int chunks) {
  return W_OFF + chunks * W_BYTES + 1024;
}
// A block's 227 KB at the widest Cout; two blocks to an SM at Cout = 64
// (each block also holds 1 KB the runtime keeps).
static_assert(smem_bytes(MAX_COUT / 64) <= 232448, "a block's shared memory");
static_assert(2 * (smem_bytes(1) + 1024) <= 233472, "two blocks to an SM");

using Halo = XWindow<HX, HY, THREADS>;

__global__ void __launch_bounds__(THREADS, 2)
conv1_1_stats_wgmma_kernel(__grid_constant__ const CUtensorMap zmap,
                           const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ bias,
                           float* __restrict__ partial, int H, int W,
                           int Cout) {
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
  const int chunks = (Cout + 63) / 64;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (long long)b * H * W * 3;
  // This thread's P row: tile pixel (ry, rx).
  const int r = tid & (BM - 1);
  const int ry = r / TW, rx = r % TW;

  // P's columns 32-63 (chunks 4-7) stay zero; the tiles rewrite chunks
  // 0-3. W' goes in as 64-row K-major chunks: row n (channel n) holds
  // W[k][n] in column k < 27 and b[n] in column 27, zeros after and for
  // channels past Cout. The first tile's barriers order these writes
  // before their readers.
  for (int i = tid; i < BM * 4; i += THREADS)
    *reinterpret_cast<uint4*>(base_ptr + P_OFF +
                              sw128_chunk(i >> 2, 4 + (i & 3))) =
        make_uint4(0u, 0u, 0u, 0u);
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(w);
  const unsigned short* b16 = reinterpret_cast<const unsigned short*>(bias);
  for (int i = tid; i < chunks * 64 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (n < Cout) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * j + e;
        const uint32_t bits = k < K    ? __ldg(w16 + k * Cout + n)
                              : k == K ? __ldg(b16 + n)
                                       : 0u;
        v[e >> 1] |= bits << (16 * (e & 1));
      }
    }
    *reinterpret_cast<uint4*>(base_ptr + W_OFF + (n >> 6) * W_BYTES +
                              sw128_chunk(n & 63, j)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }

  float acc_g[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_g[i] = 0.f;
  Halo hv;
  int t = blk;
  if (t < tiles)
    hv.load(xb, H, W, (t % tiles_x) * TW - 1, (t / tiles_x) * TH - 1, tid);
  int stores = 0;
  for (; t < tiles; t += nblk) {
    const int x0 = (t % tiles_x) * TW, y0 = (t / tiles_x) * TH;
    hv.store(halo, tid);
    __syncthreads();
    const int tn = t + nblk;
    if (tn < tiles)
      hv.load(xb, H, W, (tn % tiles_x) * TW - 1, (tn / tiles_x) * TH - 1,
              tid);
    // Warpgroup 0 builds chunks 0 and 2 of every row, warpgroup 1 chunks 1
    // and 3.
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
    // The staging tile this tile's first store uses was read out by the
    // store two stores ago.
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();

    const uint32_t a_rows = base + P_OFF + wg * 64 * 128;
    for (int nc = 0; nc < chunks; ++nc) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      const uint32_t wb = base + W_OFF + nc * W_BYTES;
      // One wgmma group: with the first chunk, P^T P over this
      // warpgroup's 64 pixels (four k16 steps of 16 rows); then z.
      fence_acc(acc);
      fence_acc(acc_g);
      wgmma_fence();
      if (nc == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = desc_sw128(a_rows + kk * 2048, 8192);
          wgmma_m64n64k16<1, 1>(acc_g, d, d);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_m64n64k16<0, 0>(acc, desc_sw128(a_rows + kk * 32, 16),
                              desc_sw128(wb + kk * 32, 16));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(acc_g);
      const int s = stores & 1;
      if (nc > 0) {
        if (tid == 0) bulk_wait_read<1>();
        __syncthreads();
      }
      // Accumulator v of thread (warp w, lane l): row 16w + 8*((v >> 1) & 1)
      // + l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1).
      uint8_t* const zs = base_ptr + Z_OFF + s * TILE_BYTES;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wg * 64 + 16 * warp + 8 * h + (lane >> 2);
          *reinterpret_cast<__nv_bfloat162*>(
              zs + sw128_chunk(row, jj) + 4 * (lane & 3)) =
              __floats2bfloat162_rn(fmaxf(acc[4 * jj + 2 * h], 0.f),
                                    fmaxf(acc[4 * jj + 2 * h + 1], 0.f));
        }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        tma_store_4d(&zmap, base + Z_OFF + s * TILE_BYTES, nc * 64, x0, y0,
                     b);
        bulk_commit();
      }
      ++stores;
    }
  }
  if (tid == 0) bulk_wait<0>();

  // This warpgroup's partial: rows and columns 0-27 of its 64 x 64
  // accumulator (warps 0 and 1 hold rows 0-31).
  float* out = partial + (((long long)b * nblk + blk) * 2 + wg) * KS * KS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * warp + 8 * h + (lane >> 2);
    if (i >= KS) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 8 * jj + 2 * (lane & 3);
      if (j >= KS) continue;
      out[i * KS + j] = acc_g[4 * jj + 2 * h];
      out[i * KS + j + 1] = acc_g[4 * jj + 2 * h + 1];
    }
  }
}

// Pass 2: one thread per (image, entry) adds the image's S = 2 *
// blocksPerImage partials in order: PtP[i][j] from row i, s27[j] from row
// 27 (the ones column).
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ ptp,
                                    float* __restrict__ s27, int B, int S) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * NSTAT) return;
  const int b = t / NSTAT, e = t % NSTAT;
  const int i = e < K * K ? e / K : K, j = e < K * K ? e % K : e - K * K;
  const float* src = partial + (long long)b * S * KS * KS + i * KS + j;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += src[(long long)s * KS * KS];
  if (e < K * K) {
    ptp[b * K * K + e] = sum;
  } else {
    s27[b * K + j] = sum;
  }
}

}  // namespace

// x (B, H, W, 3), w (27, Cout) (the HWIO weights flattened) and b (Cout,)
// bf16; z (B, H, W, Cout) bf16, 16-byte aligned; partial (B, blocks, 2, 28, 28)
// float32 scratch; ptp (B, 27, 27), s27 (B, 27) float32; Cout a multiple
// of 8, at most 128; blocks the persistent blocks per image. Returns a
// cudaError_t, or ENCODE_ERROR + the CUresult of the tensor-map encoding.
extern "C" int st3d_conv1_1_stats_wgmma_bf16(const void* x, const void* w,
                                             const void* b, void* z,
                                             void* partial,
                                             void* ptp, void* s27, int B,
                                             int H, int W, int Cout,
                                             int blocks, void* stream) {
  if (Cout % 8 || Cout > MAX_COUT || blocks < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap zmap;
  const cuuint64_t dim[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)Cout * 2,
                                (cuuint64_t)W * Cout * 2,
                                (cuuint64_t)H * W * Cout * 2};
  const cuuint32_t box[4] = {64, TW, TH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &zmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, z, dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  const int smem = smem_bytes((Cout + 63) / 64);
  int err = (int)cudaFuncSetAttribute(
      conv1_1_stats_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  conv1_1_stats_wgmma_kernel<<<dim3((unsigned)blocks, (unsigned)B), THREADS,
                               smem, st>>>(
      zmap, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)b,
      (float*)partial, H, W, Cout);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = B * NSTAT;
  stats_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)ptp, (float*)s27, B, 2 * blocks);
  return (int)cudaGetLastError();
}
