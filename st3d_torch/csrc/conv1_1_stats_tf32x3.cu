// VGG conv1_1 with the statistics of its Gram on Hopper's tensor cores,
// float32 by the 3xTF32 split: one pass over the image x (B, H, W, 3)
// writes z = relu(conv3x3_same(x, W) + b) (B, H, W, Cout) in float32, and
// per image the float32 patch statistics PtP (27, 27) and s27 (27,) of the
// zero-padded 3x3 patches P (H*W, 27), patch order (dy, dx, c) as in the
// HWIO flatten of W (models/vgg.py::gram1_closed_form folds the Gram out of
// them).
//
// Replaces the TPU kernel st3d/kernels/stage1_pallas.py::_conv1_1_kernel
// (entry conv1_1_packed via _conv1_1_call / _packed_call, K4a) for float32
// with Cout a multiple of 4, at most 64 (kernels/stage1.py::c11_route). The
// TPU
// ran both products as float32 dots (stage1_pallas.py:461 dot(p, w), :467
// dot(p.T, p)).
//
// Numerics: csrc/conv3x3_tf32x3.cu's. x is float32, so P is not exact in
// TF32: each factor is split exactly, v = v_hi + v_lo (v_hi with its low 13
// mantissa bits cleared), and a * b ~= a_hi b_hi + a_lo b_hi + a_hi b_lo.
//   - z: P' (a tile's patch rows, column 27 = 1, columns 28-31 = 0) times
//     W' (row n holds W[:, n], then b[n] in column 27, so the bias rides the
//     product): K = 32, three wgmma m64n64k8 per k8 step, 12 in all, one
//     accumulator; relu and one float32 store. The 32 columns are taken in
//     the order of z_column (below), which both operands share.
//   - PtP: the tf32 wgmma takes K-major shared operands only, and here K is
//     the pixels, so both operands are read from a transposed tile P'^T
//     (patch columns as rows, 32 pixels a 128-byte row). Its A operand is
//     64 rows, [P'^T hi; P'^T lo], and its B operand the first 32, P'^T hi:
//     one wgmma m64n32k8 gives HH = Phi^T Phi in rows 0-31 and LH = Plo^T
//     Phi in rows 32-63, and PtP = HH + LH + LH^T (Phi^T Plo = LH^T), a
//     third of the three products' work with no row wasted. Row 27 of each
//     is the ones column (lo = 0): s27 = HH[27] + LH[:, 27] = sum Phi +
//     sum Plo. Each tile's 8 wgmma of a warpgroup (its 64 pixels) sum into
//     a fresh partial that the CUDA cores add to the block's running sum
//     (one accumulator over hundreds of tf32 products drifts to ~1e-5:
//     conv3x3_tf32x3.cu's note).
//
// Work layout: csrc/conv1_1_stats_wgmma.cu's. Persistent blocks,
// blocksPerImage of them per image (kernels/stage1.py::c11_stats_blocks);
// block c of image b walks the image's 32 x 4 pixel tiles c, c +
// blocksPerImage, ... (the right and bottom tiles may be ragged). Per tile:
//   - the x halo, 34 x 6 pixels x 3 channels (2448 bytes), is loaded with
//     coalesced plain loads, zero outside the image, into registers while
//     the previous tile's products run, then into shared memory;
//   - P'^T is built from it: thread (pixel r, half h) writes columns
//     16h .. 16h+15 of its patch row, hi and lo, into k-block r / 32 (a warp
//     writes one 128-byte row per store: no bank conflict);
//   - z's A operand never touches shared memory: each thread reads its
//     fragment of P' (two pixels x 8 columns, the register layout of the
//     tf32 A operand) from the halo and splits it in registers, and its
//     warpgroup (tile pixel rows 2wg, 2wg+1) issues z's 12 wgmma, which run
//     while P'^T is built;
//   - after a barrier each warpgroup issues its 8 PtP wgmma, waits for
//     both groups, folds the partial, and writes relu(z) with the 128-byte
//     swizzle into the staging tile: 128 pixels x 64 channels
//     as two (32, 32, 4, 1) boxes of z seen as (Cout, W, H, B), each one TMA
//     store that clips the pixels past the image (a 128-byte row holds 32
//     float32 channels). One staging tile: its store drains while the next
//     tile's halo, P'^T and products run, and one thread waits for it to
//     have been read before the barrier that precedes the next writes;
//   - at the end the block folds its two warpgroups' running sums into one
//     28 x 28 partial, (HH + LH) + LH^T of warpgroup 0 plus that of
//     warpgroup 1, and a second pass adds the partials of an image in a
//     fixed order. The tile assignment is static and nothing is added
//     atomically, so the statistics are the same on every run.
//
// Shared memory (1024-byte aligned): P'^T 4 k-blocks x 64 rows x 128
// bytes = 32 KB; z staging 32 KB; W' hi and lo 2 x 8 KB; the halo 3 KB:
// 84 KB (+1 KB for the alignment). Registers: the z accumulator (32), the
// PtP partial and running sum (16 + 16) and z's A fragments (16 hi + 16
// lo) a thread, about 160 in all, so one block of 256 to an SM
// (kernels/stage1.py::C11_TF32_STATS_BLOCKS_PER_SM).
//
// What bounds it on an H100: writing z, 268 MB in float32 at 512^2 x 4
// views (80 us at 3.35 TB/s); the products are 3 x 4.3 GFLOP of TF32 work
// for z (K padded to 32) and 4.3 for PtP (one 64 x 32 product a pixel),
// 17 GFLOP (35 us at 495 TFLOP/s). The CUDA-core kernel it replaced spent
// one shared-memory load per FMA (0.39 ms at that shape).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int K = 27;                  // 3x3 taps x 3 channels
constexpr int KS = 28;                 // statistics rows kept: P^T P and s27
constexpr int NSTAT = K * K + K;
constexpr int TW = 32, TH = 4;         // tile: TW x TH pixels
constexpr int BM = TW * TH;            // 128 pixels
constexpr int HX = TW + 2, HY = TH + 2;
constexpr int THREADS = 256;           // two warpgroups, 64 tile pixels each
constexpr int KB_BYTES = 64 * 128;     // a k-block of P'^T: hi rows, lo rows
constexpr int BOX_BYTES = BM * 128;    // a (32, 32, 4, 1) float32 z box
constexpr int W_BYTES = 64 * 128;      // W' (64 x 32, K-major), one part
constexpr int MAX_COUT = 64;
// One block to an SM: two would cap a thread at 128 registers, and the
// fragments, accumulators and sums need about 160 (at 128 they spill).
constexpr int BLOCKS_PER_SM = 1;

// Shared memory, 1024-byte aligned: P'^T, the z staging (two boxes), W'
// hi and lo, the x halo.
constexpr int PT_OFF = 0;
constexpr int Z_OFF = 4 * KB_BYTES;
constexpr int W_OFF = Z_OFF + 2 * BOX_BYTES;
constexpr int X_OFF = W_OFF + 2 * W_BYTES;
constexpr int SMEM = X_OFF + 3072 + 1024;
static_assert(HX * HY * 3 * 4 <= 3072, "the x halo fits its slot");
static_assert(SMEM <= 232448, "a block's shared memory");
static_assert(2 * 64 * 32 * 4 <= 4 * KB_BYTES,
              "the block's two 64 x 32 sums fit over P'^T");

using Halo = XWindow<HX, HY, THREADS, float>;

// z's k order (W' and the A fragments): position p = 8kk + t + 4h of the
// 32, j = 2kk + h, holds patch column 3j + t (tap j, channel t) for t < 3;
// for t = 3, tap 8's channel j (j < 3), the ones column (j = 3) or zero.
// Thread (l/4, t = l%4) then reads tap j's channel t of its pixel: a
// compile-time offset plus t.
__host__ __device__ constexpr int z_column(int p) {
  return (p & 3) < 3 ? 3 * (2 * (p >> 3) + ((p >> 2) & 1)) + (p & 3)
                     : 24 + 2 * (p >> 3) + ((p >> 2) & 1);
}

// Value j (the tap of z's k order) for lane column t of the pixel whose
// window starts at ``pix`` (a float index into the halo).
template <int J>
__device__ __forceinline__ float z_value(const float* halo, int pix, int t,
                                         bool valid) {
  constexpr int TAP = ((J / 3) * HX + J % 3) * 3;
  constexpr int TAP8 = (2 * HX + 2) * 3 + J;
  if (!valid) return 0.f;
  if (t < 3) return halo[pix + TAP + t];
  if (J < 3) return halo[pix + TAP8];
  return J == 3 ? 1.f : 0.f;
}

// Columns C0 .. C0 + 15 (in their natural order, a constant offset each
// once the loop unrolls) of the patch row of tile pixel (ry, rx) into
// P'^T, hi in row c and lo in row 32 + c of the pixel's k-block, at float
// ``col`` of the row.
template <int C0>
__device__ __forceinline__ void build_pt(uint8_t* kb, const float* halo,
                                         int ry, int rx, int col,
                                         bool valid) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    uint32_t hi, lo;
    split_tf32(patch_value<HX>(halo, ry, rx, C0 + e, valid), hi, lo);
    const uint32_t off = sw128_chunk(C0 + e, col >> 2) + 4 * (col & 3);
    *reinterpret_cast<uint32_t*>(kb + off) = hi;
    *reinterpret_cast<uint32_t*>(kb + 32 * 128 + off) = lo;
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
conv1_1_stats_tf32x3_kernel(__grid_constant__ const CUtensorMap zmap,
                            const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ bias,
                            float* __restrict__ partial, int H, int W,
                            int Cout) {
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

  // W' hi and lo, K-major with the 128-byte swizzle: row n (channel n)
  // holds, at position p, W[k][n] for k = z_column(p) < 27 and b[n] for
  // k = 27, zeros for k past 27 and channels past Cout.
  for (int i = tid; i < 64 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = z_column(4 * j + e);
      const float v = n >= Cout ? 0.f
                      : k < K   ? __ldg(w + k * Cout + n)
                      : k == K  ? __ldg(bias + n)
                                : 0.f;
      split_tf32(v, hi[e], lo[e]);
    }
    *reinterpret_cast<uint4*>(base_ptr + W_OFF + sw128_chunk(n, j)) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(base_ptr + W_OFF + W_BYTES +
                              sw128_chunk(n, j)) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  // The first tile's first barrier orders these writes before the wgmma
  // that read them.
  fence_proxy_async();

  float run[16], part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) run[i] = part[i] = 0.f;
  // This thread's P'^T pixel and column half, and its two z rows (tile
  // pixels m0 and m0 + 8).
  const int pr = tid & (BM - 1), half = tid >> 7;
  const int m0 = wg * 64 + 16 * warp + g;
  Halo hv;
  int t = blk;
  if (t < tiles)
    hv.load(xb, H, W, (t % tiles_x) * TW - 1, (t / tiles_x) * TH - 1, tid);
  for (; t < tiles; t += nblk) {
    const int x0 = (t % tiles_x) * TW, y0 = (t / tiles_x) * TH;
    hv.store(halo, tid);
    __syncthreads();
    const int tn = t + nblk;
    if (tn < tiles)
      hv.load(xb, H, W, (tn % tiles_x) * TW - 1, (tn / tiles_x) * TH - 1,
              tid);
    // z's A fragments: a[kk][v] holds P' of pixel m0 + 8*(v & 1) at
    // position 8kk + t4 + 4*(v >> 1) of z's k order, hi and lo.
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int rsel = 0; rsel < 2; ++rsel) {
      const int m = m0 + 8 * rsel;
      const int ry = m / TW, rx = m % TW;
      const bool valid = y0 + ry < H && x0 + rx < W;
      const int pix = (ry * HX + rx) * 3;
      const int v0 = rsel, v1 = rsel + 2;
      split_tf32(z_value<0>(halo, pix, t4, valid), ahi[0][v0], alo[0][v0]);
      split_tf32(z_value<1>(halo, pix, t4, valid), ahi[0][v1], alo[0][v1]);
      split_tf32(z_value<2>(halo, pix, t4, valid), ahi[1][v0], alo[1][v0]);
      split_tf32(z_value<3>(halo, pix, t4, valid), ahi[1][v1], alo[1][v1]);
      split_tf32(z_value<4>(halo, pix, t4, valid), ahi[2][v0], alo[2][v0]);
      split_tf32(z_value<5>(halo, pix, t4, valid), ahi[2][v1], alo[2][v1]);
      split_tf32(z_value<6>(halo, pix, t4, valid), ahi[3][v0], alo[3][v0]);
      split_tf32(z_value<7>(halo, pix, t4, valid), ahi[3][v1], alo[3][v1]);
    }
    // z = P' W' by three products per k8 step, the small ones first; in
    // flight while P'^T is built.
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ahi[kk]);
      fence_regs(alo[kk]);
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = desc_sw128(base + W_OFF + kk * 32, 16);
      const uint64_t bl = desc_sw128(base + W_OFF + W_BYTES + kk * 32, 16);
      wgmma_m64n64k8_tf32_rs(acc, alo[kk], bh);
      wgmma_m64n64k8_tf32_rs(acc, ahi[kk], bl);
      wgmma_m64n64k8_tf32_rs(acc, ahi[kk], bh);
    }
    wgmma_commit();
    // P'^T: pixel pr's columns 16*half .. +15, hi in row c and lo in row
    // 32 + c of k-block pr / 32, at float pr % 32 of the row.
    {
      const int ry = pr / TW, rx = pr % TW;
      const bool valid = y0 + ry < H && x0 + rx < W;
      uint8_t* const kb = base_ptr + PT_OFF + (pr >> 5) * KB_BYTES;
      if (half == 0) {
        build_pt<0>(kb, halo, ry, rx, pr & 31, valid);
      } else {
        build_pt<16>(kb, halo, ry, rx, pr & 31, valid);
      }
    }
    fence_proxy_async();
    // The staging tile was read out by the previous tile's stores.
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();
    // PtP over this warpgroup's k-blocks 2wg, 2wg + 1: A the 64 rows [hi;
    // lo], B the 32 hi rows; one k8 step is 32 bytes along the row.
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc_sw128(
            base + PT_OFF + (2 * wg + q) * KB_BYTES + kk * 32, 16);
        wgmma_m64n32k8_tf32(part, d, d);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(part);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ahi[kk]);
      fence_regs(alo[kk]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      run[i] += part[i];
      part[i] = 0.f;
    }
    // relu(z) into the staging boxes. Accumulator v of thread (warp w,
    // lane l): row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) +
    // 2*(l & 3) + (v & 1); channel n lies in box n / 32, chunk (n % 32) / 4.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int rsel = 0; rsel < 2; ++rsel) {
        const int row = m0 + 8 * rsel;
        uint8_t* const box = base_ptr + Z_OFF + (jj >> 2) * BOX_BYTES;
        *reinterpret_cast<float2*>(
            box + sw128_chunk(row, 2 * (jj & 3) + (t4 >> 1)) +
            8 * (t4 & 1)) =
            make_float2(fmaxf(acc[4 * jj + 2 * rsel], 0.f),
                        fmaxf(acc[4 * jj + 2 * rsel + 1], 0.f));
      }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&zmap, base + Z_OFF, 0, x0, y0, b);
      if (Cout > 32) tma_store_4d(&zmap, base + Z_OFF + BOX_BYTES, 32, x0, y0,
                                  b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();

  // The block's partial: each warpgroup's running 64 x 32 sum (HH in rows
  // 0-31, LH in rows 32-63) goes to shared memory over P'^T, then entry
  // (i, j) of the 28 x 28 partial is the warpgroups' (HH[i][j] + LH[i][j])
  // + LH[j][i], warpgroup 0's first. Accumulator v of thread (warp w, lane
  // l): row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) +
  // (v & 1).
  __syncthreads();
  float* const sums = reinterpret_cast<float*>(base_ptr + PT_OFF);
#pragma unroll
  for (int v = 0; v < 16; ++v)
    sums[(wg * 64 + 16 * warp + 8 * ((v >> 1) & 1) + g) * 32 + 8 * (v >> 2) +
         2 * t4 + (v & 1)] = run[v];
  __syncthreads();
  float* out = partial + ((long long)b * nblk + blk) * KS * KS;
  for (int e = tid; e < KS * KS; e += THREADS) {
    const int i = e / KS, j = e % KS;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* hh = sums + q * 64 * 32;
      const float* lh = hh + 32 * 32;
      v += (hh[i * 32 + j] + lh[i * 32 + j]) + lh[j * 32 + i];
    }
    out[e] = v;
  }
}

// Pass 2: one thread per (image, entry) adds the image's S =
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
// float32; z (B, H, W, Cout) float32, 16-byte aligned; partial (B, blocks,
// 28, 28) float32 scratch; ptp (B, 27, 27), s27 (B, 27) float32; Cout
// a multiple of 4, at most 64; blocks the persistent blocks per image.
// Returns a cudaError_t, or ENCODE_ERROR + the CUresult of the tensor-map
// encoding.
extern "C" int st3d_conv1_1_stats_tf32x3_f32(const void* x, const void* w,
                                             const void* b, void* z,
                                             void* partial, void* ptp,
                                             void* s27, int B, int H, int W,
                                             int Cout, int blocks,
                                             void* stream) {
  if (Cout % 4 || Cout > MAX_COUT || blocks < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap zmap;
  const cuuint64_t dim[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)Cout * 4,
                                (cuuint64_t)W * Cout * 4,
                                (cuuint64_t)H * W * Cout * 4};
  const cuuint32_t box[4] = {32, TW, TH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &zmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, z, dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      conv1_1_stats_tf32x3_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  conv1_1_stats_tf32x3_kernel<<<dim3((unsigned)blocks, (unsigned)B), THREADS,
                                SMEM, st>>>(
      zmap, (const float*)x, (const float*)w, (const float*)b,
      (float*)partial, H, W, Cout);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = B * NSTAT;
  stats_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)ptp, (float*)s27, B, blocks);
  return (int)cudaGetLastError();
}
