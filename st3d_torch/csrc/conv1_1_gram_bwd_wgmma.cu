// Input gradient of VGG conv1_1 with the direct Gram of its pre-ReLU output
// folded in, on Hopper's tensor cores, bf16 (the forward is
// csrc/conv1_1_gram_wgmma.cu). The forward gave z = relu(y) and g64 =
// y_r^T y_r, y = conv3x3_same(x, W) + b with float32 accumulation and y_r =
// y rounded to bf16. Given the cotangent dz (B, H, W, 64) of z and S =
// dG + dG^T (B, 64, 64) float32 of g64, each pixel's conv cotangent is
//     d = round_bf16(dz * [y > 0] + y_r S)          (float32 sums)
// and dx (B, H, W, 3) is col2im(d W^T), float32 sums, rounded once.
//
// Replaces the TPU kernel st3d/kernels/stage1v3_pallas.py::_c11_bwd_kernel
// (entry _c11_v3_bwd, K10b) for bf16 (kernels/stage1v3.py::v3_route);
// csrc/conv1_1_gram_bwd_tf32x3.cu takes float32. The TPU
// recomputed y in float32 for its halo rows, masked on it, took y_r S as a
// float32 dot, rounded d once into bf16 and folded it with bf16 dots and
// float32 accumulation (stage1v3_pallas.py:388-403). Here y_r S takes S
// split exactly into bf16 hi + lo by the wrapper: y_r is exact in bf16, so
// y_r S_hi + y_r S_lo is y_r S to about 2^-16 of each term, as kernel B
// (csrc/conv1_1_bwd_wgmma.cu) does for P S.
//
// Work layout: kernel B's. Persistent blocks, one an SM (kernels/stage1.py::
// c11_bwd_blocks), each walking dx tiles blockIdx.x, + gridDim.x, ... in
// raster order (image, tile row, tile column). A tile is TW x TH = 22 x 14
// dx pixels; d is computed on its 24 x 16 halo, 384 pixels. Per tile:
//   - dz arrives by TMA as the (64, 24, 16, 1) box of the 4-D (64, W, H, B)
//     tensor at (0, x0 - 1, y0 - 1, b) with the 128-byte swizzle, into one
//     of two stages: one thread issues a tile's load two tiles ahead. TMA's
//     zero fill gives dz = 0 outside the image. There is no z box: y is
//     recomputed, as on the TPU. The x window of the next tile (26 x 18
//     pixels) is loaded into registers while this tile's products run;
//   - three warpgroups, one thread a halo pixel, build the patch tile P
//     (384 x 64 bf16, the 128-byte swizzle; columns 0-26 the patch, 27 the
//     constant 1, 28-31 zero; a halo pixel outside the image has a zero
//     row, so its y, mask and y_r are 0 and, with dz zero-filled, its d is
//     0, as the TPU kernel's guard rows gave);
//   - each warpgroup runs its two 64-row groups one after the other
//     (both at once held 168 registers a thread and spilled) through three
//     products, a group's last one left in flight under the next group's
//     first:
//     1. y: hopper.cuh's conv1_1_y, the forward's instructions on the same
//        P rows and W', so the mask and y_r equal the forward's bit for bit;
//     2. the mask [y > 0] on the float32 accumulator; y_r = bf16(y) goes
//        from the accumulator straight into wgmma A fragments (for
//        m64nNk16 the f32 accumulator of columns 16j .. 16j + 15 sits where
//        k-step j's A fragment wants it); the d accumulator starts as
//        dz * mask, read from the swizzled dz box in the accumulator's
//        layout; then y_r S_hi + y_r S_lo by wgmma m64n64k16 with A from
//        registers, four k16 steps each (S hi and lo K-major 64 x 64 B
//        tiles, copied in when the tile's image changes);
//     3. d rounded to bf16, again into A fragments, times W^T by wgmma
//        m64n32k16 (W^T K-major, the (27, 64) weights as they are, rows
//        27-31 zero): the patch cotangent dP;
//   - dP (float32, k-major, rows padded to 388 floats) is staged over the
//     dz box; each dx value gathers its nine taps in a fixed order and is
//     rounded once. No atomics.
//
// What bounds it on an H100: reading dz, 134 MB in bf16 at 512^2 x 4 views
// (40 us at 3.35 TB/s, 44 us with x and dx); the products, with the 1.25x
// halo and S's two parts, are ~40 GFLOP of tensor work (41 us at the bf16
// peak). The CUDA-core kernel it replaced ran them on the fp32 cores (1.1
// ms at that shape).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int K = 27;
constexpr int C = 64;
constexpr int TW = 22, TH = 14;          // dx tile
constexpr int HX = TW + 2, HY = TH + 2;  // d halo box
constexpr int M = HX * HY;               // 384 halo pixels
constexpr int WGS = 3;                   // warpgroups
constexpr int GROUPS = M / 64 / WGS;     // 64-row groups per warpgroup
constexpr int THREADS = WGS * 128;
constexpr int BOX_BYTES = M * 128;       // one (64, 24, 16, 1) bf16 box
constexpr int B64_BYTES = 64 * 128;      // a 64 x 64 K-major B tile
constexpr int WT_BYTES = 32 * 128;       // W^T, 32 x 64 K-major
constexpr int DP_PITCH = M + 4;          // floats per dP row of the staging
static_assert(M == 64 * GROUPS * WGS && M == THREADS,
              "one halo row a thread, whole 64-row groups per warpgroup");
static_assert(K * DP_PITCH * 4 <= BOX_BYTES, "dP fits over the dz box");
using XWin = XWindow<HX + 2, HY + 2, THREADS>;

// Shared memory, 1024-byte aligned: two dz stages, P, S hi and lo, W',
// W^T, the x window.
constexpr int P_OFF = 2 * BOX_BYTES;
constexpr int S_OFF = P_OFF + BOX_BYTES;
constexpr int WB_OFF = S_OFF + 2 * B64_BYTES;
constexpr int WT_OFF = WB_OFF + B64_BYTES;
constexpr int X_OFF = WT_OFF + WT_BYTES;
constexpr int SMEM_BYTES = X_OFF + 3072 + 1024;
static_assert(XWin::VALUES * 2 <= 3072, "the x window fits its slot");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");

struct Tile {
  int b, x0, y0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  Tile r;
  r.x0 = (t % tiles_x) * TW;
  t /= tiles_x;
  r.y0 = (t % tiles_y) * TH;
  r.b = t / tiles_y;
  return r;
}

__global__ void __launch_bounds__(THREADS, 1)
conv1_1_gram_bwd_wgmma_kernel(__grid_constant__ const CUtensorMap dzmap,
                              const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ w,
                              const __nv_bfloat16* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ s_parts,
                              __nv_bfloat16* __restrict__ dx, int H, int W,
                              int tiles_x, int tiles_y, int tiles) {
  __shared__ __align__(8) uint64_t full[2];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  unsigned short* const win =
      reinterpret_cast<unsigned short*>(base_ptr + X_OFF);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int nblk = gridDim.x;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - (int)blockIdx.x + nblk - 1) / nblk : 0;

  // Tile i of this block into stage i % 2, that stage's (i / 2)-th fill.
  auto issue = [&](int i) {
    const Tile tl = tile_at(blockIdx.x + i * nblk, tiles_x, tiles_y);
    const uint32_t bar = smem_u32(&full[i & 1]);
    mbar_expect_tx(bar, BOX_BYTES);
    tma_load_4d(base + (i & 1) * BOX_BYTES, &dzmap, bar, 0, tl.x0 - 1,
                tl.y0 - 1, tl.b);
  };
  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < 2 && i < mine; ++i) issue(i);
  }
  // W' (y's B tile) and W^T (dP's): row n < 27 of W^T holds row n of the
  // (27, 64) weights; rows 27-31 zero. The first tile's barriers order
  // these writes before their readers.
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(w);
  load_conv1_1_wb<THREADS>(base_ptr + WB_OFF, w16,
                           reinterpret_cast<const unsigned short*>(bias),
                           tid);
  for (int i = tid; i < 32 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    const uint4 v = n < K ? __ldg(reinterpret_cast<const uint4*>(w16 + n * C)
                                  + j)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(base_ptr + WT_OFF + sw128_chunk(n, j)) = v;
  }

  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(x);
  XWin xw;
  if (mine > 0) {
    const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_y);
    xw.load(x16 + (long long)tl.b * H * W * 3, H, W, tl.x0 - 2, tl.y0 - 2,
            tid);
  }
  // Rows of this thread's accumulator entries in group g: row0 + 64g and
  // row0 + 64g + 8.
  const int row0 = wg * GROUPS * 64 + 16 * warp + (lane >> 2);
  int s_image = -1;                        // the image whose S is loaded
  for (int i = 0; i < mine; ++i) {
    const Tile tl = tile_at(blockIdx.x + i * nblk, tiles_x, tiles_y);
    uint8_t* const st_ptr = base_ptr + (i & 1) * BOX_BYTES;
    // The x window and S of this tile; the previous tile's readers
    // finished before its last barrier.
    xw.store(win, tid);
    if (tl.b != s_image) {
      const uint4* src = reinterpret_cast<const uint4*>(
          s_parts + (long long)tl.b * 2 * C * C);
      for (int e = tid; e < 2 * 64 * 8; e += THREADS)
        *reinterpret_cast<uint4*>(base_ptr + S_OFF + (e >> 9) * B64_BYTES +
                                  sw128_chunk((e >> 3) & 63, e & 7)) =
            __ldg(src + e);
      s_image = tl.b;
    }
    __syncthreads();
    // P: thread tid builds halo row tid, chunks 0-3 (y reads no other).
    // Halo row r is pixel (y0 - 1 + r / HX, x0 - 1 + r % HX), its 3 x 3
    // window at (r / HX, r % HX) of the x window.
    {
      const int hy = tid / HX, hx = tid % HX;
      const int gy = tl.y0 - 1 + hy, gx = tl.x0 - 1 + hx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      uint8_t* const p = base_ptr + P_OFF;
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 0)) =
          patch_row_chunk<HX + 2, 0>(win, hy, hx, in);
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 1)) =
          patch_row_chunk<HX + 2, 1>(win, hy, hx, in);
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 2)) =
          patch_row_chunk<HX + 2, 2>(win, hy, hx, in);
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 3)) =
          patch_row_chunk<HX + 2, 3>(win, hy, hx, in);
    }
    fence_proxy_async();
    __syncthreads();
    // The next tile's x window, in flight under the products.
    if (i + 1 < mine) {
      const Tile tn = tile_at(blockIdx.x + (i + 1) * nblk, tiles_x, tiles_y);
      xw.load(x16 + (long long)tn.b * H * W * 3, H, W, tn.x0 - 2, tn.y0 - 2,
              tid);
    }

    // Group by group: y, then d, then dP; a group's dP product stays in
    // flight under the next group's y.
    float dp[GROUPS][16];
    uint32_t da[GROUPS][4][4];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      fence_acc(acc);
      wgmma_fence();
      conv1_1_y(acc, base + P_OFF + (wg * GROUPS + g) * 64 * 128,
                base + WB_OFF);
      wgmma_commit();
      if (g == 0) mbar_wait(smem_u32(&full[i & 1]), (i >> 1) & 1);
      wgmma_wait<0>();
      fence_acc(acc);
      if (g > 0) {
        fence_acc(dp[g - 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) fence_regs(da[g - 1][j]);
      }
      uint32_t ya[4][4];
      acc_to_a_bf16(acc, ya);
#pragma unroll
      for (int v = 0; v < 32; v += 2) {
        const int row = row0 + 64 * g + 8 * ((v >> 1) & 1);
        const __nv_bfloat162 dz2 = *reinterpret_cast<const __nv_bfloat162*>(
            st_ptr + sw128_chunk(row, v >> 2) + 4 * (lane & 3));
        const float2 f = __bfloat1622float2(dz2);
        acc[v] = acc[v] > 0.f ? f.x : 0.f;
        acc[v + 1] = acc[v + 1] > 0.f ? f.y : 0.f;
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_m64n64k16_rs(acc, ya[j],
                             desc_sw128(base + S_OFF + part * B64_BYTES +
                                            j * 32, 16));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(ya[j]);
      acc_to_a_bf16(acc, da[g]);
#pragma unroll
      for (int e = 0; e < 16; ++e) dp[g][e] = 0.f;
      fence_acc(dp[g]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_m64n32k16_rs(dp[g], da[g][j],
                           desc_sw128(base + WT_OFF + j * 32, 16));
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      fence_acc(dp[g]);
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(da[g][j]);
    }
    __syncthreads();                       // every dz read is done

    // dP (k-major) over the dz box.
    float* dps = reinterpret_cast<float*>(st_ptr);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        const int row = row0 + 64 * g + 8 * ((v >> 1) & 1);
        const int k = 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
        if (k < K) dps[k * DP_PITCH + row] = dp[g][v];
      }
    __syncthreads();

    // col2im by gather: dx pixel (oy, ox) of the tile takes tap (dy, dx)
    // from halo pixel (oy + 2 - dy, ox + 2 - dx).
    for (int item = tid; item < 3 * TW * TH; item += THREADS) {
      const int c = item / (TW * TH), pix = item % (TW * TH);
      const int oy = pix / TW, ox = pix % TW;
      const int y = tl.y0 + oy, xg = tl.x0 + ox;
      if (y >= H || xg >= W) continue;
      float sum = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int ddx = 0; ddx < 3; ++ddx)
          sum += dps[((dy * 3 + ddx) * 3 + c) * DP_PITCH +
                     (oy + 2 - dy) * HX + ox + 2 - ddx];
      dx[(((long long)tl.b * H + y) * W + xg) * 3 + c] =
          __float2bfloat16_rn(sum);
    }
    // The stage, the x window and S are free; the generic writes to the
    // stage are ordered before the next TMA write into it.
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && i + 2 < mine) issue(i + 2);
  }
}

}  // namespace

// x (B, H, W, 3) bf16; dz (B, H, W, 64) bf16, 16-byte aligned; w (27, 64)
// bf16 (the HWIO weights flattened), 16-byte aligned; b (64,) bf16;
// s_parts (B, 2, 64, 64) bf16, 16-byte aligned: per image S^T split into
// hi and lo (row o of a part holds S[:, o]); dx (B, H, W, 3) bf16; blocks
// the persistent blocks. Returns a cudaError_t, or ENCODE_ERROR + the
// CUresult of the tensor-map encoding.
extern "C" int st3d_conv1_1_gram_bwd_wgmma_bf16(const void* x, const void* dz,
                                                const void* w, const void* b,
                                                const void* s_parts, void* dx,
                                                int B, int H, int W,
                                                int blocks, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap dzmap;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {C, HX, HY, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      &dzmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(dz), dim,
      stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      conv1_1_gram_bwd_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  conv1_1_gram_bwd_wgmma_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                                  (cudaStream_t)stream>>>(
      dzmap, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)b, (const __nv_bfloat16*)s_parts,
      (__nv_bfloat16*)dx, H, W, tiles_x, tiles_y, B * tiles_x * tiles_y);
  return (int)cudaGetLastError();
}
