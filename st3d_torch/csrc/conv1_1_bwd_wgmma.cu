// Input gradient of VGG conv1_1 with its Gram statistics folded in, on
// Hopper's tensor cores, bf16. With P the zero-padded 3x3 patches of x
// (B, H, W, 3), patch order (dy, dx, c), the forward gave z = relu(P W + b),
// PtP = P^T P and s27 = P^T 1 per image. Given their cotangents dz
// (B, H, W, Cout), S = dPtP + dPtP^T (B, 27, 27) and ds27 (B, 27), the
// patch cotangent of each pixel is
//     dP = (dz * [z > 0]) W^T + P S + ds27            (27 values)
// and dx (B, H, W, 3) is its col2im, rounded once into bf16.
//
// Replaces the TPU kernel st3d/kernels/stage1_pallas.py::_conv1_1_bwd_kernel
// (entry conv1_1_bwd_dx, K4c) for bf16 with Cout a multiple of 8
// (kernels/stage1.py::c11_route); csrc/conv1_1_bwd_tf32x3.cu takes float32.
// The TPU ran dot(d.astype(dz.dtype), w) in the input dtype
// and dot(p, sym) in float32 (stage1_pallas.py:607-617); here the first is
// the same bf16 product on wgmma, and the second takes S split exactly
// into bf16 hi + lo by the wrapper: P is exact in bf16 (x is bf16), so
// P hi + P lo is P S to about 2^-16 of each term.
//
// Work layout: persistent blocks, one an SM (kernels/stage1.py::
// c11_bwd_blocks), each walking dx tiles blockIdx.x, + gridDim.x, ... in
// raster order (image, tile row, tile column), so that at any time the
// card works on neighbouring tiles and their halo re-reads come from L2. A
// tile is TW x TH = 22 x 14 dx pixels; dP is computed on its 24 x 16 halo,
// 384 pixels (a 1.25x recompute). Per tile:
//   - dz and z arrive by TMA as (64, 24, 16, 1) boxes of the 4-D (C, W, H,
//     B) tensors at (c0, x0 - 1, y0 - 1, b) with the 128-byte swizzle, as
//     K2's A tiles, into one of two stages: one thread issues a tile's
//     loads two tiles ahead, so one stage is read from device memory while
//     the other is computed. TMA's zero fill gives d = 0 outside the image
//     and past Cout. The x window of the next tile (26 x 18 pixels) is
//     loaded into registers while this tile's products run (XWindow);
//   - three warpgroups, one thread a halo pixel, mask d = dz * [z > 0] in
//     place (the two boxes share their swizzled layout, so the mask is
//     elementwise, two bf16 a SIMD compare), then build the patch tile P
//     (384 x 64, column 27 = 1, columns 28-63 = 0, rows of halo pixels
//     outside the image zero) over the z box from the window in shared
//     memory, while the tensor cores run d W^T;
//   - each warpgroup runs wgmma m64n32k16 on two 64-row groups of the
//     halo: d W^T (four k16 steps per 64-channel slab; W^T K-major, the
//     (27, Cout) weights as they are, rows 27-31 zero, resident), then
//     P S'hi and P S'lo (two k16 steps each; S' = S with ds27 as row 27,
//     K-major, split into bf16 hi + lo by the block when the image
//     changes: row n holds S[k][n] for k < 27 and ds27[n] in column 27).
//     The ones column adds ds27; a halo pixel outside the image has d = 0
//     and a zero P row, so its dP is 0;
//   - dP (float32, k-major, rows padded to 388 floats so the accumulator
//     stores hit 32 banks) is staged over the d box; each dx value then
//     gathers its nine taps in a fixed order and is rounded once. No
//     atomics. Cout past 64 runs slab by slab through the stages.
//
// What bounds it on an H100: reading dz and z, 2 x 134 MB in bf16 at
// 512^2 x 4 views (80 us at 3.35 TB/s); the products are 12 GFLOP of
// tensor work with the halo. The CUDA-core kernel it replaced spent about
// 2.5 k shared-memory loads a pixel (0.81 ms at that shape).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int K = 27;
constexpr int TW = 22, TH = 14;          // dx tile
constexpr int HX = TW + 2, HY = TH + 2;  // dP halo box
constexpr int M = HX * HY;               // 384 halo pixels
constexpr int WGS = 3;                   // warpgroups
constexpr int GROUPS = M / 64 / WGS;     // 64-row groups per warpgroup
constexpr int THREADS = WGS * 128;
constexpr int BOX_BYTES = M * 128;       // one (64, 24, 16, 1) bf16 box
constexpr int STAGE_BYTES = 2 * BOX_BYTES;   // d, then z (then P)
constexpr int BT_BYTES = 32 * 128;       // a 32 x 64 K-major B tile
constexpr int DP_PITCH = M + 4;          // floats per dP row of the staging
constexpr int MAX_COUT = 128;
static_assert(M == 64 * GROUPS * WGS && M == THREADS,
              "one halo row a thread, whole 64-row groups per warpgroup");
static_assert(K * DP_PITCH * 4 <= BOX_BYTES, "dP fits over the d box");
using XWin = XWindow<HX + 2, HY + 2, THREADS>;

// Shared memory, 1024-byte aligned: two stages, S' hi and lo, the x
// window, W^T by slab.
constexpr int S_OFF = 2 * STAGE_BYTES;
constexpr int X_OFF = S_OFF + 2 * BT_BYTES;
constexpr int W_OFF = X_OFF + 3072;
static_assert(XWin::VALUES * 2 <= 3072, "the x window fits its slot");

__host__ __device__ constexpr int smem_bytes(int slabs) {
  return W_OFF + slabs * BT_BYTES + 1024;
}
static_assert(smem_bytes(MAX_COUT / 64) <= 232448,
              "a block's shared memory at the widest Cout");

// 8 bf16 of dz, zeroed where z <= 0 (or NaN), as the plain version's
// where(z > 0, dz, 0): a bf16 h is above 0 exactly when h - 1, as an
// unsigned 16-bit number, is below 0x7F80 (h from the smallest positive
// subnormal, 0x0001, to +inf, 0x7F80; 0 wraps to 0xFFFF, and the sign bit
// and NaNs land above), two halves at a time.
__device__ __forceinline__ uint32_t keep(uint32_t z2) {
  return __vcmpltu2(__vsub2(z2, 0x00010001u), 0x7F807F80u);
}

__device__ __forceinline__ uint4 relu_mask(uint4 d, uint4 z) {
  return make_uint4(d.x & keep(z.x), d.y & keep(z.y), d.z & keep(z.z),
                    d.w & keep(z.w));
}

// W^T's K-major B tile of a 64-channel slab, with the 128-byte swizzle:
// row n < 27 holds channels c0 .. c0 + 63 of row n of the (27, Cout)
// weights (16-byte aligned), rows 27-31 and channels past Cout zero.
__device__ __forceinline__ void load_w_tile(uint8_t* dst,
                                            const __nv_bfloat16* w, int Cout,
                                            int c0, int tid) {
  for (int i = tid; i < 32 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    const int c = c0 + 8 * j;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < K && c < Cout)
      val = __ldg(reinterpret_cast<const uint4*>(w + (long long)n * Cout + c));
    *reinterpret_cast<uint4*>(dst + sw128_chunk(n, j)) = val;
  }
}

// S' of one image as two K-major B tiles, hi and lo, with the 128-byte
// swizzle: row n < 27, column k holds S'[k][n] = S[k][n] (k < 27) or
// ds27[n] (k = 27) split exactly into bf16 hi = rn(S'), lo = rn(S' - hi);
// everything else zero.
__device__ __forceinline__ void load_s_tiles(uint8_t* hi, uint8_t* lo,
                                             const float* sym,
                                             const float* ds27, int tid) {
  for (int i = tid; i < 32 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    uint32_t h[4] = {0u, 0u, 0u, 0u}, l[4] = {0u, 0u, 0u, 0u};
    if (n < K && j < 4) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * j + e;
        const float v = k < K ? __ldg(sym + k * K + n)
                        : k == K ? __ldg(ds27 + n) : 0.f;
        const __nv_bfloat16 vh = __float2bfloat16_rn(v);
        const __nv_bfloat16 vl =
            __float2bfloat16_rn(v - __bfloat162float(vh));
        h[e >> 1] |= (uint32_t)__bfloat16_as_ushort(vh) << (16 * (e & 1));
        l[e >> 1] |= (uint32_t)__bfloat16_as_ushort(vl) << (16 * (e & 1));
      }
    }
    *reinterpret_cast<uint4*>(hi + sw128_chunk(n, j)) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + sw128_chunk(n, j)) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

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
conv1_1_bwd_wgmma_kernel(__grid_constant__ const CUtensorMap dzmap,
                         __grid_constant__ const CUtensorMap zmap,
                         const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ sym,
                         const float* __restrict__ ds27,
                         __nv_bfloat16* __restrict__ dx, int H, int W,
                         int Cout, int tiles_x, int tiles_y, int tiles) {
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
  const int slabs = (Cout + 63) / 64;
  const int nblk = gridDim.x;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - (int)blockIdx.x + nblk - 1) / nblk : 0;
  const int units = mine * slabs;          // (tile, slab) loads, in order

  // Unit u: tile blockIdx.x + (u / slabs) * nblk, slab u % slabs, stage
  // u % 2, that stage's (u / 2)-th fill.
  auto issue = [&](int u) {
    const Tile tl = tile_at(blockIdx.x + (u / slabs) * nblk, tiles_x,
                            tiles_y);
    const uint32_t st = base + (u & 1) * STAGE_BYTES;
    const uint32_t bar = smem_u32(&full[u & 1]);
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load_4d(st, &dzmap, bar, 64 * (u % slabs), tl.x0 - 1, tl.y0 - 1,
                tl.b);
    tma_load_4d(st + BOX_BYTES, &zmap, bar, 64 * (u % slabs), tl.x0 - 1,
                tl.y0 - 1, tl.b);
  };
  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int u = 0; u < 2 && u < units; ++u) issue(u);
  }
  for (int s = 0; s < slabs; ++s)
    load_w_tile(base_ptr + W_OFF + s * BT_BYTES, w, Cout, 64 * s, tid);

  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(x);
  XWin xw;
  if (mine > 0) {
    const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_y);
    xw.load(x16 + (long long)tl.b * H * W * 3, H, W, tl.x0 - 2, tl.y0 - 2,
            tid);
  }
  int s_image = -1;                        // the image whose S' is loaded
  float acc[GROUPS][16];
  for (int u = 0; u < units; ++u) {
    const int i = u / slabs, slab = u % slabs;
    const Tile tl = tile_at(blockIdx.x + i * nblk, tiles_x, tiles_y);
    const uint32_t st = base + (u & 1) * STAGE_BYTES;
    uint8_t* const st_ptr = base_ptr + (u & 1) * STAGE_BYTES;
    const bool last = slab == slabs - 1;
    if (slab == 0) {
#pragma unroll
      for (int g = 0; g < GROUPS; ++g)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[g][e] = 0.f;
    }
    if (last) {
      // The x window and S' of this tile; the previous tile's readers
      // finished before its last barrier.
      xw.store(win, tid);
      if (tl.b != s_image) {
        load_s_tiles(base_ptr + S_OFF, base_ptr + S_OFF + BT_BYTES,
                     sym + (long long)tl.b * K * K, ds27 + (long long)tl.b * K,
                     tid);
        s_image = tl.b;
      }
    }
    mbar_wait(smem_u32(&full[u & 1]), (u >> 1) & 1);
    for (int e = tid; e < M * 8; e += THREADS) {
      uint4* d = reinterpret_cast<uint4*>(st_ptr) + e;
      *d = relu_mask(*d, reinterpret_cast<const uint4*>(st_ptr +
                                                        BOX_BYTES)[e]);
    }
    fence_proxy_async();
    __syncthreads();
    // d W^T for this slab, in flight while P is built.
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) fence_acc(acc[g]);
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const uint32_t a = st + (wg * GROUPS + g) * 64 * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32k16<0, 0>(acc[g], desc_sw128(a + kk * 32, 16),
                              desc_sw128(base + W_OFF + slab * BT_BYTES +
                                             kk * 32, 16));
    }
    wgmma_commit();
    if (!last) {
      wgmma_wait<0>();
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) fence_acc(acc[g]);
      __syncthreads();                     // the stage is free
      if (tid == 0 && u + 2 < units) issue(u + 2);
      continue;
    }
    // P over the z box from the window: thread tid builds halo row tid,
    // chunks 0-3 from the window, 4-7 zero. Halo row r is pixel (y0 - 1 +
    // r / HX, x0 - 1 + r % HX), its 3 x 3 window at (r / HX, r % HX) of
    // the x window.
    {
      const int hy = tid / HX, hx = tid % HX;
      const int gy = tl.y0 - 1 + hy, gx = tl.x0 - 1 + hx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      uint8_t* const p = st_ptr + BOX_BYTES;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 0)) =
          patch_row_chunk<HX + 2, 0>(win, hy, hx, in);
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 1)) =
          patch_row_chunk<HX + 2, 1>(win, hy, hx, in);
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 2)) =
          patch_row_chunk<HX + 2, 2>(win, hy, hx, in);
      *reinterpret_cast<uint4*>(p + sw128_chunk(tid, 3)) =
          patch_row_chunk<HX + 2, 3>(win, hy, hx, in);
#pragma unroll
      for (int j = 4; j < 8; ++j)
        *reinterpret_cast<uint4*>(p + sw128_chunk(tid, j)) = zero;
    }
    fence_proxy_async();
    __syncthreads();
    // The next tile's x window, in flight under the products.
    if (i + 1 < mine) {
      const Tile tn = tile_at(blockIdx.x + (i + 1) * nblk, tiles_x, tiles_y);
      xw.load(x16 + (long long)tn.b * H * W * 3, H, W, tn.x0 - 2, tn.y0 - 2,
              tid);
    }
    // P S'hi + P S'lo, after d W^T in the same accumulators.
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) fence_acc(acc[g]);
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const uint32_t a = st + BOX_BYTES + (wg * GROUPS + g) * 64 * 128;
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_m64n32k16<0, 0>(acc[g], desc_sw128(a + kk * 32, 16),
                                desc_sw128(base + S_OFF + part * BT_BYTES +
                                               kk * 32, 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) fence_acc(acc[g]);
    __syncthreads();                       // no wgmma reads the d box now

    // dP (k-major) over the d box. Accumulator v of thread (warp w, lane
    // l): row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3)
    // + (v & 1).
    float* dps = reinterpret_cast<float*>(st_ptr);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        const int row = (wg * GROUPS + g) * 64 + 16 * warp +
                        8 * ((v >> 1) & 1) + (lane >> 2);
        const int k = 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
        if (k < K) dps[k * DP_PITCH + row] = acc[g][v];
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
    // The stage, the x window and S' are free; the generic writes to the
    // stage are ordered before the next TMA writes into it.
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && u + 2 < units) issue(u + 2);
  }
}

CUresult encode_box(CUtensorMap* map, const void* t, int B, int H, int W,
                    int C) {
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, HX, HY, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dim,
      stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// x (B, H, W, 3), dz and z (B, H, W, Cout) bf16, dz and z 16-byte aligned;
// w (27, Cout) bf16 (the HWIO weights flattened), 16-byte aligned; sym
// (B, 27, 27) and ds27 (B, 27) float32; dx (B, H, W, 3) bf16; Cout a
// multiple of 8, at most 128; blocks the persistent blocks. Returns a
// cudaError_t, or ENCODE_ERROR + the CUresult of a tensor-map encoding.
extern "C" int st3d_conv1_1_bwd_wgmma_bf16(const void* x, const void* dz,
                                           const void* z, const void* w,
                                           const void* sym, const void* ds27,
                                           void* dx, int B,
                                           int H, int W, int Cout, int blocks,
                                           void* stream) {
  if (Cout % 8 || Cout > MAX_COUT || blocks < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap dzmap, zmap;
  CUresult r = encode_box(&dzmap, dz, B, H, W, Cout);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_box(&zmap, z, B, H, W, Cout);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  const int smem = smem_bytes((Cout + 63) / 64);
  int err = (int)cudaFuncSetAttribute(
      conv1_1_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  conv1_1_bwd_wgmma_kernel<<<(unsigned)blocks, THREADS, smem,
                             (cudaStream_t)stream>>>(
      dzmap, zmap, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const float*)sym, (const float*)ds27, (__nv_bfloat16*)dx, H, W, Cout,
      tiles_x, tiles_y, B * tiles_x * tiles_y);
  return (int)cudaGetLastError();
}
