// 3x3 SAME stride-1 convolution + bias (+ ReLU) in float32 on Hopper's
// tensor cores, by the 3xTF32 split: f32 NHWC activations, weights laid out
// (Cout, 9, Cin) and split into hi and lo parts by the wrapper, f32
// accumulation and output. The same mainloop with a second epilogue is C in
// float32, conv + bias + ReLU + 2x2 max-pool with the window index (below).
//
// Replaces the TPU kernels st3d/kernels/conv_pallas.py::_conv_kernel,
// _conv_kernel_nopad and _conv_kernel_halo1 (entry _conv3x3_same_impl) for
// float32 with Cin and Cout multiples of 4; csrc/conv3x3_nhwc.cu (CUDA
// cores) keeps the other widths (kernels/conv.py::conv_route). With the
// pool epilogue it replaces, for float32 with Cin and Cout multiples of 4
// (kernels/conv.py::relu_pool_route), the TPU kernels
// st3d/kernels/stage1_pallas.py::_conv1_2_kernel (entry conv1_2_packed_pool,
// K4b; K10c's _c12_fwd_kernel is the same body),
// conv_pallas.py::_conv2x2_fwd_kernel (entry conv3x3_bias_relu_pool_packed,
// K5) and conv_pallas.py's conv3x3_bias_relu_pool with pool=True (K8);
// csrc/conv3x3_relu_pool.cu (CUDA cores) keeps the other widths.
//
// Numerics. One TF32 product keeps about 11 bits of each factor, too few
// for the f32 tolerance (1e-4 of the largest output). Each factor is split
// exactly, x = x_hi + x_lo, where x_hi is x with its low 13 mantissa bits
// cleared (a TF32 value) and x_lo = x - x_hi (exact in f32), and
//   a * b ~= a_hi * b_hi + a_hi * b_lo + a_lo * b_hi,
// three TF32 products; a_lo * b_lo and the bits of a_lo, b_lo past TF32
// are below 2^-20 of a * b. The hi parts are cleared here, not left to the
// tensor core, so hi + lo == x holds exactly whatever the hardware does
// with the low bits. The tensor core's own f32 sum loses more: summed in
// one accumulator over 3 * 9 * Cin / 8 wgmma, the conv came 1.7e-5 of its
// largest output off a float64 conv at Cin = 256 (H100), as adds that
// truncate would. So each k-iteration's 12 wgmma sum into a fresh partial,
// which the CUDA cores add to the running sum (round to nearest).
//
// Work layout: csrc/conv3x3_wgmma.cu's implicit GEMM (M = B*H*W output
// pixels, N = Cout, K = 9*Cin, tap by tap), with 32-channel slabs (32 f32 =
// one 128-byte swizzle row):
//   - x is the 4-D TMA tensor (C, W, H, B); tap (dy, dx)'s A tile is the box
//     (32, BW, BH, 1) at (c0, x0 + dx, y0 + dy, b), zero-filled outside the
//     tensor, which is the SAME padding; B_hi and B_lo are boxes (32, 1, BN)
//     of the two (Cout, 9, Cin) weight parts;
//   - a stage holds A (16 KB), A_lo (16 KB), B_hi and B_lo (BN * 128 bytes
//     each): 64 KB at BN = 128, so 3 stages; 4 at BN = 64. One producer
//     warp keeps the ring full with TMA;
//   - each of the two consumer warpgroups splits its own 64-row half of A:
//     it reads a, writes a_hi back in place and a_lo into A_lo at the same
//     swizzled byte offset, fences the writes for the async proxy, meets on
//     a 128-thread named barrier, then runs three wgmma m64nBNk8 per k8
//     step (+32 bytes along the swizzled row, as bf16's k16) into the
//     partial, waits for them, frees the stage and folds the partial in;
//   - epilogue (STORE): accumulators + bias, optional ReLU, f32 stores from
//     registers; pixels of the box outside the image are not stored.
//   - epilogue (POOL), csrc/conv3x3_wgmma.cu's pool in float32: the tile
//     holds whole 2x2 windows (kernels/conv.py::pool_tile: BW <= 64, both
//     sides even, origins and H, W even). The two rows of a window lie in
//     the two warpgroups, so bias and ReLU are applied in registers (f32,
//     no rounding step) and the 128 x BN f32 tile is staged in the drained
//     ring, rows padded by 32 bytes so that each half-warp's 8-byte stores
//     hit 32 banks (36 KB at BN = 64, 68 KB at BN = 128, of a 192 KB ring);
//     after a 256-thread named barrier each thread pools whole windows, 4
//     channels at a time, by conv_pallas.py::_pool4_first_max's strict
//     comparisons in scan order (w01 = c1 > c0, w23 = c3 > c2, idx = m23 >
//     m01 ? 2 + w23 : w01), so an all-zero window gives idx 0, and stores
//     pooled (16 bytes) and idx (4 bytes) along the channels. Only pooled
//     and idx reach device memory: 5/16 of the bytes the STORE epilogue
//     writes.
//
// What bounds it on an H100: operations. The three products are 3 * 2 *
// 9 * Cin * Cout flops per pixel on the TF32 tensor cores (495 TFLOP/s),
// against 4 * (Cin + Cout) bytes (C: 4 * Cin + 5/4 * Cout). A stage moves
// 48 KB by TMA for 12 wgmma of a warpgroup, twice bf16 K2's bytes per
// product, mostly from L2; the split costs each consumer thread four
// 16-byte shared loads and eight stores per stage. Registers: at BN = 128
// the 64 accumulators and 64 partials of a thread live through the
// mainloop; the pool epilogue adds none that outlive it (the partials are
// dead by then). Persistent scheduling and a deeper ring are later work.
//
// The input gradient is this kernel on the cotangent with spatially
// flipped, IO-transposed weights and a zero bias (conv_pallas.py:468-475).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                          // output pixels per tile
constexpr int BK = 32;                           // f32 channels per slab
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;    // + one producer warp
constexpr int A_BYTES = BM * BK * 4;             // 16 KB
constexpr uint32_t HI_MASK = 0xffffe000u;        // sign, exponent, 10 bits

enum Epilogue { STORE = 0, POOL = 1 };

template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int B_BYTES = BN * BK * 4;
  // A, A_lo, B_hi, B_lo; TMA fills A and both B parts.
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int TMA_BYTES = A_BYTES + 2 * B_BYTES;
  // + 1024: the ring is aligned to 1024 bytes inside the dynamic buffer,
  // as the 128-byte swizzle pattern repeats every 8 rows of 128 bytes.
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

// C's epilogue: relu(acc + bias) in f32, staged in the drained ring,
// pooled 2x2 by whole windows. pooled and idx are (B, H/2, W/2, Cout); the
// tile's rows are (r >> bw_log2, r & (bw - 1)) from (y0, x0).
template <int BN>
__device__ __forceinline__ void pool_epilogue(
    const float (&acc)[BN / 2], uint8_t* stage, const float* __restrict__ bias,
    float* __restrict__ pooled, uint8_t* __restrict__ idx, int b, int x0,
    int y0, int n0, int H, int W, int Cout, int bw_log2) {
  constexpr int ROW = 4 * BN + 32;               // bytes per staged row
  constexpr int CHUNKS = BN / 4;                 // 4-channel runs per pixel
  static_assert(BM * ROW <= Tile<BN>::STAGES * Tile<BN>::STAGE_BYTES,
                "the staged tile fits in the ring");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // Both warpgroups' last wgmma have read the ring (barriers 1 and 2 are
  // the warpgroups' own, in the mainloop).
  named_barrier(3, CONSUMERS * 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nl = 8 * j + 2 * (lane & 3);
    if (n0 + nl >= Cout) continue;
    const float b0 = bias[n0 + nl];
    const float b1 = bias[n0 + nl + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + 16 * warp + 8 * h + (lane >> 2);
      *reinterpret_cast<float2*>(stage + r * ROW + 4 * nl) =
          make_float2(fmaxf(acc[4 * j + 2 * h] + b0, 0.f),
                      fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f));
    }
  }
  named_barrier(3, CONSUMERS * 128);
  // 32 windows of 2 x 2 per tile, BW/2 to a row of windows.
  const int bw = 1 << bw_log2;
  const int Hp = H >> 1, Wp = W >> 1;
  for (int item = threadIdx.x; item < 32 * CHUNKS; item += CONSUMERS * 128) {
    const int chunk = item % CHUNKS;
    const int win = item / CHUNKS;
    const int px = win & ((bw >> 1) - 1), py = win >> (bw_log2 - 1);
    const int n = n0 + 4 * chunk;
    const int yy = y0 + 2 * py, xx = x0 + 2 * px;
    if (n >= Cout || yy >= H || xx >= W) continue;
    // Window positions (0,0), (0,1), (1,0), (1,1): rows r, r+1, r+bw,
    // r+bw+1 of the tile.
    const uint8_t* s = stage + ((2 * py << bw_log2) + 2 * px) * ROW + 16 * chunk;
    const float4 q0 = *reinterpret_cast<const float4*>(s);
    const float4 q1 = *reinterpret_cast<const float4*>(s + ROW);
    const float4 q2 = *reinterpret_cast<const float4*>(s + bw * ROW);
    const float4 q3 = *reinterpret_cast<const float4*>(s + (bw + 1) * ROW);
    const float a0[4] = {q0.x, q0.y, q0.z, q0.w};
    const float a1[4] = {q1.x, q1.y, q1.z, q1.w};
    const float a2[4] = {q2.x, q2.y, q2.z, q2.w};
    const float a3[4] = {q3.x, q3.y, q3.z, q3.w};
    float out[4];
    uint32_t id = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool w01 = a1[k] > a0[k], w23 = a3[k] > a2[k];
      const float m01 = w01 ? a1[k] : a0[k], m23 = w23 ? a3[k] : a2[k];
      const bool wm = m23 > m01;
      out[k] = wm ? m23 : m01;
      id |= (uint32_t)(wm ? 2 + (int)w23 : (int)w01) << (8 * k);
    }
    const long long p = ((long long)b * Hp + (yy >> 1)) * Wp + (xx >> 1);
    *reinterpret_cast<float4*>(pooled + p * Cout + n) =
        make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint32_t*>(idx + p * Cout + n) = id;
  }
}

// One 128 x BN output tile. Threads 0-255: the two consumer warpgroups;
// threads 256-287: the producer warp. EPI = POOL: y is pooled, idx the
// window index, relu is implied.
template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_tf32x3_kernel(__grid_constant__ const CUtensorMap xmap,
                      __grid_constant__ const CUtensorMap whimap,
                      __grid_constant__ const CUtensorMap wlomap,
                      const float* __restrict__ bias, float* __restrict__ y,
                      uint8_t* __restrict__ idx, int H, int W, int Cin,
                      int Cout, int bw_log2, int tiles_x, int tiles_y,
                      int relu) {
  constexpr int STAGES = Tile<BN>::STAGES;
  constexpr int ACC = BN / 2;                    // f32 accumulators a thread
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  // The generic-proxy view of the ring, for the split.
  uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
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
        mbar_expect_tx(full, Tile<BN>::TMA_BYTES);
        const int tap = it / slabs;
        const int c0 = (it - tap * slabs) * BK;
        const uint32_t st = ring + s * Tile<BN>::STAGE_BYTES;
        tma_load_4d(st, &xmap, full, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1,
                    b);
        tma_load_3d(st + 2 * A_BYTES, &whimap, full, c0, tap, n0);
        tma_load_3d(st + 2 * A_BYTES + Tile<BN>::B_BYTES, &wlomap, full, c0,
                    tap, n0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows wg*64 .. wg*64+63 of the tile:
  // the running sum acc and one k-iteration's partial part.
  float acc[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x & 127;
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t st = ring + s * Tile<BN>::STAGE_BYTES;
    // Split this warpgroup's 8 KB half of A: a_hi in place, a_lo into A_lo
    // at the same byte offset (the split is elementwise, so the swizzle
    // carries over).
    uint8_t* const half = ring_ptr + s * Tile<BN>::STAGE_BYTES + wg * 8192;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (i * 128 + tid) * 16;
      float4 v = *reinterpret_cast<const float4*>(half + off);
      float4 hi, lo;
      hi.x = __uint_as_float(__float_as_uint(v.x) & HI_MASK);
      hi.y = __uint_as_float(__float_as_uint(v.y) & HI_MASK);
      hi.z = __uint_as_float(__float_as_uint(v.z) & HI_MASK);
      hi.w = __uint_as_float(__float_as_uint(v.w) & HI_MASK);
      lo.x = v.x - hi.x;
      lo.y = v.y - hi.y;
      lo.z = v.z - hi.z;
      lo.w = v.w - hi.w;
      *reinterpret_cast<float4*>(half + off) = hi;
      *reinterpret_cast<float4*>(half + A_BYTES + off) = lo;
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    const uint32_t a_hi = st + wg * 64 * 128;
    const uint32_t a_lo = a_hi + A_BYTES;
    const uint32_t b_hi = st + 2 * A_BYTES;
    const uint32_t b_lo = b_hi + Tile<BN>::B_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // One k8 step is 32 bytes along the swizzled 128-byte row; the
      // leading offset of a K-major tile is unused (16). The small
      // products go first.
      const uint64_t dah = desc_sw128(a_hi + kk * 32, 16);
      const uint64_t dal = desc_sw128(a_lo + kk * 32, 16);
      const uint64_t dbh = desc_sw128(b_hi + kk * 32, 16);
      const uint64_t dbl = desc_sw128(b_lo + kk * 32, 16);
      if constexpr (BN == 128) {
        wgmma_m64n128k8_tf32(part, dal, dbh);
        wgmma_m64n128k8_tf32(part, dah, dbl);
        wgmma_m64n128k8_tf32(part, dah, dbh);
      } else {
        wgmma_m64n64k8_tf32(part, dal, dbh);
        wgmma_m64n64k8_tf32(part, dah, dbl);
        wgmma_m64n64k8_tf32(part, dah, dbh);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    // The group has read the stage: free it, then fold the partial in. The
    // other consumer warpgroup's wgmma keep the tensor cores busy meanwhile.
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      acc[i] += part[i];
      part[i] = 0.f;
    }
  }

  if constexpr (EPI == POOL) {
    pool_epilogue<BN>(acc, ring_ptr, bias, y, idx, b, x0, y0, n0, H, W, Cout,
                      bw_log2);
    return;
  }
  // Epilogue. Accumulator v of thread (warp w, lane l) of the warpgroup:
  // row 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1).
  const int warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    if (n >= Cout) continue;
    const float b0 = bias[n];
    const float b1 = bias[n + 1];
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
      *reinterpret_cast<float2*>(y + pix * Cout + n) = make_float2(v0, v1);
    }
  }
}

template <int BN, int EPI>
int launch(const CUtensorMap& xmap, const CUtensorMap& whimap,
           const CUtensorMap& wlomap, const void* b, void* y, void* idx, int B,
           int H, int W, int Cin, int Cout, int bw_log2, int relu,
           cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      conv3x3_tf32x3_kernel<BN, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err) return err;
  const int bw = 1 << bw_log2, bh = BM >> bw_log2;
  const int tiles_x = (W + bw - 1) / bw, tiles_y = (H + bh - 1) / bh;
  dim3 grid((unsigned)(B * tiles_x * tiles_y), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_tf32x3_kernel<BN, EPI><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      xmap, whimap, wlomap, (const float*)b, (float*)y, (uint8_t*)idx, H, W,
      Cin, Cout, bw_log2, tiles_x, tiles_y, relu);
  return (int)cudaGetLastError();
}

// Encodes the tensor maps of x and of the two weight parts and launches
// with BN = 64 for Cout <= 64, else 128.
template <int EPI>
int encode_and_launch(const void* x, const void* w_hi, const void* w_lo,
                      const void* b, void* y, void* idx, int B, int H, int W,
                      int Cin, int Cout, int bw_log2, int relu, void* stream) {
  const int bw = 1 << bw_log2;
  const cuuint64_t e = 4;                        // bytes per f32
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, whimap, wlomap;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t xstride[3] = {Cin * e, (cuuint64_t)W * Cin * e,
                                 (cuuint64_t)H * W * Cin * e};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)bw, (cuuint32_t)(BM / bw), 1};
  CUresult r = cuTensorMapEncodeTiled(
      &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), xdim,
      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  const int bn = Cout <= 64 ? 64 : 128;
  r = encode_weights(&whimap, w_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, e, Cin,
                     Cout, BK, bn);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_weights(&wlomap, w_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, e, Cin,
                     Cout, BK, bn);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 64 ? launch<64, EPI>(xmap, whimap, wlomap, b, y, idx, B, H, W,
                                    Cin, Cout, bw_log2, relu, st)
                  : launch<128, EPI>(xmap, whimap, wlomap, b, y, idx, B, H, W,
                                     Cin, Cout, bw_log2, relu, st);
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// x (B, H, W, Cin) f32; w_hi, w_lo (Cout, 3, 3, Cin) f32, the exact split of
// the HWIO weights permuted so that K is innermost (w_hi with its low 13
// mantissa bits clear); b (Cout,) f32; y (B, H, W, Cout) f32. Cin and Cout
// multiples of 4, x and the weights 16-byte aligned; bw the tile's width in
// pixels (a power of two, at most 128; the tile is bw x 128/bw pixels).
// Returns a cudaError_t, or ENCODE_ERROR + the CUresult of a tensor-map
// encoding.
extern "C" int st3d_conv3x3_tf32x3_f32(const void* x, const void* w_hi,
                                       const void* w_lo, const void* b,
                                       void* y, int B, int H, int W, int Cin,
                                       int Cout, int bw, int relu,
                                       void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 0 || bw > BM || Cin % 4 || Cout % 4)
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<STORE>(x, w_hi, w_lo, b, y, nullptr, B, H, W, Cin,
                                  Cout, bw_log2, relu, stream);
}

// C in float32: maxpool2x2(relu(conv3x3_same(x, w) + b)) with the window
// index. x, w_hi, w_lo and b as above; pooled (B, H/2, W/2, Cout) f32 and idx
// (B, H/2, W/2, Cout) uint8; H and W even; bw the tile's width (a power of
// two, 2 to 64: kernels/conv.py::pool_tile). Returns as above.
extern "C" int st3d_conv3x3_relu_pool_tf32x3_f32(const void* x,
                                                 const void* w_hi,
                                                 const void* w_lo,
                                                 const void* b, void* pooled,
                                                 void* idx, int B, int H,
                                                 int W, int Cin, int Cout,
                                                 int bw, void* stream) {
  const int bw_log2 = log2_exact(bw);
  if (bw_log2 < 1 || bw > 64 || H % 2 || W % 2 || Cin % 4 || Cout % 4)
    return (int)cudaErrorInvalidValue;
  return encode_and_launch<POOL>(x, w_hi, w_lo, b, pooled, idx, B, H, W, Cin,
                                 Cout, bw_log2, 1, stream);
}
