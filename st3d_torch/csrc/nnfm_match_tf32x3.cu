// ARF's nearest-neighbour feature matching (NNFM; Zhang et al., "ARF:
// Artistic Radiance Fields", ECCV 2022) on Hopper, in float32: the kernels
// of kernels/nnfm.py, every one named nnfm_*.
//
//   - nnfm_colsum_kernel, nnfm_mean_kernel, nnfm_normalize_kernel: a
//     block's rows (B images of P positions, C channels, NHWC) centred over
//     their own image's positions and normalised,
//       x = f - mean_p f,   fhat = x / (sqrt(|x|^2 + 1e-8) + 1e-8);
//     the per-image channel sums run in fixed slices of SUM_ROWS positions
//     and are added slice by slice in order (no atomics: the same bits on
//     every run);
//   - nnfm_match_tf32x3_kernel + nnfm_merge_kernel: for each row i of
//     fhat (M = B*P rows) the column j of the style's normalised block shat
//     (N rows) with the largest fhat_i . shat_j, and that value, the lowest
//     j on a tie; the M x N similarities are never written;
//   - nnfm_loss_fwd_kernel, nnfm_loss_bwd_kernel: the loss's rows, each
//     reading its matched style row s = unit[nn_i] (the gather) beside f_i
//     and the content row c_i,
//       row_i = a * (1 - f_i . s / (|f_i| + 1e-8)) + b * |f_i - c_i|^2,
//     (a = style_weight / M, b = content_weight / (M C)), and the rows'
//     gradient in f_i, recomputed from the forward's |f_i| and f_i . s.
//
// No TPU kernel: the JAX package has no NNFM loss. The matching is the
// reason for the file: 2 * M * N * C flops, at the reference's 768^2
// renders 2.09 TFLOP a view (P = N = 36,864, C = 768), the most of an
// epoch's work, and its M x N float32 similarities would be 5.4 GB a view.
//
// The matching's numerics: csrc/conv3x3_tf32x3.cu's 3xTF32 split. fhat is
// split in registers (A from registers), shat by the wrapper once a style
// (shat_hi with its low 13 mantissa bits cleared, shat_lo = shat -
// shat_hi); per 32-wide slab of C the 12 wgmma (lo x hi, hi x lo, hi x hi a
// k8 step) sum into a fresh partial that the CUDA cores add to the running
// sum, as the tensor core's own sum over all of C would drift.
//
// Work layout: K2 float32's persistent, warp-specialised mainloop. A work
// item is one tile of BM = 128 rows and one chunk of the columns (whole
// 128-column tiles, kernels/nnfm.py::match_chunks); min(items, SMs) CTAs
// walk items t = CTA, CTA + CTAs, ... with the chunk fastest, so the CTAs
// running at a time hold about SMs / chunks row tiles (13 MB of fhat at
// the cell's 4 chunks, against 52 MB with one chunk and 50 MB of L2) and
// sweep the same style tiles together.
//   - A stage: the row tile's slab (128 rows x 32 floats, 16 KB) and the
//     column tile's shat_hi and shat_lo slabs (16 KB each), by TMA with the
//     128-byte swizzle; 4 stages, the ring running on across column tiles
//     and items.
//   - One producer thread (warp 8; its warpgroup lends its registers,
//     setmaxnreg 40 / 232); two consumer warpgroups of 64 rows each.
//   - After a column tile's 24 slabs (C = 768), each thread folds its 2
//     rows x 32 columns into its running (best value, best column) by
//     strict > in increasing column order, columns past N left out; after
//     the item's last tile the 4 lanes of a row merge (larger value, then
//     lower column) and one writes the item's (value, column) to the
//     (M, chunks) partials. nnfm_merge_kernel takes each row's best over
//     the chunks in order, ties to the lower chunk.
//
// What bounds it on an H100: operations, 3 products of 2 * M * N * C flops
// on the TF32 tensor cores at 495 TFLOP/s (a third of that rate counted
// one product a FLOP, as portbench counts it), against 4 * C * (M + 2 N)
// bytes. Next in line, as in K2, are shared memory (48 KB from TMA and
// 32 KB of wgmma B reads a warpgroup a slab) and L2 (the row tile is read
// again for each column tile). The row kernels are bound by bytes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                          // rows per item
constexpr int BN = 128;                          // columns per tile
constexpr int BK = 32;                           // f32 channels per slab
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int PRODUCER = CONSUMERS * 128;        // the TMA thread
constexpr int THREADS = CONSUMERS * 128 + 128;   // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 4;             // 16 KB
constexpr int B_BYTES = BN * BK * 4;             // 16 KB, each of hi and lo
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int STAGES = (232448 - 2048) / STAGE_BYTES;
// + 1024: the ring is aligned to 1024 bytes, as the 128-byte swizzle
// pattern repeats every 8 rows of 128 bytes.
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int NO_COLUMN = 0x7fffffff;
constexpr uint32_t MINUS_INF = 0xff800000u;       // -inf's bits

constexpr int SUM_ROWS = 256;                    // positions per column sum
constexpr int ROW_WARPS = 8;                     // rows per row-kernel block

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (value, column) b replaces a if larger, or equal at a lower column.
__device__ __forceinline__ void take_better(float& av, int& ai, float bv,
                                            int bi) {
  if (bv > av || (bv == av && bi < ai)) {
    av = bv;
    ai = bi;
  }
}

// One slab of warpgroup wg on the stage at st (a: its generic address):
// conv3x3_tf32x3.cu's k_iteration at BN = 128. This thread's A fragments
// of the 4 k8 steps (row r, float column c of the swizzled A tile at
// r * 128 + (((c / 4) ^ (r % 8)) << 4) + 4 * (c % 4)), split into tf32 hi
// and lo in registers; 12 wgmma into the partial p, the first overwriting
// it; waited for, so that the fragments stay live until read.
__device__ __forceinline__ void slab(float (&p)[BN / 2], uint32_t st,
                                     const uint8_t* a, int wg) {
  const int lane = threadIdx.x & 31;
  const int r0 = wg * 64 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + 8 * (v & 1);
      const float x = *reinterpret_cast<const float*>(
          a + r * 128 + (((2 * kk + (v >> 1)) ^ (lane >> 2)) << 4) +
          4 * (lane & 3));
      split_tf32(x, ahi[kk][v], alo[kk][v]);
    }
    fence_regs(ahi[kk]);
    fence_regs(alo[kk]);
  }
  const uint32_t b_hi = st + A_BYTES;
  const uint32_t b_lo = b_hi + B_BYTES;
  fence_acc(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint64_t dbh = desc_sw128(b_hi + kk * 32, 16);
    const uint64_t dbl = desc_sw128(b_lo + kk * 32, 16);
    wgmma_m64n128k8_tf32_rs(p, alo[kk], dbh, kk > 0);
    wgmma_m64n128k8_tf32_rs(p, ahi[kk], dbl);
    wgmma_m64n128k8_tf32_rs(p, ahi[kk], dbh);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(p);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    fence_regs(ahi[kk]);
    fence_regs(alo[kk]);
  }
}

// Threads 0-255: the two consumer warpgroups; 256: the TMA producer.
// part_val / part_idx: (M, chunks), each row's best of each chunk.
__global__ void __launch_bounds__(THREADS, 1)
nnfm_match_tf32x3_kernel(__grid_constant__ const CUtensorMap fmap,
                         __grid_constant__ const CUtensorMap shimap,
                         __grid_constant__ const CUtensorMap slomap,
                         float* __restrict__ part_val,
                         int* __restrict__ part_idx, int M, int N, int K,
                         int chunks, int chunk_tiles, int items) {
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[STAGES]);
  const int slabs = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN;

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
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      uint32_t g = 0;                            // ring position
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int m0 = (t / chunks) * BM;
        const int c = t % chunks;
        const int nt1 = min(n_tiles, (c + 1) * chunk_tiles);
        for (int nt = c * chunk_tiles; nt < nt1; ++nt) {
          for (int it = 0; it < slabs; ++it, ++g) {
            const int s = g % STAGES;
            mbar_wait(empty0 + 8 * s, ((g / STAGES) & 1) ^ 1);
            const uint32_t full = full0 + 8 * s;
            mbar_expect_tx(full, STAGE_BYTES);
            const uint32_t st = ring + s * STAGE_BYTES;
            tma_load_2d(st, &fmap, full, it * BK, m0);
            tma_load_2d(st + A_BYTES, &shimap, full, it * BK, nt * BN);
            tma_load_2d(st + A_BYTES + B_BYTES, &slomap, full, it * BK,
                        nt * BN);
          }
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  float acc[BN / 2], p[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) p[i] = 0.f;
  uint32_t g = 0;                                // ring position
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int m0 = (t / chunks) * BM;
    const int c = t % chunks;
    const int nt1 = min(n_tiles, (c + 1) * chunk_tiles);
    // This thread's rows r0 (h = 0) and r0 + 8 (h = 1) of the tile.
    float best[2] = {__uint_as_float(MINUS_INF),
                     __uint_as_float(MINUS_INF)};
    int col[2] = {NO_COLUMN, NO_COLUMN};
    for (int nt = c * chunk_tiles; nt < nt1; ++nt) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int it = 0; it < slabs; ++it, ++g) {
        const int s = g % STAGES;
        mbar_wait(full0 + 8 * s, (g / STAGES) & 1);
        slab(p, ring + s * STAGE_BYTES, ring_ptr + s * STAGE_BYTES, wg);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += p[i];
      }
      // Accumulator v: row 8*((v >> 1) & 1) past r0, column 8*(v >> 2) +
      // 2*(lane & 3) + (v & 1) of the tile: increasing in v for each row.
      const int n0 = nt * BN + 2 * (lane & 3);
#pragma unroll
      for (int v = 0; v < BN / 2; ++v) {
        const int h = (v >> 1) & 1;
        const int j = n0 + 8 * (v >> 2) + (v & 1);
        if (j < N && acc[v] > best[h]) {
          best[h] = acc[v];
          col[h] = j;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[h], o);
        const int oi = __shfl_xor_sync(0xffffffffu, col[h], o);
        take_better(best[h], col[h], ov, oi);
      }
      const int row = m0 + wg * 64 + 16 * warp + 8 * h + (lane >> 2);
      if ((lane & 3) == 0 && row < M) {
        part_val[(long long)row * chunks + c] = best[h];
        part_idx[(long long)row * chunks + c] = col[h];
      }
    }
  }
}

// Each row's best over its chunks, in chunk order (ties to the lower
// column); a row with no finite score gets column 0 and a NaN value.
__global__ void nnfm_merge_kernel(const float* __restrict__ part_val,
                                  const int* __restrict__ part_idx,
                                  int* __restrict__ idx,
                                  float* __restrict__ val, int M,
                                  int chunks) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  float bv = part_val[row * chunks];
  int bi = part_idx[row * chunks];
  for (int c = 1; c < chunks; ++c)
    take_better(bv, bi, part_val[row * chunks + c],
                part_idx[row * chunks + c]);
  if (bi == NO_COLUMN) {
    bi = 0;
    bv = __int_as_float(0x7fc00000);
  }
  idx[row] = bi;
  val[row] = bv;
}

// Channel sums of positions [r * SUM_ROWS, (r + 1) * SUM_ROWS) of image b:
// grid (R, B), partial (B, R, C).
__global__ void nnfm_colsum_kernel(const float* __restrict__ f,
                                   float* __restrict__ partial, int P, int C,
                                   int R) {
  const int b = blockIdx.y, r = blockIdx.x;
  const int p0 = r * SUM_ROWS, p1 = min(P, p0 + SUM_ROWS);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* src = f + ((long long)b * P + p0) * C + c;
    float s = 0.f;
    for (int p = p0; p < p1; ++p, src += C) s += *src;
    partial[((long long)b * R + r) * C + c] = s;
  }
}

// mean (B, C): the R partial sums of each image in order, over P.
__global__ void nnfm_mean_kernel(const float* __restrict__ partial,
                                 float* __restrict__ mean, int P, int C,
                                 int R) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* src = partial + (long long)b * R * C + c;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += src[(long long)r * C];
    mean[(long long)b * C + c] = s / (float)P;
  }
}

// One warp a row: out = (f - mean) / (sqrt(|f - mean|^2 + 1e-8) + 1e-8).
__global__ void nnfm_normalize_kernel(const float* __restrict__ f,
                                      const float* __restrict__ mean,
                                      float* __restrict__ out, int B, int P,
                                      int C) {
  const long long row =
      (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * P) return;
  const float4* x = reinterpret_cast<const float4*>(f + row * C);
  const float4* m = reinterpret_cast<const float4*>(mean + (row / P) * C);
  float4* y = reinterpret_cast<float4*>(out + row * C);
  float ss = 0.f;
  for (int k = lane; k < C / 4; k += 32) {
    const float4 a = x[k], b = m[k];
    const float4 d = make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
    ss += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
  }
  const float den = sqrtf(warp_sum(ss) + 1e-8f) + 1e-8f;
  for (int k = lane; k < C / 4; k += 32) {
    const float4 a = x[k], b = m[k];
    y[k] = make_float4((a.x - b.x) / den, (a.y - b.y) / den,
                       (a.z - b.z) / den, (a.w - b.w) / den);
  }
}

// One warp a row: stats (M, 2) = (|f|, f . s) and the row's loss, s the
// matched style row unit[nn[row]].
__global__ void nnfm_loss_fwd_kernel(const float* __restrict__ f,
                                     const float* __restrict__ unit,
                                     const float* __restrict__ content,
                                     const int* __restrict__ nn,
                                     float* __restrict__ stats,
                                     float* __restrict__ rows, int M, int C,
                                     float a, float b) {
  const long long row =
      (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float4* x = reinterpret_cast<const float4*>(f + row * C);
  const float4* s =
      reinterpret_cast<const float4*>(unit + (long long)nn[row] * C);
  const float4* q = reinterpret_cast<const float4*>(content + row * C);
  float ff = 0.f, fs = 0.f, dd = 0.f;
  for (int k = lane; k < C / 4; k += 32) {
    const float4 u = x[k], v = s[k], w = q[k];
    ff += u.x * u.x + u.y * u.y + u.z * u.z + u.w * u.w;
    fs += u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
    const float4 d = make_float4(u.x - w.x, u.y - w.y, u.z - w.z, u.w - w.w);
    dd += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
  }
  ff = warp_sum(ff);
  fs = warp_sum(fs);
  dd = warp_sum(dd);
  if (lane == 0) {
    const float n = sqrtf(ff);
    stats[2 * row] = n;
    stats[2 * row + 1] = fs;
    rows[row] = a * (1.f - fs / (n + 1e-8f)) + b * dd;
  }
}

// One warp a row: df = g * (a * d(1 - cos)/df + b * 2 (f - c)), with
// d(1 - cos)/df = -s / d + (f . s) f / (d^2 |f|), d = |f| + 1e-8.
__global__ void nnfm_loss_bwd_kernel(const float* __restrict__ f,
                                     const float* __restrict__ unit,
                                     const float* __restrict__ content,
                                     const int* __restrict__ nn,
                                     const float* __restrict__ stats,
                                     const float* __restrict__ grad,
                                     float* __restrict__ df, int M, int C,
                                     float a, float b) {
  const long long row =
      (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float g = grad[row];
  const float n = stats[2 * row], fs = stats[2 * row + 1];
  const float d = n + 1e-8f;
  const float cs = -a * g / d;
  const float cf = n > 0.f ? a * g * fs / (d * d * n) : 0.f;
  const float cc = 2.f * b * g;
  const float4* x = reinterpret_cast<const float4*>(f + row * C);
  const float4* s =
      reinterpret_cast<const float4*>(unit + (long long)nn[row] * C);
  const float4* q = reinterpret_cast<const float4*>(content + row * C);
  float4* y = reinterpret_cast<float4*>(df + row * C);
  for (int k = lane; k < C / 4; k += 32) {
    const float4 u = x[k], v = s[k], w = q[k];
    y[k] = make_float4(cs * v.x + cf * u.x + cc * (u.x - w.x),
                       cs * v.y + cf * u.y + cc * (u.y - w.y),
                       cs * v.z + cf * u.z + cc * (u.z - w.z),
                       cs * v.w + cf * u.w + cc * (u.w - w.w));
  }
}

// The tensor map of a (rows, K) float32 matrix, K innermost, with the box
// (BK, box_rows) and the 128-byte swizzle: K-major wgmma tiles.
CUresult encode_rows(CUtensorMap* map, const void* t, int rows, int K,
                     int box_rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(t), dim,
      stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

unsigned row_blocks(long long rows) {
  return (unsigned)((rows + ROW_WARPS - 1) / ROW_WARPS);
}

}  // namespace

// f (B, P, C) float32, C a multiple of 4, 16-byte aligned; partial (B, R,
// C) float32 scratch with R = ceil(P / 256); mean (B, C); out (B, P, C).
// Returns a cudaError_t.
extern "C" int st3d_nnfm_normalize_f32(const void* f, void* partial,
                                       void* mean, void* out, int B, int P,
                                       int C, void* stream) {
  if (C % 4 || B <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int R = (P + SUM_ROWS - 1) / SUM_ROWS;
  nnfm_colsum_kernel<<<dim3((unsigned)R, (unsigned)B), 256, 0, st>>>(
      (const float*)f, (float*)partial, P, C, R);
  int err = (int)cudaGetLastError();
  if (err) return err;
  nnfm_mean_kernel<<<(unsigned)B, 256, 0, st>>>((const float*)partial,
                                                (float*)mean, P, C, R);
  err = (int)cudaGetLastError();
  if (err) return err;
  nnfm_normalize_kernel<<<row_blocks((long long)B * P), 32 * ROW_WARPS, 0,
                          st>>>((const float*)f, (const float*)mean,
                                (float*)out, B, P, C);
  return (int)cudaGetLastError();
}

// fhat (M, K), s_hi and s_lo (N, K) float32, K a multiple of 4, 16-byte
// aligned; part_val (M, chunks) float32 and part_idx (M, chunks) int32
// scratch; idx (M,) int32 and val (M,) float32 out. The columns are cut
// into chunks of chunk_tiles 128-column tiles, chunks = ceil(ceil(N / 128)
// / chunk_tiles). Returns a cudaError_t, or ENCODE_ERROR + the CUresult of
// a tensor-map encoding.
extern "C" int st3d_nnfm_match_tf32x3_f32(const void* fhat, const void* s_hi,
                                          const void* s_lo, void* part_val,
                                          void* part_idx, void* idx,
                                          void* val, int M, int N, int K,
                                          int chunks, int chunk_tiles,
                                          void* stream) {
  const int n_tiles = (N + BN - 1) / BN;
  if (K % 4 || M <= 0 || N <= 0 || chunk_tiles <= 0 ||
      chunks != (n_tiles + chunk_tiles - 1) / chunk_tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap fmap, shimap, slomap;
  CUresult r = encode_rows(&fmap, fhat, M, K, BM);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_rows(&shimap, s_hi, N, K, BN);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_rows(&slomap, s_lo, N, K, BN);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      nnfm_match_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err) return err;
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  const int items = ((M + BM - 1) / BM) * chunks;
  cudaStream_t st = (cudaStream_t)stream;
  nnfm_match_tf32x3_kernel<<<items < sms ? items : sms, THREADS, SMEM, st>>>(
      fmap, shimap, slomap, (float*)part_val, (int*)part_idx, M, N, K, chunks,
      chunk_tiles, items);
  err = (int)cudaGetLastError();
  if (err) return err;
  nnfm_merge_kernel<<<(unsigned)((M + 255) / 256), 256, 0, st>>>(
      (const float*)part_val, (const int*)part_idx, (int*)idx, (float*)val, M,
      chunks);
  return (int)cudaGetLastError();
}

// f, content (M, C), unit (N, C) float32, C a multiple of 4, 16-byte
// aligned; nn (M,) int32 in [0, N); stats (M, 2) and rows (M,) float32 out.
extern "C" int st3d_nnfm_loss_fwd_f32(const void* f, const void* unit,
                                      const void* content, const void* nn,
                                      void* stats, void* rows, int M, int C,
                                      float a, float b, void* stream) {
  if (C % 4 || M <= 0) return (int)cudaErrorInvalidValue;
  nnfm_loss_fwd_kernel<<<row_blocks(M), 32 * ROW_WARPS, 0,
                         (cudaStream_t)stream>>>(
      (const float*)f, (const float*)unit, (const float*)content,
      (const int*)nn, (float*)stats, (float*)rows, M, C, a, b);
  return (int)cudaGetLastError();
}

// As the forward, with the forward's stats, the rows' gradient grad (M,)
// and df (M, C) float32 out.
extern "C" int st3d_nnfm_loss_bwd_f32(const void* f, const void* unit,
                                      const void* content, const void* nn,
                                      const void* stats, const void* grad,
                                      void* df, int M, int C, float a,
                                      float b, void* stream) {
  if (C % 4 || M <= 0) return (int)cudaErrorInvalidValue;
  nnfm_loss_bwd_kernel<<<row_blocks(M), 32 * ROW_WARPS, 0,
                         (cudaStream_t)stream>>>(
      (const float*)f, (const float*)unit, (const float*)content,
      (const int*)nn, (const float*)stats, (const float*)grad, (float*)df, M,
      C, a, b);
  return (int)cudaGetLastError();
}
