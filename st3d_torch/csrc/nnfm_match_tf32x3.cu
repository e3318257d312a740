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
//     gradient in f_i, recomputed from the forward's |f_i| and f_i . s;
//   - nnfm_filter_tf32_kernel, nnfm_rescore_kernel, nnfm_fallback_kernel:
//     the matching's answer from one product a pair ("The certified
//     matching", below).
//
// No TPU kernel: the JAX package has no NNFM loss. The matching is the
// reason for the file: 2 * M * N * C flops, at the reference's 768^2
// renders 2.09 TFLOP a view (P = N = 36,864, C = 768), the most of an
// epoch's work, and its M x N float32 similarities would be 5.4 GB a view.
//
// The matching's numerics: csrc/conv3x3_tf32x3.cu's 3xTF32 split. fhat is
// split in registers (A from registers), shat by the wrapper once a style
// (shat_hi the nearest tf32 value, shat_lo = shat - shat_hi;
// kernels/nnfm.py::split_tf32_nearest); per 32-wide slab of C the 12 wgmma (lo x hi, hi x lo, hi x hi a
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
// The certified matching (kernels/nnfm.py::match; nnfm_filter_tf32_kernel,
// nnfm_rescore_kernel, nnfm_fallback_kernel): one tf32 product a pair,
// then float64 scores only where the answer could be.
//   - Filter: the mainloop above with one wgmma a k8 step, A_hi x B_hi
//     (shat_lo is not loaded), accumulated by the tensor core over all of
//     K, on 256-column tiles (kernels/nnfm.py::FILTER_TILE): H_ij. Each
//     row keeps a running max of H and the columns within 2 eps_i of it,
//     in lists of LIST slots a lane; a full list goes to the row's list in
//     global memory (CAP uint16 columns, a count cnt past CAP marks the
//     row, and the flush that marks it stops the row's inserts, so that a
//     row with thousands of near-equal columns, as a flat style region
//     gives, costs the filter no more than CAP of them). The row's chunks
//     share their maxima, and the mark, through rmax (atomicMax of ordered
//     bits) once a column tile.
//   - Re-score: one warp a row, each listed column's float64 score
//     S_ij = sum_k fhat_ik shat_jk (float32 products exact in float64);
//     the answer is the column of the largest float32-rounded S, the
//     lowest on a tie, and that value.
//   - Fallback: a marked row is scored against every column the same way
//     on the CUDA cores (nnfm_fallback_kernel, two columns a thread); no
//     step waits on the host.
// The bound. Write a = fhat_i = a_hi + a_lo and b = shat_j = b_hi + b_lo
// (the tf32 split to nearest: |lo| at most half a tf32 step, so the bound
// below, and the candidates within twice it of a row's best, are half what
// truncation's split gives), E = a . b exactly. Then
//   |H - E| <= |H - a_hi . b_hi| + |a_lo . b_hi| + |a_hi . b_lo|
//              + |a_lo . b_lo|
//           <= acc + |a_lo| Bhi + |a_hi| Blo + |a_lo| Blo    (Cauchy-Schwarz)
// with Bhi, Blo bounds on max_j |b_hi|, |b_lo| (kernels/nnfm.py's
// style_norms, once a style, raised by 2^-12 over their float32 sums)
// and acc the tensor core's error in summing the exact tf32 products:
// each k8 step of a wgmma sums 9 terms of magnitude at most
// |a_hi| Bhi in total, aligned and truncated to float32, which costs
// at most about 11 units of 2^-24 of that total; acc = (K / 8) * 2^-20 *
// |a_hi| Bhi allows 16. The answer compares R_j = fl32(S_j), and
// |R_j - E_j| <= 2^-24 |E_j| + K 2^-53 |a| |b| <= d = 2^-22 (|a_hi| +
// |a_lo|)(Bhi + Blo). So with eps_i = the sum of the four terms and d,
// raised by 2^-12 for the float32 arithmetic of the bound and of the row's
// norms: if the answer is column w and m is any column,
//   H_w >= E_w - eps + d >= R_w - eps >= R_m - eps >= E_m - eps - d
//       >= H_m - 2 eps,
// so w is never below max_m H_im - 2 eps_i: a column dropped there loses
// to m. The running max is some H_im, so dropping against it on the way
// is as safe. A row's norms come from the A fragments of its first column
// tile, summed over its 4 lanes.
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

// ---------------------------------------------------------------------------
// The certified matching: one hi x hi product for every pair, float64
// scores only for the columns that could win.
// ---------------------------------------------------------------------------

constexpr int FBN = 256;                                   // filter columns
constexpr int F_STAGE_BYTES = A_BYTES + FBN * BK * 4;        // 48 KB
constexpr int F_STAGES = (232448 - 2048) / F_STAGE_BYTES;    // 4
constexpr int F_SMEM = F_STAGES * F_STAGE_BYTES + 1024;
constexpr int LIST = 8;        // a lane's live candidates of one row
constexpr int CAP = 64;        // a row's candidate columns (uint16)
constexpr uint32_t DEAD = 0xffffffffu;  // rmax of a row past CAP (no float's)
constexpr int FB_ROWS = 16;    // fallback rows a block scores at a time
constexpr int FB_THREADS = 256;              // a fallback block's threads
constexpr int FB_COLS = 2 * FB_THREADS;      // its columns, two a thread
constexpr int FB_K = 32;       // channels a fallback stage holds

// A float's bits in an order that unsigned comparison follows; 0 lies
// below every value (the cleared scratch's "nothing yet").
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A column's key: its float64 score rounded to float32 in the high word,
// then the lower column first; 0 (a NaN score) loses to every key.
__device__ __forceinline__ unsigned long long score_key(double s, int j) {
  const float f = __double2float_rn(s);
  if (f != f) return 0ull;
  return ((unsigned long long)ordered(f) << 32) | (0xffffffffu - (uint32_t)j);
}
__device__ __forceinline__ void key_out(unsigned long long key, int* idx,
                                        float* val, int row) {
  idx[row] = key ? (int)(0xffffffffu - (uint32_t)key) : 0;
  val[row] = key ? unordered((uint32_t)(key >> 32))
                 : __int_as_float(0x7fc00000);
}

// The filter's A fragments of one slab: this thread's (as slab() reads
// them) rounded to the nearest tf32 value, ties away from zero
// (kernels/nnfm.py::split_tf32_nearest, as the style's hi is made); with
// norms, their |hi|^2 and |lo|^2 added to nh, nl (fragment v is row r0 +
// 8 (v & 1)).
__device__ __forceinline__ void load_hi(uint32_t (&ahi)[BK / 8][4],
                                        const uint8_t* a, int wg, bool norms,
                                        float (&nh)[2], float (&nl)[2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = wg * 64 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + 8 * (v & 1);
      const float x = *reinterpret_cast<const float*>(
          a + r * 128 + (((2 * kk + (v >> 1)) ^ (lane >> 2)) << 4) +
          4 * (lane & 3));
      const float h =
          __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
      ahi[kk][v] = __float_as_uint(h);
      if (norms) {
        const float l = x - h;
        nh[v & 1] = fmaf(h, h, nh[v & 1]);
        nl[v & 1] = fmaf(l, l, nl[v & 1]);
      }
    }
    fence_regs(ahi[kk]);
  }
}

// One slab of the filter on the stage at st (a: its generic address): the
// fragments, 4 wgmma m64n256 hi x hi into acc (the first overwriting it
// unless accumulate), waited for.
template <int NB>
__device__ __forceinline__ void hi_slab(float (&acc)[NB / 2], uint32_t st,
                                        const uint8_t* a, int wg,
                                        bool accumulate, bool norms,
                                        float (&nh)[2], float (&nl)[2]) {
  uint32_t ahi[BK / 8][4];
  load_hi(ahi, a, wg, norms, nh, nl);
  const uint32_t b_hi = st + A_BYTES;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    if constexpr (NB == 256)
      wgmma_m64n256k8_tf32_rs(acc, ahi[kk], desc_sw128(b_hi + kk * 32, 16),
                              accumulate || kk > 0);
    else
      wgmma_m64n128k8_tf32_rs(acc, ahi[kk], desc_sw128(b_hi + kk * 32, 16),
                              accumulate || kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) fence_regs(ahi[kk]);
}

// r[i] by a tree of N - 1 selects on the bits of i (r indexed statically,
// so that it stays in registers).
template <int N>
__device__ __forceinline__ float tree_pick(const float (&r)[N], int i) {
  if constexpr (N == 1) {
    return r[0];
  } else {
    float half[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k)
      half[k] = (i & (N / 2)) ? r[k + N / 2] : r[k];
    return tree_pick<N / 2>(half, i);
  }
}

// A lane's live candidates of one row go to the row's list: cnt[row]
// counts every column written, so a count past CAP marks the row. The
// flush that takes the count past CAP also sets rmax[row] to DEAD, which
// stops the row's other lanes and chunks at their next exchange; it
// returns true, and the lane takes no more of the row's columns.
__device__ __forceinline__ bool flush_list(float (&lv)[LIST], int (&lc)[LIST],
                                           int row, unsigned* cnt,
                                           uint16_t* cols, unsigned* rmax) {
  const unsigned base = atomicAdd(&cnt[row], (unsigned)LIST);
#pragma unroll
  for (int s = 0; s < LIST; ++s) {
    if (base + s < CAP) cols[(long long)row * CAP + base + s] = (uint16_t)lc[s];
    lv[s] = __uint_as_float(MINUS_INF);
  }
  if (base + LIST <= CAP) return false;
  atomicMax(&rmax[row], DEAD);
  return true;
}

// Column j of H value x joins a lane's list in the first slot whose value
// has fallen below the threshold (an empty slot holds -inf); with none,
// the list is flushed first. Returns true once the row has overflowed.
__device__ __forceinline__ bool take_candidate(float (&lv)[LIST],
                                               int (&lc)[LIST], float x,
                                               int j, float thr, int row,
                                               unsigned* cnt, uint16_t* cols,
                                               unsigned* rmax) {
  bool placed = false;
#pragma unroll
  for (int s = 0; s < LIST; ++s) {
    if (!placed && lv[s] < thr) {
      lv[s] = x;
      lc[s] = j;
      placed = true;
    }
  }
  if (placed) return false;
  const bool dead = flush_list(lv, lc, row, cnt, cols, rmax);
  lv[0] = x;
  lc[0] = j;
  return dead;
}

// The filter pass. nnfm_match_tf32x3_kernel's persistent, warp-specialised
// mainloop and work items with one product a k8 step, A_hi x B_hi (B_lo is
// not loaded), accumulated by the tensor core over all of K, on column
// tiles of FBN = 256 (each warpgroup m64n256): 48 KB from L2 a slab for
// twice the products of a 128-column slab's 32 KB. A row's bound
// eps (the file's header) comes from its A fragments in the item's first
// column tile. After each tile a row's 4 lanes take the tile's max, add
// it to the row's running max `top` and to rmax[row] (atomicMax of the
// ordered bits, shared by the row's chunks), whose earlier value returns
// for the next tile; each H >= top - 2 eps joins the lane's list. At the
// item's end the lanes append their entries still above the final
// threshold to the row's list (cnt, cols).
__global__ void __launch_bounds__(THREADS, 1)
nnfm_filter_tf32_kernel(__grid_constant__ const CUtensorMap fmap,
                        __grid_constant__ const CUtensorMap shimap,
                        const float* __restrict__ norms,
                        unsigned* __restrict__ rmax,
                        unsigned* __restrict__ cnt,
                        uint16_t* __restrict__ cols, int M, int N, int K,
                        int chunks, int chunk_tiles, int items) {
  __shared__ __align__(8) uint64_t bars[2 * F_STAGES];  // full, then empty
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[F_STAGES]);
  const int slabs = (K + BK - 1) / BK;
  const int n_tiles = (N + FBN - 1) / FBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMERS) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      uint32_t g = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int m0 = (t / chunks) * BM;
        const int c = t % chunks;
        const int nt1 = min(n_tiles, (c + 1) * chunk_tiles);
        for (int nt = c * chunk_tiles; nt < nt1; ++nt) {
          for (int it = 0; it < slabs; ++it, ++g) {
            const int s = g % F_STAGES;
            mbar_wait(empty0 + 8 * s, ((g / F_STAGES) & 1) ^ 1);
            const uint32_t full = full0 + 8 * s;
            mbar_expect_tx(full, F_STAGE_BYTES);
            const uint32_t st = ring + s * F_STAGE_BYTES;
            tma_load_2d(st, &fmap, full, it * BK, m0);
            tma_load_2d(st + A_BYTES, &shimap, full, it * BK, nt * FBN);
          }
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const float bhi = norms[0], blo = norms[1];
  const float acc_bound = (float)(slabs * (BK / 8)) * 0x1p-20f;
  const float inf = __uint_as_float(0x7f800000u);
  float acc[FBN / 2];
  uint32_t g = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int m0 = (t / chunks) * BM;
    const int c = t % chunks;
    const int nt0 = c * chunk_tiles;
    const int nt1 = min(n_tiles, nt0 + chunk_tiles);
    int row[2];
    float top[2], twice[2], thr[2], nh[2] = {0.f, 0.f}, nl[2] = {0.f, 0.f};
    uint32_t seen[2] = {0u, 0u};
    bool dead[2] = {false, false};
    float lv[2][LIST];
    int lc[2][LIST];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = m0 + wg * 64 + 16 * warp + 8 * h + (lane >> 2);
      top[h] = -inf;
      twice[h] = 0.f;
#pragma unroll
      for (int s = 0; s < LIST; ++s) {
        lv[h][s] = -inf;
        lc[h][s] = 0;
      }
    }
    for (int nt = nt0; nt < nt1; ++nt) {
      const bool first = nt == nt0;
      __syncwarp();      // converged for the wgmma after the lists' branches
      for (int it = 0; it < slabs; ++it, ++g) {
        const int s = g % F_STAGES;
        mbar_wait(full0 + 8 * s, (g / F_STAGES) & 1);
        hi_slab<FBN>(acc, ring + s * F_STAGE_BYTES,
                     ring_ptr + s * F_STAGE_BYTES, wg, it > 0, first, nh, nl);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
      if (first) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            nh[h] += __shfl_xor_sync(0xffffffffu, nh[h], o, 4);
            nl[h] += __shfl_xor_sync(0xffffffffu, nl[h], o, 4);
          }
          const float ah = sqrtf(nh[h]), al = sqrtf(nl[h]);
          const float eps = (al * bhi + ah * blo + al * blo +
                             acc_bound * ah * bhi +
                             0x1p-22f * (ah + al) * (bhi + blo)) *
                            (1.f + 0x1p-12f);
          twice[h] = 2.f * eps;
        }
      }
      // Accumulator v: row 8*((v >> 1) & 1) past r0, column 8*(v >> 2) +
      // 2*(lane & 3) + (v & 1) of the tile.
      const int n0 = nt * FBN + 2 * (lane & 3);
      float tm[2] = {-inf, -inf};
#pragma unroll
      for (int v = 0; v < FBN / 2; ++v) {
        const int j = n0 + 8 * (v >> 2) + (v & 1);
        if (j < N) tm[(v >> 1) & 1] = fmaxf(tm[(v >> 1) & 1], acc[v]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1)
          tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], o, 4));
        // The rows' other chunks, as of the last exchange (NaN if none or
        // DEAD).
        const uint32_t code = __shfl_sync(0xffffffffu, seen[h], 0, 4);
        dead[h] = dead[h] || code == DEAD;
        top[h] = fmaxf(fmaxf(top[h], tm[h]), unordered(code));
        thr[h] = row[h] < M && !dead[h] ? top[h] - twice[h] : inf;
        if ((lane & 3) == 0 && row[h] < M)
          seen[h] = atomicMax(&rmax[row[h]], ordered(top[h]));
      }
      // The values above a row's threshold as a bit mask, then one insert
      // a set bit, its value picked by a select tree: the insert's code
      // appears once a row, not once a value.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float r[FBN / 4];
        unsigned long long mask = 0ull;
#pragma unroll
        for (int i = 0; i < FBN / 4; ++i) {
          r[i] = acc[4 * (i >> 1) + 2 * h + (i & 1)];
          const int j = n0 + 8 * (i >> 1) + (i & 1);
          if (j < N && r[i] >= thr[h]) mask |= 1ull << i;
        }
        while (mask) {
          const int i = __ffsll((long long)mask) - 1;
          mask &= mask - 1;
          if (take_candidate(lv[h], lc[h], tree_pick<FBN / 4>(r, i),
                             n0 + 8 * (i >> 1) + (i & 1), thr[h], row[h], cnt,
                             cols, rmax)) {
            dead[h] = true;
            thr[h] = inf;
            mask = 0ull;
          }
        }
        // Reconverged here: a warp left diverged by the lanes' inserts
        // runs the rest of the epilogue once a branch (about a tenth more
        // filter time on the cell's features, measured).
        __syncwarp();
      }
    }
    // The item's end: the final threshold from the row's other chunks, then
    // each lane's entries above it appended to the row's list in one run
    // per row (an exclusive sum over the row's 4 lanes).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row[h] < M;
      uint32_t code = 0u;
      if ((lane & 3) == 0 && live)
        code = atomicMax(&rmax[row[h]], ordered(top[h]));
      code = __shfl_sync(0xffffffffu, code, 0, 4);
      const float t_end = live && !dead[h] && code != DEAD
                              ? fmaxf(top[h], unordered(code)) - twice[h]
                              : inf;
      int k = 0;
#pragma unroll
      for (int s = 0; s < LIST; ++s) k += lv[h][s] >= t_end;
      int incl = k;
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o, 4);
        if ((lane & 3) >= o) incl += u;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
      unsigned base = 0u;
      if ((lane & 3) == 0 && total > 0)
        base = atomicAdd(&cnt[row[h]], (unsigned)total);
      unsigned w = __shfl_sync(0xffffffffu, base, 0, 4) + (incl - k);
#pragma unroll
      for (int s = 0; s < LIST; ++s) {
        if (lv[h][s] >= t_end) {
          if (w < CAP) cols[(long long)row[h] * CAP + w] = (uint16_t)lc[h][s];
          ++w;
        }
      }
    }
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_max_key(
    unsigned long long k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, k, o);
    k = u > k ? u : k;
  }
  return k;
}

// One warp a row: a row whose list holds at most CAP columns takes the
// best of them by float64 scores (each lane's products in channel order,
// then the warp's tree), rounded to float32, the lower column on a tie; a
// row past CAP goes to the fallback's list with its key cleared. stats,
// if given: (pairs re-scored, rows scored in full) added.
__global__ void nnfm_rescore_kernel(const float* __restrict__ fhat,
                                    const float* __restrict__ shat,
                                    const unsigned* __restrict__ cnt,
                                    uint16_t* __restrict__ cols,
                                    int* __restrict__ fb_rows,
                                    unsigned* __restrict__ fb_count,
                                    int* __restrict__ idx,
                                    float* __restrict__ val,
                                    unsigned long long* __restrict__ stats,
                                    int M, int C) {
  __shared__ unsigned long long block_stats[2];
  if (threadIdx.x < 2) block_stats[threadIdx.x] = 0ull;
  __syncthreads();
  const long long row =
      (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row < M) {
    const unsigned n = cnt[row];
    uint16_t* list = cols + row * CAP;
    if (n > CAP) {
      if (lane == 0) {
        fb_rows[atomicAdd(fb_count, 1u)] = (int)row;
        *reinterpret_cast<unsigned long long*>(list) = 0ull;
        if (stats) atomicAdd(&block_stats[1], 1ull);
      }
    } else {
      const float4* a = reinterpret_cast<const float4*>(fhat + row * C);
      unsigned long long best = 0ull;
      for (unsigned s = 0; s < n; ++s) {
        const int j = list[s];
        const float4* b =
            reinterpret_cast<const float4*>(shat + (long long)j * C);
        double d = 0.0;
        for (int k = lane; k < C / 4; k += 32) {
          const float4 x = a[k], y = b[k];
          d = fma((double)x.x, (double)y.x, d);
          d = fma((double)x.y, (double)y.y, d);
          d = fma((double)x.z, (double)y.z, d);
          d = fma((double)x.w, (double)y.w, d);
        }
        const unsigned long long key = score_key(warp_sum_d(d), j);
        best = key > best ? key : best;
      }
      if (lane == 0) {
        key_out(best, idx, val, (int)row);
        if (stats) atomicAdd(&block_stats[0], (unsigned long long)n);
      }
    }
  }
  __syncthreads();
  if (stats && threadIdx.x < 2 && block_stats[threadIdx.x])
    atomicAdd(&stats[threadIdx.x], block_stats[threadIdx.x]);
}

// The rows the filter could not settle, scored against every column on
// the CUDA cores: float64 products in channel order, the key of each
// (row, column) folded into the row's key (its list's first 8 bytes) by
// atomicMax. Units of FB_ROWS listed rows x FB_COLS columns, the columns
// fastest, walked by a persistent grid; a thread scores two columns,
// FB_THREADS apart, so that each row's float64 from shared memory serves
// two products. The last block to finish writes the listed rows' idx and
// val.
__global__ void __launch_bounds__(FB_THREADS)
nnfm_fallback_kernel(const float* __restrict__ fhat,
                     const float* __restrict__ shat,
                     const int* __restrict__ fb_rows,
                     const unsigned* __restrict__ fb_count,
                     unsigned* __restrict__ fb_done,
                     uint16_t* __restrict__ cols, int* __restrict__ idx,
                     float* __restrict__ val, int N, int C) {
  __shared__ __align__(16) double as[FB_K][FB_ROWS];
  __shared__ int rows_s[FB_ROWS];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const unsigned nfb = *reinterpret_cast<const volatile unsigned*>(fb_count);
  const int cblocks = (N + FB_COLS - 1) / FB_COLS;
  const long long units =
      (long long)((nfb + FB_ROWS - 1) / FB_ROWS) * cblocks;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int grp = (int)(u / cblocks);
    const int j0 = (int)(u % cblocks) * FB_COLS + tid;
    const int j[2] = {j0, j0 + FB_THREADS};
    // Columns past N read row N - 1; their keys are dropped.
    const float* b[2] = {shat + (long long)min(j[0], N - 1) * C,
                         shat + (long long)min(j[1], N - 1) * C};
    if (tid < FB_ROWS) {
      const unsigned r = (unsigned)grp * FB_ROWS + tid;
      rows_s[tid] = r < nfb ? fb_rows[r] : -1;
    }
    __syncthreads();
    double acc[2][FB_ROWS];
#pragma unroll
    for (int r = 0; r < FB_ROWS; ++r) acc[0][r] = acc[1][r] = 0.0;
    for (int k0 = 0; k0 < C; k0 += FB_K) {
      for (int e = tid; e < FB_ROWS * FB_K; e += FB_THREADS) {
        const int r = e / FB_K, k = e % FB_K;
        as[k][r] = rows_s[r] >= 0 && k0 + k < C
                       ? (double)fhat[(long long)rows_s[r] * C + k0 + k]
                       : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < FB_K / 4; ++q) {
        if (k0 + 4 * q < C) {
          const float4 y0 =
              *reinterpret_cast<const float4*>(b[0] + k0 + 4 * q);
          const float4 y1 =
              *reinterpret_cast<const float4*>(b[1] + k0 + 4 * q);
          const float yy[2][4] = {{y0.x, y0.y, y0.z, y0.w},
                                  {y1.x, y1.y, y1.z, y1.w}};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const double b0 = (double)yy[0][e], b1 = (double)yy[1][e];
            const double2* ar =
                reinterpret_cast<const double2*>(as[4 * q + e]);
#pragma unroll
            for (int r = 0; r < FB_ROWS / 2; ++r) {
              const double2 x = ar[r];
              acc[0][2 * r] = fma(x.x, b0, acc[0][2 * r]);
              acc[0][2 * r + 1] = fma(x.y, b0, acc[0][2 * r + 1]);
              acc[1][2 * r] = fma(x.x, b1, acc[1][2 * r]);
              acc[1][2 * r + 1] = fma(x.y, b1, acc[1][2 * r + 1]);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < FB_ROWS; ++r) {
      if (rows_s[r] < 0) continue;
      const unsigned long long key0 =
          j[0] < N ? score_key(acc[0][r], j[0]) : 0ull;
      const unsigned long long key1 =
          j[1] < N ? score_key(acc[1][r], j[1]) : 0ull;
      const unsigned long long key = warp_max_key(key0 > key1 ? key0 : key1);
      if ((tid & 31) == 0 && key)
        atomicMax(reinterpret_cast<unsigned long long*>(
                      cols + (long long)rows_s[r] * CAP),
                  key);
    }
    __syncthreads();
  }
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(fb_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (unsigned i = tid; i < nfb; i += blockDim.x) {
    const int row = fb_rows[i];
    key_out(__ldcg(reinterpret_cast<const unsigned long long*>(
                cols + (long long)row * CAP)),
            idx, val, row);
  }
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

// The certified matching's scratch for M rows, of
// kernels/nnfm.py::certified_scratch_bytes bytes: the fallback's count and done
// ticket (16 bytes), rmax (M,) and cnt (M,) uint32 (cleared here), the
// fallback's rows (M,) int32, then, from a 128-byte boundary, the rows'
// lists (M, CAP) uint16.
long long certified_lists_offset(long long M) {
  return (16 + 12 * M + 127) / 128 * 128;
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

// fhat (M, K), s_hat and s_hi (N, K) float32, K a multiple of 4, 16-byte
// aligned, N at most 65,536; norms (2,) float32, bounds on the style rows'
// largest |s_hi| and |s_lo|; scratch of certified_lists_offset(M) + M *
// CAP * 2 bytes; idx (M,) int32 and val (M,) float32 out; stats (2,)
// uint64 or null.
// Four steps on the stream, none waiting on the host: the clear, the
// filter, the re-score and the fallback. Returns a cudaError_t, or
// ENCODE_ERROR + the CUresult of a tensor-map encoding.
extern "C" int st3d_nnfm_match_certified_f32(
    const void* fhat, const void* s_hat, const void* s_hi, const void* norms,
    void* scratch, void* idx, void* val, void* stats, int M, int N, int K,
    int chunks, int chunk_tiles, void* stream) {
  const int n_tiles = (N + FBN - 1) / FBN;
  if (K % 4 || M <= 0 || N <= 0 || N > 65536 || chunk_tiles <= 0 ||
      chunks != (n_tiles + chunk_tiles - 1) / chunk_tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap fmap, shimap;
  CUresult r = encode_rows(&fmap, fhat, M, K, BM);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  r = encode_rows(&shimap, s_hi, N, K, FBN);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  int err = (int)cudaFuncSetAttribute(
      nnfm_filter_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F_SMEM);
  if (err) return err;
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* base = (uint8_t*)scratch;
  unsigned* fb_count = (unsigned*)base;
  unsigned* fb_done = fb_count + 1;
  unsigned* rmax = (unsigned*)(base + 16);
  unsigned* cnt = rmax + M;
  int* fb_rows = (int*)(cnt + M);
  uint16_t* lists = (uint16_t*)(base + certified_lists_offset(M));
  err = (int)cudaMemsetAsync(base, 0, 16 + 8 * (size_t)M, st);
  if (err) return err;
  const int items = ((M + BM - 1) / BM) * chunks;
  nnfm_filter_tf32_kernel<<<items < sms ? items : sms, THREADS, F_SMEM, st>>>(
      fmap, shimap, (const float*)norms, rmax, cnt, lists, M, N, K, chunks,
      chunk_tiles, items);
  err = (int)cudaGetLastError();
  if (err) return err;
  nnfm_rescore_kernel<<<row_blocks(M), 32 * ROW_WARPS, 0, st>>>(
      (const float*)fhat, (const float*)s_hat, cnt, lists, fb_rows, fb_count,
      (int*)idx, (float*)val, (unsigned long long*)stats, M, K);
  err = (int)cudaGetLastError();
  if (err) return err;
  nnfm_fallback_kernel<<<2 * sms, FB_THREADS, 0, st>>>(
      (const float*)fhat, (const float*)s_hat, fb_rows, fb_count, fb_done,
      lists, (int*)idx, (float*)val, N, K);
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
