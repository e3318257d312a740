// Per-image unnormalised Gram matrix G[b] = y[b]^T y[b] of an NHWC
// activation y (B, P = H*W, C) at the narrow widths TMA cannot stride
// (C <= 32: bf16 with C % 8 != 0, float32 with C % 4 != 0, such as
// conv1_1's 27-wide patch Gram), read in its stored dtype and accumulated in
// float32 on the tensor cores. kernels/conv.py::gram_route gives these
// widths "narrow".
//
// Replaces the Gram half of st3d/kernels/conv_pallas.py::_conv_gram_kernel
// and _conv_gram_kernel_halo (entry _conv_gram_impl) at these widths. The
// JAX package leaves conv1_1's 27-wide PᵀP to XLA (st3d/models/vgg.py's
// einsum); the port computes it with K3.
//
// What bounds it on an H100: bytes. A pixel's C values are read once and
// feed C * C products: 2 * 27 * 27 operations per 54 bytes in bf16 (about
// 27 a byte, 13 in float32), far under the ridge of either tensor-core
// rate. So the design is one pass over the bytes with enough of them in
// flight, and products that never wait on memory:
//   - Loads. An image's (P, C) activation is one contiguous run of P * C
//     elements, and so is a block's pixel slice (kernels/conv.py::gram_split:
//     slices start at multiples of 8 pixels, so with P a multiple of 8 the
//     run starts on a 16-byte boundary in either dtype). Each block streams
//     its slice, 256 pixels a stage, into a ring of 3 slots with an
//     mbarrier each, two stages in flight while one is multiplied: thread 0
//     copies a stage's 16-byte-aligned chunks by one cp.async.bulk, at the
//     same offsets mod 16, so its first element sits `shift` bytes into the
//     slot; the tensor's last chunk, if partial and reached, is copied by
//     plain stores before the arrive that releases them.
//   - Products. mma.sync on the tensor cores, K over pixels, the Gram padded
//     to 32 x 32 (two m16 row tiles, four n8 column tiles; only the tiles
//     of the upper block triangle, column tile >= 2 * row tile, 6 of 8, and
//     fewer for C <= 24). A warp gathers, per k-step, the B fragment of each
//     column tile from the staged run at p * C + k (zero past C and past the
//     slice); the A fragments are the same values (A = Yᵀ, B = Y), so the
//     row tile m takes column tiles 2m and 2m + 1's registers. bf16:
//     m16n8k16 with bf16 inputs (products exact in f32). float32: m16n8k8
//     with tf32 inputs by the 3xTF32 split of every other f32 route
//     (hopper.cuh::split_tf32: y = hi + lo, a*b ~= lo*hi + hi*lo + hi*hi),
//     which holds 1e-5. Each stage's products go to a fresh accumulator that
//     is then added to the running sum (the tensor core's own f32 sum
//     truncates; conv3x3_tf32x3.cu's note).
//   - Why mma.sync and not wgmma: at ~27 operations a byte the products
//     are not the limit, and mma.sync takes A from registers at 16 rows,
//     where wgmma wants 64-row tiles of a 32-wide Gram and its operands in
//     shared memory in a layout the flat run is not in.
// Reduction: deterministic two-pass, no atomics. Each block sums its 8
// warps' Grams in a fixed order into its (image, slice) partial; the second
// pass (hopper.cuh::gram_reduce_upper) adds the slices in order. So a
// second call gives the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TP = 256;      // pixels a stage (kernels/conv.py GRAM_PLAN)
constexpr int STAGES = 3;
constexpr int CMAX = 32;     // the widest C (kernels/conv.py NARROW_GRAM_C)
constexpr int BAR_BYTES = 64;  // the slots' mbarriers, before the slots

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a warp: the products of pixels pb .. pb + K - 1 of the
// staged run `s` (npix pixels of C values) into acc[m][n] for the computed
// tiles (n >= 2m). Lane (g = lane / 4, t = lane % 4) holds the B fragment
// values of column tile n at channel 8n + g; the row tile m's A fragment is
// {B[2m].r0, B[2m+1].r0, B[2m].r1, B[2m+1].r1} (PTX ISA's m16n8k16 /
// m16n8k8 fragment layouts: A rows g, g + 8 at columns 2t.. / t, t + 4,
// B rows 2t.. / t, t + 4 at column g).
template <typename T, int NT>
struct Step;

template <int NT>
struct Step<__nv_bfloat16, NT> {
  static constexpr int K = 16;
  static constexpr int MT = (NT + 1) / 2;

  static __device__ __forceinline__ uint32_t at(const uint16_t* s, int q,
                                                int ch, int C, int npix) {
    return (q < npix && ch < C) ? s[q * C + ch] : 0u;
  }

  static __device__ __forceinline__ void run(const void* run_, int pb,
                                             int npix, int C,
                                             float (&acc)[MT][NT][4]) {
    const uint16_t* s = static_cast<const uint16_t*>(run_);
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    uint32_t b[2 * MT][2];
#pragma unroll
    for (int n = 0; n < 2 * MT; ++n) {
      const int ch = 8 * n + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = pb + 2 * t + 8 * r;
        b[n][r] = at(s, q, ch, C, npix) | (at(s, q + 1, ch, C, npix) << 16);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint32_t a[4] = {b[2 * m][0], b[2 * m + 1][0], b[2 * m][1],
                             b[2 * m + 1][1]};
#pragma unroll
      for (int n = 2 * m; n < NT; ++n) mma_bf16(acc[m][n], a, b[n][0], b[n][1]);
    }
  }
};

template <int NT>
struct Step<float, NT> {
  static constexpr int K = 8;
  static constexpr int MT = (NT + 1) / 2;

  static __device__ __forceinline__ void run(const void* run_, int pb,
                                             int npix, int C,
                                             float (&acc)[MT][NT][4]) {
    const float* s = static_cast<const float*>(run_);
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    uint32_t hi[2 * MT][2], lo[2 * MT][2];
#pragma unroll
    for (int n = 0; n < 2 * MT; ++n) {
      const int ch = 8 * n + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = pb + t + 4 * r;
        const float v = (q < npix && ch < C) ? s[q * C + ch] : 0.f;
        split_tf32(v, hi[n][r], lo[n][r]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint32_t ah[4] = {hi[2 * m][0], hi[2 * m + 1][0], hi[2 * m][1],
                              hi[2 * m + 1][1]};
      const uint32_t al[4] = {lo[2 * m][0], lo[2 * m + 1][0], lo[2 * m][1],
                              lo[2 * m + 1][1]};
#pragma unroll
      for (int n = 2 * m; n < NT; ++n) {
        mma_tf32(acc[m][n], al, hi[n][0], hi[n][1]);
        mma_tf32(acc[m][n], ah, lo[n][0], lo[n][1]);
        mma_tf32(acc[m][n], ah, hi[n][0], hi[n][1]);
      }
    }
  }
};

// Block (image b, slice s) of the (B * S) grid: the partial Gram of pixels
// [s * slice_len, min(P, (s + 1) * slice_len)) of image b into
// partial[b][s] (C x C, both triangles).
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
gram_narrow_kernel(const T* __restrict__ y, float* __restrict__ partial,
                   long long total_bytes, int P, int C, int S, int slice_len,
                   int pitch) {
  using St = Step<T, NT>;
  constexpr int MT = St::MT;
  constexpr int ES = (int)sizeof(T);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);   // one a slot
  uint8_t* smem = smem_raw + BAR_BYTES;
  const int b = blockIdx.x / S;
  const int s = blockIdx.x % S;
  const long long p_begin = (long long)s * slice_len;
  const long long p_end = min((long long)P, p_begin + slice_len);
  const int n_stages = (int)((p_end - p_begin + TP - 1) / TP);
  const long long img = (long long)b * P;
  const uint8_t* yb = reinterpret_cast<const uint8_t*>(y);
  const int warp = threadIdx.x >> 5;

  // Thread 0 starts the copy of stage j (if any) into its slot: the
  // 16-byte-aligned chunks covering it by one bulk copy, and the bytes of
  // the tensor's last chunk, if it is partial and the stage reaches it, by
  // plain stores before the arrive that releases them.
  auto issue = [&](int j) {
    if (j >= n_stages) return;
    const long long q0 = p_begin + (long long)j * TP;
    const long long q1 = min(q0 + TP, p_end);
    const long long a0 = ((img + q0) * C * ES) & ~15ll;
    const long long a1 = ((img + q1) * C * ES + 15) & ~15ll;
    const long long whole = min(a1, total_bytes & ~15ll);
    uint8_t* dst = smem + (j % STAGES) * pitch;
    for (long long x = max(a0, whole); x < min(a1, total_bytes); ++x)
      dst[x - a0] = yb[x];
    const uint32_t bar = smem_u32(bars + j % STAGES);
    const uint32_t n = (uint32_t)max(0ll, whole - a0);
    mbar_expect_tx(bar, n);
    if (n) bulk_load(smem_u32(dst), yb + a0, n, bar);
  };

  float sum[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[m][n][i] = 0.f;

  if (threadIdx.x == 0) {
    for (int q = 0; q < STAGES; ++q) mbar_init(smem_u32(bars + q), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < STAGES - 1; ++j) issue(j);
  }
  __syncthreads();
  for (int j = 0; j < n_stages; ++j) {
    if (threadIdx.x == 0) issue(j + STAGES - 1);   // the slot j - 1 freed
    mbar_wait(smem_u32(bars + j % STAGES), (j / STAGES) & 1);
    const long long q0 = p_begin + (long long)j * TP;
    const int npix = (int)(min(q0 + TP, p_end) - q0);
    const int shift = (int)(((img + q0) * C * ES) & 15);
    const uint8_t* run = smem + (j % STAGES) * pitch + shift;
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
    for (int pb = warp * St::K; pb < npix; pb += WARPS * St::K)
      St::run(run, pb, npix, C, acc);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 2 * m; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[m][n][i] += acc[m][n][i];
    __syncthreads();                 // slot j % STAGES is refilled next
  }

  // The warps' Grams into shared memory (32 x 32 each, computed tiles only),
  // then summed in warp order: entry (i, j) of a tile below the block
  // diagonal is read at (j, i).
  float* red = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 2 * m; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * m + g + 8 * (i >> 1);
        const int col = 8 * n + 2 * t + (i & 1);
        red[(warp * CMAX + row) * CMAX + col] = sum[m][n][i];
      }
  __syncthreads();
  float* out = partial + ((long long)b * S + s) * C * C;
  for (int e = threadIdx.x; e < C * C; e += THREADS) {
    int i = e / C, jj = e % C;
    if ((jj >> 3) < 2 * (i >> 4)) {
      const int k = i;
      i = jj;
      jj = k;
    }
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[(w * CMAX + i) * CMAX + jj];
    out[e] = v;
  }
}

template <typename T, int NT>
int launch_nt(const void* y, void* partial, void* g, int B, int P, int C,
              int S, int slice_len, cudaStream_t st) {
  const int es = (int)sizeof(T);
  const int pitch = (TP * C * es + 15) / 16 * 16 + 32;
  const int smem = BAR_BYTES + max(STAGES * pitch, WARPS * CMAX * CMAX * 4);
  auto kern = gram_narrow_kernel<T, NT>;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kern<<<(unsigned)(B * S), THREADS, smem, st>>>(
      (const T*)y, (float*)partial, (long long)B * P * C * es, P, C, S,
      slice_len, pitch);
  err = (int)cudaGetLastError();
  if (err) return err;
  return gram_reduce_upper<CMAX>(partial, g, B, C, S, st);
}

template <typename T>
int launch(const void* y, void* partial, void* g, int B, int P, int C, int S,
           int slice_len, void* stream) {
  if (C < 1 || C > CMAX || slice_len <= 0 || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((C + 7) / 8) {
    case 1: return launch_nt<T, 1>(y, partial, g, B, P, C, S, slice_len, st);
    case 2: return launch_nt<T, 2>(y, partial, g, B, P, C, S, slice_len, st);
    case 3: return launch_nt<T, 3>(y, partial, g, B, P, C, S, slice_len, st);
    default: return launch_nt<T, 4>(y, partial, g, B, P, C, S, slice_len, st);
  }
}

}  // namespace

// y (B, P, C) contiguous at a 16-byte aligned address, bf16 or float32;
// partial (B, S, C, C) and g (B, C, C) float32; S slices of slice_len
// pixels (the last may be shorter).
extern "C" int st3d_gram_narrow_bf16(const void* y, void* partial, void* g,
                                     int B, int P, int C, int S,
                                     int slice_len, void* stream) {
  return launch<__nv_bfloat16>(y, partial, g, B, P, C, S, slice_len, stream);
}

extern "C" int st3d_gram_narrow_f32(const void* y, void* partial, void* g,
                                    int B, int P, int C, int S,
                                    int slice_len, void* stream) {
  return launch<float>(y, partial, g, B, P, C, S, slice_len, stream);
}
