// VGG conv1_1 with the statistics of its Gram: one pass over the image
// x (B, H, W, 3) writes z = relu(conv3x3_same(x, W) + b) (B, H, W, Cout) in
// x's dtype, and per image the float32 patch statistics PtP (27, 27) and
// s27 (27,) of the zero-padded 3x3 patches P (H*W, 27), patch order
// (dy, dx, c) as in the HWIO flatten of W. The pre-ReLU conv1_1 Gram folds
// out of them (models/vgg.py::gram1_closed_form):
//     G = W^T PtP W + u b^T + b u^T + N b b^T,  u = s27 W,
// so the (B, H, W, 64) pre-ReLU activation is never needed for it.
//
// Replaces the TPU kernel st3d/kernels/stage1_pallas.py::_conv1_1_kernel
// (entry conv1_1_packed via _conv1_1_call / _packed_call, K4a), which wrote
// z in a phase-packed layout and 48-wide quad-patch statistics; both are
// artifacts of the TPU's matrix unit. The 27-wide statistics give the same
// Gram to within float reassociation. z keeps K4a's order: float32
// accumulation, float32 bias, ReLU, then one rounding.
//
// Two passes, as K3 (csrc/gram_nhwc.cu): the TPU summed the statistics over
// its sequential grid; blocks on the card run in no order, so
//   pass 1: block (chunk, image) stages its pixels' patches in shared
//           memory 256 at a time, writes z, and keeps its partial PtP/s27
//           in registers; it writes them to scratch once;
//   pass 2: one thread per (image, entry) adds the chunks in a fixed order.
// No atomics: the statistics are the same on every run.
//
// What bounds it on an H100: writing z, 134 MB in bf16 at 512^2 x 4 views
// (~40 us at 3.35 TB/s), against 3.6 GFLOP of conv and 1.5 GFLOP of PtP on
// the CUDA cores in fp32 (~0.1 ms at the fp32 peak). A warp writes 32
// consecutive channels of one pixel, so the z stores are coalesced; the
// patch tile is read from shared memory as a broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 27;              // 3x3 taps x 3 channels
constexpr int KP = 28;             // padded row of the patch tile
constexpr int NSTAT = K * K + K;   // PtP entries, then s27
constexpr int THREADS = 256;
constexpr int SUB = THREADS;       // pixels staged at a time, one per thread
constexpr int CH_LANES = 64;       // channel lanes: thread t owns channels t % 64 (+64...)
constexpr int PIX_GROUPS = THREADS / CH_LANES;
constexpr int STATS_PER_THREAD = (NSTAT + THREADS - 1) / THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1_1_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ z,
                     float* __restrict__ partial, int H, int W, int Cout,
                     int chunks, int pix_per_block) {
  __shared__ float Ps[SUB][KP];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const long long HW = (long long)H * W;
  const long long pix_begin = (long long)chunk * pix_per_block;
  const long long pix_end = min(HW, pix_begin + pix_per_block);
  const T* xb = x + (long long)b * HW * 3;
  T* zb = z + (long long)b * HW * Cout;
  const int lane = tid % CH_LANES;
  const int group = tid / CH_LANES;

  float stat[STATS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < STATS_PER_THREAD; ++r) stat[r] = 0.f;

  for (long long sub0 = pix_begin; sub0 < pix_end; sub0 += SUB) {
    // Stage one pixel's zero-padded patch per thread.
    const long long p = sub0 + tid;
    if (p < pix_end) {
      const int py = (int)(p / W);
      const int px = (int)(p % W);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int yy = py + dy - 1, xx = px + dx - 1;
          const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            Ps[tid][(dy * 3 + dx) * 3 + c] =
                in ? to_f32(xb[((long long)yy * W + xx) * 3 + c]) : 0.f;
          }
        }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) Ps[tid][k] = 0.f;   // adds nothing to the stats
    }
    __syncthreads();

    // z: thread (lane, group) owns channel lane (+64, ...) of every
    // PIX_GROUPS-th pixel of the tile.
    const int n_here = (int)min((long long)SUB, pix_end - sub0);
    for (int c = lane; c < Cout; c += CH_LANES) {
      float wr[K];
#pragma unroll
      for (int k = 0; k < K; ++k) wr[k] = to_f32(w[k * Cout + c]);
      const float bc = to_f32(bias[c]);
      for (int i = group; i < n_here; i += PIX_GROUPS) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(Ps[i][k], wr[k], acc);
        store(&zb[(sub0 + i) * Cout + c], fmaxf(acc + bc, 0.f));
      }
    }

    // Partial statistics: entry e = (i, j) of PtP for e < 729, s27[e - 729]
    // after that.
#pragma unroll
    for (int r = 0; r < STATS_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      if (e < K * K) {
        const int i = e / K, j = e % K;
        float s = stat[r];
        for (int q = 0; q < SUB; ++q) s = fmaf(Ps[q][i], Ps[q][j], s);
        stat[r] = s;
      } else if (e < NSTAT) {
        const int k = e - K * K;
        float s = stat[r];
        for (int q = 0; q < SUB; ++q) s += Ps[q][k];
        stat[r] = s;
      }
    }
    __syncthreads();
  }

  float* out = partial + ((long long)b * chunks + chunk) * NSTAT;
#pragma unroll
  for (int r = 0; r < STATS_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    if (e < NSTAT) out[e] = stat[r];
  }
}

__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ ptp,
                                    float* __restrict__ s27, int B,
                                    int chunks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * NSTAT) return;
  const int b = t / NSTAT;
  const int e = t % NSTAT;
  const float* src = partial + (long long)b * chunks * NSTAT + e;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += src[(long long)c * NSTAT];
  if (e < K * K) {
    ptp[b * K * K + e] = sum;
  } else {
    s27[b * K + e - K * K] = sum;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* z,
           void* partial, void* ptp, void* s27, int B, int H, int W, int Cout,
           int chunks, int pix_per_block, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)B);
  conv1_1_stats_kernel<T><<<grid, THREADS, 0, st>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)z, (float*)partial, H, W,
      Cout, chunks, pix_per_block);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = B * NSTAT;
  stats_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)ptp, (float*)s27, B, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int st3d_conv1_1_stats_f32(const void* x, const void* w,
                                      const void* b, void* z, void* partial,
                                      void* ptp, void* s27, int B, int H,
                                      int W, int Cout, int chunks,
                                      int pix_per_block, void* stream) {
  return launch<float>(x, w, b, z, partial, ptp, s27, B, H, W, Cout, chunks,
                       pix_per_block, stream);
}

extern "C" int st3d_conv1_1_stats_bf16(const void* x, const void* w,
                                       const void* b, void* z, void* partial,
                                       void* ptp, void* s27, int B, int H,
                                       int W, int Cout, int chunks,
                                       int pix_per_block, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, z, partial, ptp, s27, B, H, W, Cout,
                               chunks, pix_per_block, stream);
}
