// VGG conv1_1 with the direct Gram of its pre-ReLU output: one pass over
// the image x (B, H, W, 3) writes z = relu(y) (B, H, W, 64) in x's dtype,
// where y = conv3x3_same(x, W) + b with float32 accumulation, and per image
// the float32 Gram g64 = y_r^T y_r (64, 64) of y rounded once to x's dtype.
//
// Replaces the TPU kernel st3d/kernels/stage1v3_pallas.py::_c11_fwd_kernel
// (entry conv1_1_packed_v3, K10a). The TPU wrote z in its phase-packed z5
// layout (a pure reshape of NHWC) and summed the Gram over its sequential
// row-band grid into one output block. Its rounding points are kept: the
// weights and bias arrive in x's dtype, the accumulation is float32, relu(y)
// and y are each rounded once, and the Gram is taken in float32 from the
// rounded y. This is not kernel A's closed form (csrc/conv1_1_stats.cu): in
// bf16 the two differ by the rounding of y.
//
// Two passes, as K3 (csrc/gram_nhwc.cu): blocks on the card run in no
// order, so
//   pass 1: block (chunk, image) stages 128 pixels' patches at a time in
//           shared memory, writes z, keeps the rounded y of those pixels in
//           shared memory and folds y^T y into a 64 x 64 partial held in
//           registers (16 entries a thread); it writes the partial once;
//   pass 2: one thread per (image, entry) adds the chunks in a fixed order.
// No atomics: the Gram is the same on every run.
//
// What bounds it on an H100: the Gram, 2 x 64 x 64 flops a pixel (8.6 GFLOP
// at 512^2 x 4 views), on the CUDA cores in fp32 (~0.13 ms at 67 TFLOP/s),
// ahead of the conv (3.6 GFLOP) and of writing z (134 MB in bf16, ~40 us at
// 3.35 TB/s). A thread reads its row entry of y as a conflict-free word and
// its 16 column entries as four broadcast 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 27;              // 3x3 taps x 3 channels
constexpr int KP = 28;             // padded row of the patch tile
constexpr int C = 64;              // conv1_1's output channels
constexpr int THREADS = 256;
constexpr int SUB = 128;           // pixels staged at a time
constexpr int PIX_GROUPS = THREADS / C;
constexpr int GCOLS = C * C / THREADS;   // Gram entries a thread owns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// The value a float takes once stored in T.
__device__ __forceinline__ float rounded(float v, float) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1_1_gram_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ z,
                    float* __restrict__ partial, int H, int W, int chunks,
                    int pix_per_block) {
  __shared__ float Ps[SUB][KP];
  __shared__ __align__(16) float Ys[SUB][C];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const long long HW = (long long)H * W;
  const long long pix_begin = (long long)chunk * pix_per_block;
  const long long pix_end = min(HW, pix_begin + pix_per_block);
  const T* xb = x + (long long)b * HW * 3;
  T* zb = z + (long long)b * HW * C;

  // Conv: thread (lane, group) owns channel lane of every PIX_GROUPS-th
  // pixel of the staged tile.
  const int lane = tid % C;
  const int group = tid / C;
  float wr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wr[k] = to_f32(w[k * C + lane]);
  const float bc = to_f32(bias[lane]);

  // Gram: thread owns row gi, columns gj0 .. gj0 + GCOLS - 1.
  const int gi = tid % C;
  const int gj0 = (tid / C) * GCOLS;
  float g[GCOLS];
#pragma unroll
  for (int j = 0; j < GCOLS; ++j) g[j] = 0.f;

  for (long long sub0 = pix_begin; sub0 < pix_end; sub0 += SUB) {
    // Stage the zero-padded patches, order (dy, dx, c).
    for (int e = tid; e < SUB * K; e += THREADS) {
      const int i = e / K, k = e % K;
      const long long p = sub0 + i;
      float v = 0.f;
      if (p < pix_end) {
        const int py = (int)(p / W), px = (int)(p % W);
        const int yy = py + k / 9 - 1, xx = px + (k / 3) % 3 - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          v = to_f32(xb[((long long)yy * W + xx) * 3 + k % 3]);
        }
      }
      Ps[i][k] = v;
    }
    __syncthreads();

    const int n_here = (int)min((long long)SUB, pix_end - sub0);
    for (int i = group; i < SUB; i += PIX_GROUPS) {
      float yr = 0.f;              // pixels past the end add nothing
      if (i < n_here) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(Ps[i][k], wr[k], acc);
        const float y = acc + bc;
        store(&zb[(sub0 + i) * C + lane], fmaxf(y, 0.f));
        yr = rounded(y, T());
      }
      Ys[i][lane] = yr;
    }
    __syncthreads();

#pragma unroll 4
    for (int q = 0; q < SUB; ++q) {
      const float yi = Ys[q][gi];
#pragma unroll
      for (int j = 0; j < GCOLS; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Ys[q][gj0 + j]);
        g[j] = fmaf(yi, v.x, g[j]);
        g[j + 1] = fmaf(yi, v.y, g[j + 1]);
        g[j + 2] = fmaf(yi, v.z, g[j + 2]);
        g[j + 3] = fmaf(yi, v.w, g[j + 3]);
      }
    }
    __syncthreads();
  }

  float* out = partial + ((long long)b * chunks + chunk) * C * C + gi * C + gj0;
#pragma unroll
  for (int j = 0; j < GCOLS; ++j) out[j] = g[j];
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ g64, int B,
                                   int chunks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * C * C) return;
  const int b = t / (C * C);
  const int e = t % (C * C);
  const float* src = partial + (long long)b * chunks * C * C + e;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += src[(long long)c * C * C];
  g64[t] = sum;
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* z,
           void* partial, void* g64, int B, int H, int W, int chunks,
           int pix_per_block, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)B);
  conv1_1_gram_kernel<T><<<grid, THREADS, 0, st>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)z, (float*)partial, H, W,
      chunks, pix_per_block);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = B * C * C;
  gram_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)g64, B, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, 3), w (27, 64) (HWIO flattened), b (64,), all in one dtype;
// z (B, H, W, 64) in that dtype; partial (B, chunks, 64, 64) and g64
// (B, 64, 64) float32.
extern "C" int st3d_conv1_1_gram_f32(const void* x, const void* w,
                                     const void* b, void* z, void* partial,
                                     void* g64, int B, int H, int W,
                                     int chunks, int pix_per_block,
                                     void* stream) {
  return launch<float>(x, w, b, z, partial, g64, B, H, W, chunks,
                       pix_per_block, stream);
}

extern "C" int st3d_conv1_1_gram_bf16(const void* x, const void* w,
                                      const void* b, void* z, void* partial,
                                      void* g64, int B, int H, int W,
                                      int chunks, int pix_per_block,
                                      void* stream) {
  return launch<__nv_bfloat16>(x, w, b, z, partial, g64, B, H, W, chunks,
                               pix_per_block, stream);
}
