// Per-image unnormalised Gram matrix G[b] = y[b]^T y[b] of an NHWC
// activation y (B, P = H*W, C), read in its stored dtype (bf16 or f32) and
// accumulated in float32, on the CUDA cores: the widths
// kernels/conv.py::gram_route keeps off the tensor cores (csrc/gram_wgmma.cu,
// csrc/gram_tf32x3.cu), such as conv1_1's 27-wide patch Gram.
//
// Replaces the Gram half of st3d/kernels/conv_pallas.py::_conv_gram_kernel
// and _conv_gram_kernel_halo (entry _conv_gram_impl), where each VMEM row
// band adds its y_band^T y_band into an output block that the sequential
// TPU grid revisits. Blocks on the card run in no order, so the sum over
// pixels is split in two passes instead of carried across blocks:
//   pass 1: block (i-tile, j-tile, image * slice) writes the partial Gram of
//           one pixel slice into scratch;
//   pass 2: one thread per (b, i, j) adds the slices in a fixed order.
// No atomics, so the result is the same on every run.
//
// What bounds it on an H100: compute. A 64x64 tile does 64*64*2 flops per
// 128 staged values per pixel, on the CUDA cores in fp32 (bf16 products are
// exact in fp32); the partial-Gram scratch is a few MiB against that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;       // Gram rows/cols per block
constexpr int BK = 16;         // pixels per staging step
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int T4 = 4;
constexpr int PER_THREAD = TILE * BK / THREADS;      // values staged per operand

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const T* __restrict__ y, float* __restrict__ partial,
                    int P, int C, int S, int slice_len) {
  __shared__ __align__(16) float As[BK][TILE];
  __shared__ __align__(16) float Bs[BK][TILE];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TILE;
  const int j0 = blockIdx.y * TILE;
  const int b = blockIdx.z / S;
  const int s = blockIdx.z % S;
  const long long p_begin = (long long)s * slice_len;
  const long long p_end = min((long long)P, p_begin + slice_len);
  const T* yb = y + (long long)b * P * C;

  const int ld_c = tid % TILE;
  const int ld_k0 = tid / TILE;              // pixels ld_k0 + r * (THREADS / TILE)
  const int ti = tid / (TILE / T4);
  const int tj = tid % (TILE / T4);

  float acc[T4][T4];
#pragma unroll
  for (int a = 0; a < T4; ++a)
#pragma unroll
    for (int c = 0; c < T4; ++c) acc[a][c] = 0.f;

  for (long long p0 = p_begin; p0 < p_end; p0 += BK) {
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int k = ld_k0 + r * (THREADS / TILE);
      const long long p = p0 + k;
      float va = 0.f, vb = 0.f;
      if (p < p_end) {
        if (i0 + ld_c < C) va = to_f32(yb[p * C + i0 + ld_c]);
        if (j0 + ld_c < C) vb = to_f32(yb[p * C + j0 + ld_c]);
      }
      As[k][ld_c] = va;
      Bs[k][ld_c] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ti * T4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tj * T4]);
      const float av[T4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[T4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < T4; ++a)
#pragma unroll
        for (int c = 0; c < T4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
    __syncthreads();
  }

  float* out = partial + ((long long)b * S + s) * C * C;
#pragma unroll
  for (int a = 0; a < T4; ++a) {
    const int i = i0 + ti * T4 + a;
    if (i >= C) continue;
#pragma unroll
    for (int c = 0; c < T4; ++c) {
      const int j = j0 + tj * T4 + c;
      if (j < C) out[(long long)i * C + j] = acc[a][c];
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ g, int B, int C, int S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long cc = (long long)C * C;
  if (idx >= (long long)B * cc) return;
  const long long b = idx / cc;
  const long long ij = idx % cc;
  const float* src = partial + b * S * cc + ij;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += src[s * cc];
  g[idx] = sum;
}

template <typename T>
int launch(const void* y, void* partial, void* g, int B, int P, int C, int S,
           int slice_len, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((C + TILE - 1) / TILE, (C + TILE - 1) / TILE, B * S);
  gram_partial_kernel<T><<<grid, THREADS, 0, st>>>(
      (const T*)y, (float*)partial, P, C, S, slice_len);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)B * C * C;
  gram_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)partial, (float*)g, B, C, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int st3d_gram_nhwc_f32(const void* y, void* partial, void* g,
                                  int B, int P, int C, int S, int slice_len,
                                  void* stream) {
  return launch<float>(y, partial, g, B, P, C, S, slice_len, stream);
}

extern "C" int st3d_gram_nhwc_bf16(const void* y, void* partial, void* g,
                                   int B, int P, int C, int S, int slice_len,
                                   void* stream) {
  return launch<__nv_bfloat16>(y, partial, g, B, P, C, S, slice_len, stream);
}
