// 3x3 SAME stride-1 convolution + bias, ReLU and 2x2 max-pool with the
// window index, NHWC activations, weights flattened HWIO (9*Cin, Cout),
// float32 accumulation. Outputs: pooled (B, H/2, W/2, Cout) in the input's
// dtype and idx (B, H/2, W/2, Cout) uint8 in {0..3}, the position of the
// first maximum in window scan order ((0,0), (0,1), (1,0), (1,1)), compared
// on the values already rounded to the output dtype.
//
// Replaces the TPU kernels st3d/kernels/stage1_pallas.py::_conv1_2_kernel
// (entry conv1_2_packed_pool, K4b) and conv_pallas.py::_conv2x2_fwd_kernel
// (entry conv3x3_bias_relu_pool_packed, K5) for the widths
// kernels/conv.py::relu_pool_route keeps off the tensor cores (bf16 with Cin
// or Cout not a multiple of 8, float32 not a multiple of 4; the tensor-core
// routes are csrc/conv3x3_wgmma.cu's and csrc/conv3x3_tf32x3.cu's pool
// epilogues). Both TPU kernels compute this function;
// their space-to-depth packings exist to fill the TPU's 128-wide matrix unit
// at Cin = 64 and have no counterpart here. The tie rule is
// conv_pallas.py::_pool4_first_max: strict > between pairs, so the first
// maximum wins, on output-dtype values.
//
// Work layout: K2's direct implicit GEMM (csrc/conv3x3_nhwc.cu) with its
// bounds-checked staging, so no padded copy of the input exists. What
// changes is the order of a block's BM = 128 pixel rows: they are 32 pooled
// pixels times their four window positions, and each thread's TM = 8 rows
// are two whole windows. The pool therefore happens in registers in the
// epilogue, and only pooled and idx reach device memory: the pre-pool
// activation (B, H, W, Cout) is never written.
//
// What bounds it on an H100: compute, as for K2. At conv1_2's widths
// (64 -> 64, 512^2 x 4 views) the conv is 77 GFLOP on the CUDA cores in
// fp32 (67 TFLOP/s peak); the pool saves the 134 MB bf16 activation write
// and its re-read by a separate pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // pre-pool pixels per block: 32 windows x 4
constexpr int WINDOWS = BM / 4;
constexpr int BN = 64;         // output channels per block
constexpr int BK = 16;         // input channels per slab
constexpr int TM = 8;          // pre-pool pixels per thread: two windows
constexpr int TN = 4;          // channels per thread
constexpr int THREADS = 256;   // (BM / TM) * (BN / TN)
constexpr int A_PAD = 4;
constexpr int ROWS_PER_THREAD = BM * BK / THREADS;
constexpr int B_PER_THREAD = BN * BK / THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// The value a float takes once stored in T (the pool compares these).
__device__ __forceinline__ float rounded(float v, float) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// At most 128 registers a thread, so two blocks share an SM as K2's do: left
// free, ptxas took 154 and the kernel ran at half K2's rate (5.39 ms against
// 2.61 ms for conv1_2 at 512^2 x 4 views in bf16 on an H100).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_relu_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ pooled,
                         unsigned char* __restrict__ idx, int B, int H, int W,
                         int Cin, int Cout) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int Hp = H / 2, Wp = W / 2;
  const long long P = (long long)B * Hp * Wp;      // pooled pixels
  const long long p0 = (long long)blockIdx.x * WINDOWS;
  const int n0 = blockIdx.y * BN;

  const int a_k = tid % BK;
  const int a_r0 = tid / BK;
  const int b_n = tid % BN;
  const int b_k0 = tid / BN;

  // Row r of the block is window r / 4 at position q = r % 4 = 2*qy + qx.
  int row_y[ROWS_PER_THREAD], row_x[ROWS_PER_THREAD];
  long long row_pix[ROWS_PER_THREAD];    // the row's pixel in (B, H, W)
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = a_r0 + i * (THREADS / BK);
    const long long p = p0 + r / 4;
    const int q = r % 4;
    if (p < P) {
      const long long hw = (long long)Hp * Wp;
      const long long b = p / hw;
      const long long rem = p % hw;
      row_y[i] = 2 * (int)(rem / Wp) + q / 2;
      row_x[i] = 2 * (int)(rem % Wp) + q % 2;
      row_pix[i] = (b * H + row_y[i]) * W + row_x[i];
    } else {
      row_y[i] = -1000000;   // never inside the image: the row stages zeros
      row_x[i] = -1000000;
      row_pix[i] = 0;
    }
  }

  const int tm = tid / (BN / TN);
  const int tn = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    const long long shift = (long long)dy * W + dx;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int ci = c0 + a_k;
      const bool ci_ok = ci < Cin;
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int yy = row_y[i] + dy;
        const int xx = row_x[i] + dx;
        float v = 0.f;
        if (ci_ok && yy >= 0 && yy < H && xx >= 0 && xx < W) {
          v = to_f32(x[(row_pix[i] + shift) * Cin + ci]);
        }
        As[a_k][a_r0 + i * (THREADS / BK)] = v;
      }
#pragma unroll
      for (int j = 0; j < B_PER_THREAD; ++j) {
        const int kk = b_k0 + j * (THREADS / BN);
        const int n = n0 + b_n;
        float v = 0.f;
        if (c0 + kk < Cin && n < Cout) {
          v = to_f32(w[((long long)tap * Cin + c0 + kk) * Cout + n]);
        }
        Bs[kk][b_n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tm * TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][tm * TM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tn * TN]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue: bias, ReLU, one rounding into T, then the window max on the
  // rounded values with the first maximum winning ties.
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tn * TN + j;
    if (n >= Cout) continue;
    const float bn = to_f32(bias[n]);
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const long long p = p0 + tm * (TM / 4) + h;
      if (p >= P) continue;
      float c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = rounded(fmaxf(acc[h * 4 + q][j] + bn, 0.f), T());
      }
      const bool w01 = c[1] > c[0];
      const bool w23 = c[3] > c[2];
      const float m01 = fmaxf(c[0], c[1]);
      const float m23 = fmaxf(c[2], c[3]);
      const bool wm = m23 > m01;
      store(&pooled[p * Cout + n], fmaxf(m01, m23));
      idx[p * Cout + n] = (unsigned char)(wm ? 2 + (int)w23 : (int)w01);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* pooled,
           void* idx, int B, int H, int W, int Cin, int Cout, void* stream) {
  const long long P = (long long)B * (H / 2) * (W / 2);
  dim3 grid((unsigned)((P + WINDOWS - 1) / WINDOWS),
            (unsigned)((Cout + BN - 1) / BN));
  conv3x3_relu_pool_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)pooled,
      (unsigned char*)idx, B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int st3d_conv3x3_relu_pool_f32(const void* x, const void* w,
                                          const void* b, void* pooled,
                                          void* idx, int B, int H, int W,
                                          int Cin, int Cout, void* stream) {
  return launch<float>(x, w, b, pooled, idx, B, H, W, Cin, Cout, stream);
}

extern "C" int st3d_conv3x3_relu_pool_bf16(const void* x, const void* w,
                                           const void* b, void* pooled,
                                           void* idx, int B, int H, int W,
                                           int Cin, int Cout, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, pooled, idx, B, H, W, Cin, Cout,
                               stream);
}
