// Input gradient of maxpool2x2(relu(conv3x3_same(z) + b)), from the pooled
// cotangent: dz = transpose-conv3x3(route(ct * [pooled > 0], idx), W).
// route() puts each pooled cotangent at the window position idx names and
// zeros the other three; the ReLU mask is pooled > 0 (a window whose max is
// 0 passes nothing back). Activations NHWC; ct, pooled and idx are
// (B, H/2, W/2, C); the weights arrive already flipped and IO-transposed,
// flattened (9*C, Cout), so the transpose conv is a SAME conv; output dz
// (B, H, W, Cout) in the cotangent's dtype, float32 accumulation.
//
// Replaces the TPU kernels st3d/kernels/stage1_pallas.py::_conv1_2_bwd_kernel
// (entry conv1_2_bwd_dz5, K4d) and conv_pallas.py::_conv2x2_bwd_kernel
// (entry _prp_bwd, K5's backward). On the TPU both wrote the routed
// cotangent into a VMEM scratch and ran the matrix unit over packed phases.
//
// Work layout: K2's direct implicit GEMM (csrc/conv3x3_nhwc.cu). The
// difference is the staging of the A tile: each staged value is the routed
// cotangent at that pixel, built from ct, pooled and idx as it is staged.
// So the routed (B, H, W, C) tensor is never written to device memory, and
// the kernel reads a quarter of the pixels that a conv over it would.
//
// What bounds it on an H100: compute, as for K2 (conv1_2's input gradient
// is 77 GFLOP at 512^2 x 4 views on the CUDA cores in fp32). The routing
// costs three loads per staged value instead of one, from tensors a
// quarter the size of the activation, which mostly hit in L1; they are
// issued together so that their latencies overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 64;         // output channels per block
constexpr int BK = 16;         // routed channels per slab
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int THREADS = 256;
constexpr int A_PAD = 4;
constexpr int ROWS_PER_THREAD = BM * BK / THREADS;
constexpr int B_PER_THREAD = BN * BK / THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_route_conv3x3_bwd_kernel(const T* __restrict__ ct,
                              const T* __restrict__ pooled,
                              const unsigned char* __restrict__ idx,
                              const T* __restrict__ w, T* __restrict__ dz,
                              int B, int H, int W, int C, int Cout) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int Hp = H / 2, Wp = W / 2;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  const int a_k = tid % BK;
  const int a_r0 = tid / BK;
  const int b_n = tid % BN;
  const int b_k0 = tid / BN;

  int row_y[ROWS_PER_THREAD], row_x[ROWS_PER_THREAD];
  long long row_img[ROWS_PER_THREAD];    // b * Hp: the image's first pooled row
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const long long m = m0 + a_r0 + i * (THREADS / BK);
    if (m < M) {
      row_x[i] = (int)(m % W);
      const long long t = m / W;
      row_y[i] = (int)(t % H);
      row_img[i] = (t / H) * Hp;
    } else {
      row_y[i] = -1000000;
      row_x[i] = -1000000;
      row_img[i] = 0;
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
    for (int c0 = 0; c0 < C; c0 += BK) {
      const int ci = c0 + a_k;
      const bool ci_ok = ci < C;
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int yy = row_y[i] + dy;
        const int xx = row_x[i] + dx;
        float v = 0.f;
        if (ci_ok && yy >= 0 && yy < H && xx >= 0 && xx < W) {
          const long long pp =
              ((row_img[i] + (yy >> 1)) * Wp + (xx >> 1)) * C + ci;
          const int q = ((yy & 1) << 1) | (xx & 1);
          // Three independent loads, then a select: chained on the idx
          // test, the loads ran one after another and the kernel took
          // 4.79 ms against K2's 2.61 ms at conv1_2's shape (bf16, H100).
          const int id = idx[pp];
          const float pv = to_f32(pooled[pp]);
          const float cv = to_f32(ct[pp]);
          v = (id == q && pv > 0.f) ? cv : 0.f;
        }
        As[a_k][a_r0 + i * (THREADS / BK)] = v;
      }
#pragma unroll
      for (int j = 0; j < B_PER_THREAD; ++j) {
        const int kk = b_k0 + j * (THREADS / BN);
        const int n = n0 + b_n;
        float v = 0.f;
        if (c0 + kk < C && n < Cout) {
          v = to_f32(w[((long long)tap * C + c0 + kk) * Cout + n]);
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

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tn * TN + j;
    if (n >= Cout) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + tm * TM + i;
      if (m >= M) continue;
      store(&dz[m * Cout + n], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* ct, const void* pooled, const void* idx,
           const void* w, void* dz, int B, int H, int W, int C, int Cout,
           void* stream) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  pool_route_conv3x3_bwd_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)ct, (const T*)pooled, (const unsigned char*)idx,
      (const T*)w, (T*)dz, B, H, W, C, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int st3d_pool_route_conv3x3_bwd_f32(
    const void* ct, const void* pooled, const void* idx, const void* w,
    void* dz, int B, int H, int W, int C, int Cout, void* stream) {
  return launch<float>(ct, pooled, idx, w, dz, B, H, W, C, Cout, stream);
}

extern "C" int st3d_pool_route_conv3x3_bwd_bf16(
    const void* ct, const void* pooled, const void* idx, const void* w,
    void* dz, int B, int H, int W, int C, int Cout, void* stream) {
  return launch<__nv_bfloat16>(ct, pooled, idx, w, dz, B, H, W, C, Cout,
                               stream);
}
