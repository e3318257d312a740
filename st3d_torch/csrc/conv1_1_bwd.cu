// Input gradient of VGG conv1_1 with its Gram statistics folded in. With P
// the zero-padded 3x3 patches of x (B, H, W, 3), patch order (dy, dx, c),
// the forward (csrc/conv1_1_stats.cu) gave z = relu(P W + b),
// PtP = P^T P and s27 = P^T 1 per image. Given their cotangents dz
// (B, H, W, Cout), S = dPtP + dPtP^T (B, 27, 27) and ds27 (B, 27), the
// patch cotangent of each pixel is
//     dP = (dz * [z > 0]) W^T + P S + ds27            (27 values)
// and dx (B, H, W, 3) is its col2im: dx[y, x, c] sums dP[(y, x) - (dy, dx)
// + 1][(dy, dx, c)] over the nine taps whose output pixel lies in the image.
//
// Replaces the TPU kernel st3d/kernels/stage1_pallas.py::_conv1_1_bwd_kernel
// (entry conv1_1_bwd_dx, K4c). The TPU read back the patch matrix the
// forward had exported to HBM, to spare its vector unit the re-staging;
// here the patches are rebuilt from x, which is 3 values a pixel against
// 27, and nothing but dx is written.
//
// Work layout: gather, not scatter. A block owns a 14 x 14 tile of dx and
// computes dP for the 16 x 16 halo of output pixels around it, one pixel
// per thread, into shared memory (k-major, so the gather reads below are
// conflict-free). Each input pixel then sums its nine neighbours' dP
// entries in a fixed order: no atomics, one rounding into x's dtype.
//
// What bounds it on an H100: compute on the CUDA cores. dP costs 27 x 64 +
// 27 x 27 FMAs a pixel (6.5 GFLOP at 512^2 x 4 views with the 1.3x halo
// recompute, ~0.1 ms at the fp32 peak); reading dz and z (2 x 134 MB in
// bf16, ~80 us at 3.35 TB/s) comes next. A thread reads its own pixel's
// channels, so a warp's loads stride by one pixel and lean on L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 27;
constexpr int TILE = 14;           // dx pixels per block side
constexpr int HALO = TILE + 2;     // dP pixels per block side
constexpr int THREADS = HALO * HALO;
constexpr int WCH = 64;            // weight channels staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1_1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                   const T* __restrict__ z, const T* __restrict__ w,
                   const float* __restrict__ sym,
                   const float* __restrict__ ds27, T* __restrict__ dx,
                   int H, int W, int Cout) {
  __shared__ float Ss[K * K];
  __shared__ float Ds[K];
  __shared__ float Ws[WCH][K];
  __shared__ float dPs[K][THREADS];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE;
  const int tx0 = blockIdx.x * TILE;
  const int gy = ty0 - 1 + tid / HALO;
  const int gx = tx0 - 1 + tid % HALO;
  const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
  const long long HW = (long long)H * W;
  const long long pix = (long long)b * HW + (long long)gy * W + gx;

  for (int e = tid; e < K * K; e += THREADS) Ss[e] = sym[b * K * K + e];
  if (tid < K) Ds[tid] = ds27[b * K + tid];
  __syncthreads();

  float acc[K];
  if (in_img) {
    float P[K];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int ddx = 0; ddx < 3; ++ddx) {
        const int yy = gy + dy - 1, xx = gx + ddx - 1;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          P[(dy * 3 + ddx) * 3 + c] =
              in ? to_f32(x[(((long long)b * H + yy) * W + xx) * 3 + c]) : 0.f;
        }
      }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = Ds[k];
#pragma unroll
      for (int l = 0; l < K; ++l) s = fmaf(P[l], Ss[l * K + k], s);
      acc[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;   // outside the image: no term
  }

  // (dz * [z > 0]) W^T, weights staged WCH channels at a time.
  for (int o0 = 0; o0 < Cout; o0 += WCH) {
    const int nch = min(WCH, Cout - o0);
    for (int e = tid; e < nch * K; e += THREADS) {
      const int oo = e / K, k = e % K;
      Ws[oo][k] = to_f32(w[k * Cout + o0 + oo]);
    }
    __syncthreads();
    if (in_img) {
      for (int oo = 0; oo < nch; ++oo) {
        const long long a = pix * Cout + o0 + oo;
        const float d = to_f32(z[a]) > 0.f ? to_f32(dz[a]) : 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(d, Ws[oo][k], acc[k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < K; ++k) dPs[k][tid] = acc[k];
  __syncthreads();

  // col2im by gather: input pixel (y, x) takes tap (dy, dx) from output
  // pixel (y - dy + 1, x - dx + 1), halo row oy + 2 - dy.
  if (tid < TILE * TILE) {
    const int oy = tid / TILE, ox = tid % TILE;
    const int y = ty0 + oy, xg = tx0 + ox;
    if (y < H && xg < W) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int ddx = 0; ddx < 3; ++ddx) {
            s += dPs[(dy * 3 + ddx) * 3 + c][(oy + 2 - dy) * HALO + ox + 2 - ddx];
          }
        store(&dx[(((long long)b * H + y) * W + xg) * 3 + c], s);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dz, const void* z, const void* w,
           const void* sym, const void* ds27, void* dx, int B, int H, int W,
           int Cout, void* stream) {
  dim3 grid((unsigned)((W + TILE - 1) / TILE),
            (unsigned)((H + TILE - 1) / TILE), (unsigned)B);
  conv1_1_bwd_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)dz, (const T*)z, (const T*)w,
      (const float*)sym, (const float*)ds27, (T*)dx, H, W, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int st3d_conv1_1_bwd_f32(const void* x, const void* dz,
                                    const void* z, const void* w,
                                    const void* sym, const void* ds27,
                                    void* dx, int B, int H, int W, int Cout,
                                    void* stream) {
  return launch<float>(x, dz, z, w, sym, ds27, dx, B, H, W, Cout, stream);
}

extern "C" int st3d_conv1_1_bwd_bf16(const void* x, const void* dz,
                                     const void* z, const void* w,
                                     const void* sym, const void* ds27,
                                     void* dx, int B, int H, int W, int Cout,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, dz, z, w, sym, ds27, dx, B, H, W, Cout,
                               stream);
}
