// Input gradient of VGG conv1_1 with the direct Gram of its pre-ReLU output
// (csrc/conv1_1_gram.cu). The forward gave z = relu(y) and g64 = y_r^T y_r,
// y = conv3x3_same(x, W) + b with float32 accumulation and y_r = y rounded
// to x's dtype. Given the cotangent dz (B, H, W, 64) of z and S = dG + dG^T
// (B, 64, 64) float32 of g64, each output pixel's conv cotangent is
//     d = round(dz * [y > 0] + y_r S)            (64 values, float32 sums)
// and dx (B, H, W, 3) is the transpose conv of d with W (64 -> 3), float32
// accumulation, one rounding into x's dtype.
//
// Replaces the TPU kernel st3d/kernels/stage1v3_pallas.py::_c11_bwd_kernel
// (entry _c11_v3_bwd, K10b), which recomputed y for its row band plus a
// one-row halo with the forward's slab scheme, landed d in a guard-padded
// scratch (the guard rows and columns read as zero) and folded it with
// twelve matmuls of phase-packed weights. Its rounding points are kept:
// the mask is taken on the float32 y, d is rounded once to the dtype.
//
// Work layout: gather, not scatter, as kernel B (csrc/conv1_1_bwd.cu). A
// block owns a 14 x 14 tile of dx and recomputes y and d for the 16 x 16
// halo of output pixels around it, one pixel per thread. A halo pixel
// outside the image is not an output pixel: its d is zero, which is what
// the TPU kernel's guard rows gave. Each thread folds its d into the 27
// patch cotangents dP = d W^T, stages them in shared memory, and each dx
// pixel sums its nine neighbours' entries in a fixed order. No atomics.
//
// What bounds it on an H100: compute on the CUDA cores, 27 x 64 (recompute)
// + 64 x 64 (y_r S) + 64 x 27 (dP) FMAs a halo pixel, 21 GFLOP at 512^2 x 4
// views with the 1.3x halo recompute (~0.3 ms at 67 TFLOP/s); reading dz
// (134 MB in bf16, ~40 us) comes after. Weights and S sit in shared memory
// channel-major, so a thread reads them as broadcast 16-byte loads. The
// shared memory (51,456 bytes) is dynamic, past the 48 KB static limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 27;
constexpr int KP = 28;             // padded row of the channel-major weights
constexpr int C = 64;
constexpr int TILE = 14;           // dx pixels per block side
constexpr int HALO = TILE + 2;     // recomputed output pixels per block side
constexpr int THREADS = HALO * HALO;
constexpr int SMEM_FLOATS = C * C + C * KP + C + K * THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float rounded(float v, float) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1_1_gram_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                        const T* __restrict__ w, const T* __restrict__ bias,
                        const float* __restrict__ sym, T* __restrict__ dx,
                        int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* St = smem;                  // [o][l] = S[l][o]
  float* Wt = St + C * C;            // [o][k] = W[k][o], k padded to KP
  float* Bs = Wt + C * KP;           // [o]
  float* dPs = Bs + C;               // [k][halo pixel]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE;
  const int tx0 = blockIdx.x * TILE;
  const int gy = ty0 - 1 + tid / HALO;
  const int gx = tx0 - 1 + tid % HALO;
  const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
  const long long pix = ((long long)b * H + gy) * W + gx;

  const float* sb = sym + (long long)b * C * C;
  for (int e = tid; e < C * C; e += THREADS) St[(e % C) * C + e / C] = sb[e];
  for (int e = tid; e < C * KP; e += THREADS) {
    const int o = e / KP, k = e % KP;
    Wt[e] = k < K ? to_f32(w[k * C + o]) : 0.f;
  }
  if (tid < C) Bs[tid] = to_f32(bias[tid]);
  __syncthreads();

  float dp[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) dp[k] = 0.f;
  if (in_img) {
    float P[KP];
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
    P[K] = 0.f;

    // Recompute y (float32) for the mask and its rounding y_r.
    float yr[C];
    unsigned long long mask = 0ull;
#pragma unroll
    for (int o = 0; o < C; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < KP; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Wt[o * KP + k]);
        acc = fmaf(P[k], v.x, acc);
        acc = fmaf(P[k + 1], v.y, acc);
        acc = fmaf(P[k + 2], v.z, acc);
        acc = fmaf(P[k + 3], v.w, acc);
      }
      const float y = acc + Bs[o];
      if (y > 0.f) mask |= 1ull << o;
      yr[o] = rounded(y, T());
    }

    // d_o = round(dz_o [y_o > 0] + sum_l y_r[l] S[l][o]); dP += d_o W[:, o].
    const T* dzp = dz + pix * C;
    for (int o = 0; o < C; ++o) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < C; l += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&St[o * C + l]);
        s = fmaf(yr[l], v.x, s);
        s = fmaf(yr[l + 1], v.y, s);
        s = fmaf(yr[l + 2], v.z, s);
        s = fmaf(yr[l + 3], v.w, s);
      }
      const float m = ((mask >> o) & 1ull) ? to_f32(dzp[o]) : 0.f;
      const float d = rounded(m + s, T());
#pragma unroll
      for (int k = 0; k < KP; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Wt[o * KP + k]);
        dp[k] = fmaf(d, v.x, dp[k]);
        dp[k + 1] = fmaf(d, v.y, dp[k + 1]);
        dp[k + 2] = fmaf(d, v.z, dp[k + 2]);
        dp[k + 3] = fmaf(d, v.w, dp[k + 3]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) dPs[k * THREADS + tid] = dp[k];
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
            s += dPs[((dy * 3 + ddx) * 3 + c) * THREADS
                     + (oy + 2 - dy) * HALO + ox + 2 - ddx];
          }
        store(&dx[(((long long)b * H + y) * W + xg) * 3 + c], s);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dz, const void* w, const void* bias,
           const void* sym, void* dx, int B, int H, int W, void* stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      conv1_1_gram_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err) return err;
  dim3 grid((unsigned)((W + TILE - 1) / TILE),
            (unsigned)((H + TILE - 1) / TILE), (unsigned)B);
  conv1_1_gram_bwd_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)dz, (const T*)w, (const T*)bias,
      (const float*)sym, (T*)dx, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, 3), dz (B, H, W, 64), w (27, 64) (HWIO flattened), b (64,),
// all in one dtype; sym (B, 64, 64) float32; dx (B, H, W, 3) in the dtype.
extern "C" int st3d_conv1_1_gram_bwd_f32(const void* x, const void* dz,
                                         const void* w, const void* b,
                                         const void* sym, void* dx, int B,
                                         int H, int W, void* stream) {
  return launch<float>(x, dz, w, b, sym, dx, B, H, W, stream);
}

extern "C" int st3d_conv1_1_gram_bwd_bf16(const void* x, const void* dz,
                                          const void* w, const void* b,
                                          const void* sym, void* dx, int B,
                                          int H, int W, void* stream) {
  return launch<__nv_bfloat16>(x, dz, w, b, sym, dx, B, H, W, stream);
}
