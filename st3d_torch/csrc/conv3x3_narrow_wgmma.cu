// K2 at the widths TMA cannot stride, bf16, on Hopper's tensor cores:
// y = relu?(conv3x3_same(x, w) + b) for x (B, H, W, Cin) with Cin or Cout
// not a multiple of 8 (kernels/conv.py::conv_route, "narrow_wgmma"):
// VGG's conv1_1 (3 -> 64) and its input gradient (64 -> 3).
//
// Replaces the TPU kernels st3d/kernels/conv_pallas.py::_conv_kernel,
// _conv_kernel_nopad and _conv_kernel_halo1 (entry _conv3x3_same_impl) at
// those widths, as csrc/conv3x3_nhwc.cu did on the CUDA cores (that kernel
// stays, launched by no route, as the yardstick chip_smoke.py times beside
// this one). The design is conv_narrow.cuh's: the x halo staged by
// cp.async (3 channels) or TMA (64), A fragments loaded from it into
// registers in the dense im2col order (27 taps of conv1_1 in two k16
// steps), wgmma m64nNk16 with N the output channels padded to 8, 16, 32 or
// 64, bf16 in, float32 accumulators, one rounding into bf16, y stored by
// TMA at 64 channels.
//
// What bounds it on an H100: bytes. At 3 -> 64, 512^2 x 4 views, the
// products are 3.6 GFLOP (4 us at 989 TFLOP/s; 4.3 GFLOP with K padded to
// 32), the bytes 6.3 MB of x and 134 MB of y (42 us at 3.35 TB/s); at
// 64 -> 3, 134 MB of x and 6.3 MB of y (42 us). csrc/conv3x3_nhwc.cu ran
// scalar FMAs at 67 TFLOP/s peak (0.78 ms at 3 -> 64).

#include "conv_narrow.cuh"

// x (B, H, W, Cin) bf16, 16-byte aligned; w (nb * ceil(Cout / nb), KT) bf16
// K-major, KT = 9 * Cin rounded up to 16 (kernels/conv.py::narrow_weights);
// b (Cout,) bf16; y (B, H, W, Cout) bf16, 16-byte aligned; nb 8, 16, 32 or
// 64 output channels a block. Returns a cudaError_t, or ENCODE_ERROR + the
// CUresult of a tensor-map encoding.
extern "C" int st3d_conv3x3_narrow_wgmma_bf16(const void* x, const void* w,
                                              const void* b, void* y, int B,
                                              int H, int W, int Cin,
                                              int Cout, int relu, int nb,
                                              void* stream) {
  return narrow::launch<false>(x, w, nullptr, b, y, B, H, W, Cin, Cout,
                               relu, nb, stream);
}
