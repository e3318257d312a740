// K2 at the widths TMA cannot stride, float32 by the 3xTF32 split on
// Hopper's tensor cores: y = relu?(conv3x3_same(x, w) + b) for x (B, H,
// W, Cin) with Cin or Cout not a multiple of 4 (kernels/conv.py::
// conv_route, "narrow_tf32x3"): VGG's conv1_1 (3 -> 64) and its input
// gradient (64 -> 3) in the CLIs' default dtype.
//
// Replaces the TPU kernels st3d/kernels/conv_pallas.py::_conv_kernel,
// _conv_kernel_nopad and _conv_kernel_halo1 (entry _conv3x3_same_impl) at
// those widths in float32. The design is conv_narrow.cuh's; the
// numerics are csrc/conv3x3_tf32x3.cu's: each A fragment is split into
// tf32 hi + lo in registers (hopper.cuh split_tf32), the weights by the
// wrapper (kernels/conv.py::split_tf32), and every k-step is the three
// products a_lo b_hi + a_hi b_lo + a_hi b_hi (wgmma m64nNk8, A from
// registers). One accumulator takes every product of a tile (27 at 3 ->
// 64, 216 at 64 -> 3, against the 864 whose drift made
// csrc/conv3x3_tf32x3.cu fold its partials). On data exact in tf32 every
// partial sum is exact, and the output equals the plain version's bit for
// bit.
//
// What bounds it on an H100: bytes. At 3 -> 64, 512^2 x 4 views, 12.6 MB of
// x and 268 MB of y (84 us at 3.35 TB/s); the products, three tf32 passes
// of 3.6 GFLOP (22 us at 495 TFLOP/s, 26 with K padded to 32). At 64 -> 3,
// 268 MB of x and 12.6 MB of y (84 us). The halo of 64 channels comes by
// TMA; y at Cout = 64 (256 bytes a pixel) leaves by TMA.

#include "conv_narrow.cuh"

// x (B, H, W, Cin) float32, 16-byte aligned; w_hi, w_lo (nb * ceil(Cout /
// nb), KT) float32 K-major, the split_tf32 parts of the weights, KT = 9 *
// Cin rounded up to 8 (kernels/conv.py::narrow_weights); b (Cout,) float32;
// y (B, H, W, Cout) float32, 16-byte aligned; nb 8, 16, 32 or 64 output
// channels a block. Returns a cudaError_t, or ENCODE_ERROR + the CUresult
// of a tensor-map encoding.
extern "C" int st3d_conv3x3_narrow_tf32x3_f32(const void* x,
                                              const void* w_hi,
                                              const void* w_lo,
                                              const void* b, void* y, int B,
                                              int H, int W, int Cin,
                                              int Cout, int relu, int nb,
                                              void* stream) {
  return narrow::launch<true>(x, w_hi, w_lo, b, y, B, H, W, Cin, Cout, relu,
                              nb, stream);
}
