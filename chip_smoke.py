#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``st3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --steps    # only step times (see ``steps_only``)

Phases; any failure raises and the script exits non-zero:

1. Card: ``nvidia-smi`` name and power limit, torch/CUDA/nvcc versions, and
   the build of every hand-written kernel from ``st3d_torch/csrc``.
2. Kernel checks at the main path's shapes, each kernel against its plain
   PyTorch version on the same inputs (TF32 off for the plain versions):
   K1 ``raster_hard`` (4 fixed views at 512², ico-sphere level 4):
   pix_to_face exactly equal, zbuf within rtol 1e-6;
   K1's soft mode ``raster_soft`` (the same faces, sigma 1 px):
   pix_to_face and nearest_face exactly equal, zbuf within rtol 1e-6;
   K7 ``raster_topk`` (the same faces, K=4 with a 3 px window as SoftRas
   runs it, and K+slack=5 with the window of blur_radius 1e-4): ids
   exactly equal;
   K6 ``raster_stream``, forced, at 81,920 faces and 256² against its plain
   version (hard and soft: pix_to_face and nearest exactly equal, zbuf
   within rtol 1e-6), and at 327,680 faces x 512² x 4 against K1 (hard and
   soft: pix_to_face and zbuf bit-equal), every call also against the TPU
   kernel's walk ``raster_stream_every_chunk`` (launched by no route: all
   outputs equal), with the chunks each tested and ``stream_counts``;
   K2 at every VGG conv shape at batch 4, forward and input gradient, in
   bf16 on the tensor-core kernel ``conv3x3_wgmma`` (max-abs error <= 1e-2
   * max|plain|) and in f32 on the 3xTF32 tensor-core kernel
   ``conv3x3_tf32x3`` (<= 1e-4 * max|plain|); each call must launch the
   kernel its route names;
   K2 at the widths TMA cannot stride (``narrow_check``): 3 -> 64 and 64 ->
   3 at 512² x 4, 5 -> 12 and 12 -> 5 at 128² x 4, forward and dx, on
   ``conv3x3_narrow_wgmma`` (bf16) and ``conv3x3_narrow_tf32x3`` (f32) with
   K2's tolerances, bit-equal on exact data in both dtypes; at 512² each
   timed beside the CUDA-core ``conv3x3_nhwc`` (launched by no route, held
   against the plain version too) and ``F.conv2d``;
   K3 at the four style-Gram shapes, in bf16 on ``gram_wgmma`` (relative
   Frobenius error <= 1e-3) and in f32 on the 3xTF32 ``gram_tf32x3``
   (<= 1e-5; the CUDA-core ``gram_nhwc`` held and timed on the same f32
   inputs), and conv1_1's 27-wide PᵀP in bf16 on ``gram_nhwc``; each Gram
   bit-identical on a second call;
   stage 1 at 512² x 4 (conv1_1 3->64, conv1_2 64->64), bf16 and f32:
   A (``conv1_1_stats_wgmma`` on the tensor cores in bf16,
   ``conv1_1_stats_tf32x3`` by 3xTF32 in f32, its statistics bit-identical
   on a second call and printed against a float64 sum; the CUDA-core
   ``conv1_1_stats`` held and timed on the inputs of both dtypes, beside
   ``F.conv2d`` bf16 3 -> 64, the nearest library call to its z half), B
   (``conv1_1_bwd_wgmma`` in bf16, ``conv1_1_bwd_tf32x3`` in f32, the
   CUDA-core ``conv1_1_bwd`` on the inputs of both dtypes; its fold of the
   statistics' cotangents held: S = 0, ds27 = 0 or the next image's S
   each move the plain dx by more than ten tolerances), each timed in both
   dtypes by CUDA events and by the kernels' time under
   ``torch.profiler``, C (``conv3x3_relu_pool_wgmma``,
   K2's mainloop with a pool epilogue, in bf16;
   ``conv3x3_relu_pool_tf32x3``, the 3xTF32 mainloop with the pool
   epilogue, in f32; the CUDA-core ``conv3x3_relu_pool`` held against the
   plain version on the f32 inputs too), D (``pool_route_wgmma`` on the
   tensor cores in bf16, ``pool_route_tf32x3`` by 3xTF32 in f32; the
   CUDA-core ``pool_route_conv3x3_bwd`` held against the plain version in
   f32 too); each call on its route's kernel; the tensor-core C and D
   timed beside the CUDA-core kernel on the same inputs and K2's forward
   or dx at the same shape, C also beside the three-call composition
   ``F.max_pool2d(F.relu(F.conv2d(...)), 2, return_indices=True)``:
   z, dx, pooled and dz max-abs error <= 1e-2 *
   max|plain| in bf16 and <= 1e-4 * max|plain| in f32; PᵀP and s27
   relative Frobenius error <= 1e-4 (sums of 2¹⁸ terms per image, taken in
   another order); idx equal wherever the plain top two of the window
   differ by more than the output tolerance;
   stage 1 v3 at the same shapes, bf16 and f32: E ``conv1_1_gram`` (z as
   A's, g64 relative Frobenius error <= 1e-4) and F ``conv1_1_gram_bwd``
   (dx as B's); K10c and K10d are C and D at the shapes above;
   K8, C and D at conv2_2's, conv3_4's and conv4_4's shapes (4 x 256² x 128,
   4 x 128² x 256, 4 x 64² x 512), bf16 and f32, with C's and D's
   tolerances, routes and comparisons, each timed in both dtypes;
   K9, G ``raster_2d``, at 512² x 4, ico-sphere level 4, against its plain
   version (pix_to_face exactly equal, zbuf within rtol 1e-6), then at level
   7 (327,680 faces) against K1: zbuf bit-equal, ids different only at
   exact 1/z ties (both faces cover the pixel with bit-equal 1/z), counted.
   Times are CUDA-event means after warm-up (bf16). Each kernel's bound is
   the larger of the bytes it must move over 3.35 TB/s and its operations
   over the H100's peak for their type (989 TFLOP/s bf16 tensor, 67
   TFLOP/s float32). A raster kernel's operations are counted on the
   (pixel, face) pairs the function needs on this data (each pixel against
   the faces whose bbox, widened by the soft margin or the top-K window,
   holds it; for K7's 1/z plane only the eligible ones), not on the pairs
   the kernel's chunk cull leaves. The library time is one PyTorch call
   computing the same function where there is one (``F.conv2d``,
   ``torch.bmm``); K2 and K3 print each shape's TFLOP/s. The f32 K2 is
   timed against ``F.conv2d`` in f32 with TF32 off (and, for information,
   on), the f32 K3 against ``torch.bmm`` in f32 with TF32 off; the bounds
   of the f32 K2, K3, A, B, C and D count three TF32 products at 495
   TFLOP/s. The CUDA-core K3, A, B, C and D are timed in f32 on the
   3xTF32 kernels' inputs (the route f32 took before), at the fp32 rate.
3. The second approach (``st3d_torch.second_approach.main``) at 512², 4
   views, batch 4, bf16, 20 epochs on a seeded synthetic scene, on the
   default VGG route: every loss finite, the last below the first,
   ``final.obj`` and ``final_render/`` written, all seven kernels launched
   (K2, K3, A, B, C and D only on the tensor cores: no ``conv3x3_nhwc``,
   ``conv1_1_stats``, ``conv1_1_bwd``, ``conv3x3_relu_pool`` or
   ``pool_route_conv3x3_bwd`` launch on any bf16 route, no ``gram_nhwc``
   on any but the two below).
   Then 5 epochs each on PR 1's route (``ST3D_NO_STAGE1_V2=1
   ST3D_NO_PACKED1=1``: K1-K3 only) and on the K5 route
   (``ST3D_NO_STAGE1_V2=1``: C and D, not A and B), where conv1_1's
   27-wide PᵀP takes ``gram_nhwc`` exactly once a step, and 20 epochs each on
   the v3 route (``ST3D_STAGE1=v3``: E and F, not A and B) and the
   fused-pool route (``ST3D_FUSED_POOL=1``: the default's kernels, C and D
   four times as often, ``conv3x3_wgmma`` three times fewer for each C and
   each D).
   Then the texture step in float32, the CLIs' default dtype, 10 epochs on
   the default route: K2, K3, C and D only on their 3xTF32 kernels
   (``conv3x3_tf32x3``, ``gram_tf32x3`` four times a step,
   ``conv3x3_relu_pool_tf32x3`` once a step, ``pool_route_tf32x3``; A
   and B by 3xTF32, ``conv1_1_stats_tf32x3`` and ``conv1_1_bwd_tf32x3``;
   no launch of ``conv3x3_nhwc``, ``gram_nhwc``, ``conv3x3_relu_pool``,
   ``pool_route_conv3x3_bwd``, ``conv1_1_stats`` or ``conv1_1_bwd``); its
   median step.
   B once a step in the bf16 default and fused-pool runs and the f32 run,
   A once a step plus the same set-up launches in each.
   Then the vertex optimisation, ``--optimization_target both`` at 512², 4
   views, bf16, 10 epochs, in four raster modes: hard at ico level 4 (K1),
   ``--soft_raster true`` (K1's soft mode), ``--soft_raster true
   --faces_per_pixel 4`` (K7) and hard at level 7, 327,680 faces (K6); then
   ``--optimization_target mesh`` with the hard blur window
   (``--blur_radius 1e-4 --faces_per_pixel 2``: K7 with slack slots). Each:
   finite losses, the last below the first, the vertices of ``final.obj``
   moved, and the mode's raster kernel launched once per step plus once
   each for the content render and the final render (and, with the blur
   window, the two saturation checks), beside the VGG kernels; the median
   step time of the last 5 epochs. Then K6 on the faces of the 327,680-face
   run as its ``final.obj`` holds them (``raster_stream_run_check``): hard
   and soft bit-equal to K1's outputs and to the every-chunk walk, ids (and
   nearest) bit-equal to the plain version at 64² to 128², the counts and
   the times of both walks and K1.
4. The first approach (``st3d_torch.first_approach.main``) at 512², 4 views,
   batch 4, bf16, 30 style-transfer and 20 MSE steps: finite losses, the MSE
   loss falling, four ``2d_style_transfer/`` views, 12 ``final_render/``
   views and ``final.obj``, all seven kernels launched; then the ms per
   hot-loop-A step (``style_transfer`` at the same shape, after warm-up),
   on the default route and on v3.
   Then ``--optimization_target both`` (hard, level 4, 5 + 5 steps): finite
   losses, falling after the first MSE step (whose Adam update moves every
   vertex coordinate by lr, as in the JAX package), K1 once per MSE step.
5. Both entry points at 64² f32 on the GPU against the same runs on the CPU
   (plain versions), the second approach with ``--optimization_target
   both --soft_raster true``, and the second approach on the v3 and
   fused-pool routes: losses within rtol 1e-3; and the second approach at
   64² in bf16 on the default route (the tensor-core K2, K3, A, B, C and
   D): losses within rtol 1e-2. Each GPU run must take K2, C and D on its
   dtype's route, and A and B on theirs (none on v3), and the f32
   fused-pool run C and D four times as often as the f32 default run.
6. The wall seconds of each phase, the card's name and power limit, one
   JSON line with the kernels' results (ptxas's registers and spills of
   the tensor-core kernels are printed after the build), then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SIZE = 512
VIEWS = 4
EPOCHS = 20
ROUTE_EPOCHS = 5
ST_STEPS = 30
MSE_STEPS = 20
ICO_LEVEL = 4
STREAM_LEVEL = 7                 # 327,680 faces: past the resident budget
BOTH_EPOCHS = 10
FA_BOTH_STEPS = 5
F32_EPOCHS = 10                  # the f32 texture step (the CLI default)
HBM_BYTES_S = 3.35e12            # H100 SXM
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# The VGG routes: the switches each sets, and the kernels it must launch.
# In bf16 every K2, K3, A, B, C and D launch takes the tensor-core kernels;
# the CUDA-core ones (float32, odd widths) run only conv1_1's 27-wide PᵀP
# Gram, once a step, on the two routes with stage 1 off.
KERNELS = ("raster_hard", "conv3x3_wgmma", "gram_wgmma",
           "conv1_1_stats_wgmma", "conv1_1_bwd_wgmma",
           "conv3x3_relu_pool_wgmma", "pool_route_wgmma")
# The default route in float32: K2, K3, A, B, C and D on 3xTF32 (no
# conv3x3_nhwc, gram_nhwc, conv1_1_stats, conv1_1_bwd, conv3x3_relu_pool
# or pool_route_conv3x3_bwd: every width they meet fits the tensor cores).
F32_KERNELS = {"raster_hard", "conv3x3_tf32x3", "gram_tf32x3",
               "conv1_1_stats_tf32x3", "conv1_1_bwd_tf32x3",
               "conv3x3_relu_pool_tf32x3", "pool_route_tf32x3"}
RASTER_KERNELS = ("raster_hard", "raster_soft", "raster_stream",
                  "raster_topk")
# The vertex-optimisation runs: target, extra flags, ico level, the raster
# kernel. The hard blur window (K7 with slack slots) also rasterizes twice
# more for the saturation diagnostic, at the first render and the final one.
VERTEX_RUNS = {
    "hard": ("both", [], ICO_LEVEL, "raster_hard"),
    "soft": ("both", ["--soft_raster", "true"], ICO_LEVEL, "raster_soft"),
    "softras": ("both", ["--soft_raster", "true", "--faces_per_pixel", "4"],
                ICO_LEVEL, "raster_topk"),
    "stream": ("both", [], STREAM_LEVEL, "raster_stream"),
    "blur": ("mesh", ["--blur_radius", "1e-4", "--faces_per_pixel", "2"],
             ICO_LEVEL, "raster_topk"),
}
# Operations per (pixel, face) pair as the kernels run them. Hard: 4 affine
# planes (2 mul + 2 add each) and 4 compares. Soft adds the signed distance
# (3 mul, 2 min), the bbox distance (4 sub, 3 min), their min and 1
# compare. Top-K: every pair gets the 3 barycentric planes and the soft
# distance with its compare ("test"); only eligible pairs (sd > -window)
# get the 1/z plane and its compare with the K-th slot ("eligible").
# Insertions into the K slots are not counted.
PAIR_OPS = {"hard": 20, "soft": 34, "topk_test": 26, "topk_eligible": 5}
V3_KERNELS = ("conv1_1_gram", "conv1_1_gram_bwd")
ROUTE_ENV = ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1",
             "ST3D_FUSED_POOL")
ROUTES = {
    "default": ({}, set(KERNELS)),
    "v3": ({"ST3D_STAGE1": "v3"},
           set(KERNELS) - {"conv1_1_stats_wgmma", "conv1_1_bwd_wgmma"}
           | set(V3_KERNELS)),
    "fused_pool": ({"ST3D_FUSED_POOL": "1"}, set(KERNELS)),
    "pr1": ({"ST3D_NO_STAGE1_V2": "1", "ST3D_NO_PACKED1": "1"},
            {"raster_hard", "conv3x3_wgmma", "gram_wgmma", "gram_nhwc"}),
    "k5": ({"ST3D_NO_STAGE1_V2": "1"},
           {"raster_hard", "conv3x3_wgmma", "gram_wgmma", "gram_nhwc",
            "conv3x3_relu_pool_wgmma", "pool_route_wgmma"}),
}
STAGE1_OFF = ("pr1", "k5")     # conv1_1's PᵀP: one gram_nhwc launch a step
# (Cin, Cout, H) of the convs K2 runs at 512² (conv1_2 .. conv5_1).
VGG_K2_CONVS = [
    (64, 64, 512), (64, 128, 256), (128, 128, 256), (128, 256, 128),
    (256, 256, 128), (256, 256, 128), (256, 256, 128), (256, 512, 64),
    (512, 512, 64), (512, 512, 64), (512, 512, 64), (512, 512, 32),
]
GRAM_SHAPES = [(256, 128), (128, 256), (64, 512), (32, 512)]   # (H, C)
# (Cin = Cout, H) of the pre-pool convs K8 runs at 512²: conv2_2, conv3_4,
# conv4_4.
K8_CONVS = [(128, 256), (256, 128), (512, 64)]


def fail(msg):
    raise RuntimeError(msg)


def smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(
            ).splitlines()[0]


def bound(flops, nbytes, rate):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def plain_in_float32():
    """The plain versions' float32 matmuls and convolutions in full float32
    (PyTorch's default takes TF32 in cuDNN), as every float32 tolerance
    here assumes."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def with_bound(rec, flops, nbytes, rate, library_ms=None):
    rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, rate)
    rec["library_ms"] = library_ms
    return rec


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_phase():
    import torch
    from st3d_torch.kernels import build

    print(smi())
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.2f}s "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    for name in build.WGMMA_SOURCES:
        for line in build.ptxas_report(name):
            print(f"{name}: {line}")


@functools.lru_cache(maxsize=None)
def sphere(level):
    """The ico-sphere at ``level`` on the CPU (built once: level 7 takes
    seconds in Python)."""
    from st3d_torch.core.primitives import ico_sphere

    return ico_sphere(level=level)


def sphere_faces(dev, level, size):
    """Screen face verts (VIEWS, F, 3, 3) of the ico-sphere at ``level``
    under the fixed cameras, and the preprocessed coefficients."""
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.kernels.raster import preprocess
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = sphere(level).to(dev)
    cams = build_fixed_cameras(VIEWS, seed=0).to(dev)
    fv = face_verts_screen(mesh.verts, mesh.faces, cams, size)
    coeffs, bounds, _ = preprocess(fv)
    return fv, coeffs, bounds


def tested_pairs(bounds, size, tile, margin):
    """(pixel, face) pairs a culling kernel tests on this data: the chunks
    whose row band meets each tile's rows (+ margin), 128 faces each (a
    property of the kernels' design, printed beside the pairs needed)."""
    from st3d_torch.kernels.raster import FACE_CHUNK, _band_overlap

    ov = _band_overlap(bounds, size, size, tile, margin)
    return int(ov.sum()) * tile * FACE_CHUNK


def _bbox_spans(coeffs, size, margin):
    """Per face (N, F_pad): the first pixel column and row inside its screen
    bbox (coefficient rows 15-18) widened by ``margin``, and how many
    columns and rows (int64); empty for invalid and padding faces."""
    import torch

    box = coeffs[:, 15:19, :]                   # xmin, xmax, ymin, ymax
    lo = torch.ceil(torch.clamp(box[:, 0::2] - margin, min=0.0))
    hi = torch.floor(torch.clamp(box[:, 1::2] + margin, max=size - 1.0))
    n = (hi - lo + 1.0).clamp(min=0.0).long()
    return lo[:, 0].long(), lo[:, 1].long(), n[:, 0], n[:, 1]


def needed_pairs(coeffs, size, margin):
    """(pixel, face) pairs the function needs on this data: for each pixel,
    the faces whose bbox widened by ``margin`` holds it."""
    _, _, nx, ny = _bbox_spans(coeffs, size, margin)
    return int((nx * ny).sum())


def eligible_pairs(coeffs, size, window):
    """Of ``needed_pairs(coeffs, size, window)``, those with signed distance
    > -window (the top-K kernel's eligibility), evaluated view by view with
    the kernels' expressions."""
    import torch
    from st3d_torch.kernels.raster import SOFT_ROWS, _chunk_planes

    x0, y0, nx, ny = _bbox_spans(coeffs, size, window)
    total = 0
    for v in range(coeffs.shape[0]):
        cnt = nx[v] * ny[v]
        f = torch.repeat_interleave(torch.arange(cnt.numel(),
                                                 device=cnt.device), cnt)
        local = (torch.arange(f.numel(), device=f.device)
                 - (torch.cumsum(cnt, 0) - cnt)[f])
        px = (x0[v, f] + local % nx[v, f]).float()
        py = (y0[v, f] + local // nx[v, f]).float()
        sd = _chunk_planes(coeffs[v, :SOFT_ROWS, f], px, py, soft=True)[4]
        total += int((sd > -window).sum())
    return total


def raster_bytes(coeffs, rows, aux, out_bytes_per_px, size):
    """Bytes a raster kernel must move: the coefficient rows it reads, its
    bounds or ranges, and its outputs."""
    n, _, f_pad = coeffs.shape
    return (n * rows * f_pad * 4 + aux.numel() * aux.element_size()
            + n * size * size * out_bytes_per_px)


def raster_check(dev):
    import torch
    from st3d_torch.kernels.raster import raster_hard, raster_hard_plain

    fv, coeffs, bounds = sphere_faces(dev, ICO_LEVEL, SIZE)
    p2f_k, z_k = raster_hard(coeffs, bounds, SIZE, SIZE)
    p2f_p, z_p = raster_hard_plain(coeffs, bounds, SIZE, SIZE)
    torch.cuda.synchronize()
    mismatch = int((p2f_k != p2f_p).sum())
    hit = p2f_p >= 0
    zerr = float((z_k - z_p).abs().max())
    zrel = float(((z_k - z_p).abs() / z_p.abs())[hit].max())
    covered = float(hit.float().mean())
    print(f"K1 raster_hard: {fv.shape[1]} faces, coverage {covered:.4f}, "
          f"pix_to_face mismatches {mismatch}, zbuf max rel err {zrel:.3g}")
    if mismatch:
        fail(f"K1 pix_to_face differs from its plain version at {mismatch} px")
    if zrel > 1e-6:
        fail(f"K1 zbuf rel err {zrel} > 1e-6")
    if covered < 0.05:
        fail(f"K1 test scene covers only {covered} of the pixels")
    ms = cuda_ms(lambda: raster_hard(coeffs, bounds, SIZE, SIZE))
    plain_ms = cuda_ms(lambda: raster_hard_plain(coeffs, bounds, SIZE, SIZE),
                       reps=3, warmup=1)
    pairs = needed_pairs(coeffs, SIZE, 0.0)
    print(f"K1 raster_hard: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"{pairs} pairs needed (bbox), "
          f"{tested_pairs(bounds, SIZE, 256, 0.0)} tested")
    return with_bound({"name": "raster_hard", "route": "cuda",
                       "source": "st3d_torch/csrc/raster_hard.cu",
                       "replaces": "st3d/kernels/raster_pallas.py:134",
                       "max_abs_err": zerr, "ms": ms, "plain_ms": plain_ms},
                      pairs * PAIR_OPS["hard"],
                      raster_bytes(coeffs, 12, bounds, 8, SIZE), F32_FLOPS)


def raster_soft_check(dev):
    """K1's soft mode against its plain version (and its hard outputs
    against K1) at the main path's shapes."""
    import torch
    from st3d_torch.kernels import raster as kr

    _, coeffs, bounds = sphere_faces(dev, ICO_LEVEL, SIZE)
    margin = kr.soft_cull_margin(1.0)
    tile = kr.cull_tile(SIZE, SIZE, True)
    p2f, z, near = kr.raster_soft(coeffs, bounds, SIZE, SIZE, margin, tile)
    p2f_p, z_p, near_p = kr.raster_soft_plain(coeffs, bounds, SIZE, SIZE,
                                              margin, tile)
    p2f_h, z_h = kr.raster_hard(coeffs, bounds, SIZE, SIZE)
    torch.cuda.synchronize()
    bad = int((p2f != p2f_p).sum()) + int((near != near_p).sum())
    hit = p2f_p >= 0
    zerr = float((z - z_p).abs().max())
    zrel = float(((z - z_p).abs() / z_p.abs())[hit].max())
    print(f"K1 raster_soft: pix_to_face + nearest mismatches {bad}, zbuf "
          f"max rel err {zrel:.3g}, equal to K1's hard outputs "
          f"{torch.equal(p2f, p2f_h) and torch.equal(z, z_h)}")
    if bad or zrel > 1e-6:
        fail(f"K1 soft differs from its plain version: {bad} ids, zbuf "
             f"rel {zrel}")
    if not (torch.equal(p2f, p2f_h) and torch.equal(z, z_h)):
        fail("K1 soft's pix_to_face/zbuf differ from K1's")
    ms = cuda_ms(lambda: kr.raster_soft(coeffs, bounds, SIZE, SIZE, margin,
                                        tile))
    plain_ms = cuda_ms(lambda: kr.raster_soft_plain(
        coeffs, bounds, SIZE, SIZE, margin, tile), reps=3, warmup=1)
    pairs = needed_pairs(coeffs, SIZE, margin)
    print(f"K1 raster_soft: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"{pairs} pairs needed (bbox + {margin} px), "
          f"{tested_pairs(bounds, SIZE, tile, margin)} tested")
    return with_bound({"name": "raster_soft", "route": "cuda",
                       "source": "st3d_torch/csrc/raster_soft.cu",
                       "replaces": "st3d/kernels/raster_pallas.py:202",
                       "max_abs_err": zerr, "ms": ms, "plain_ms": plain_ms},
                      pairs * PAIR_OPS["soft"],
                      raster_bytes(coeffs, 19, bounds, 12, SIZE), F32_FLOPS)


def raster_topk_check(dev):
    """K7 against its plain version: K=4 with SoftRas's 3 px window, and
    K+slack=5 with the window of blur_radius 1e-4 (the hard blur path)."""
    import torch
    from st3d_torch.kernels import raster as kr
    from st3d_torch.render.topk import blur_window_px

    _, coeffs, bounds = sphere_faces(dev, ICO_LEVEL, SIZE)
    cases = {"softras": (4, 3.0), "blur": (5, blur_window_px(1e-4, SIZE))}
    id_err, mismatches = 0, 0
    for what, (k, window) in cases.items():
        ids = kr.raster_topk(coeffs, bounds, SIZE, SIZE, k, window)
        ids_p = kr.raster_topk_plain(coeffs, bounds, SIZE, SIZE, k, window)
        torch.cuda.synchronize()
        bad = int((ids != ids_p).sum())
        id_err = max(id_err, int((ids - ids_p).abs().max()))
        mismatches += bad
        filled = [float((ids[..., s] >= 0).float().mean()) for s in range(k)]
        print(f"K7 raster_topk {what} K={k} window {window:.3f}: id "
              f"mismatches {bad}, filled share per slot "
              + " ".join(f"{f:.3f}" for f in filled))
        if bad:
            fail(f"K7 {what}: {bad} ids differ from the plain version")
    k, window = cases["softras"]
    ms = cuda_ms(lambda: kr.raster_topk(coeffs, bounds, SIZE, SIZE, k,
                                        window))
    plain_ms = cuda_ms(lambda: kr.raster_topk_plain(
        coeffs, bounds, SIZE, SIZE, k, window), reps=2, warmup=1)
    pairs = needed_pairs(coeffs, SIZE, window)
    eligible = eligible_pairs(coeffs, SIZE, window)
    print(f"K7 raster_topk K={k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, {pairs} pairs needed (bbox + {window} px), {eligible} of "
          f"them eligible, {tested_pairs(bounds, SIZE, 256, window + 2.0)} "
          f"tested")
    # max_abs_err: the largest |id - plain id| over both cases.
    return with_bound({"name": "raster_topk", "route": "cuda",
                       "source": "st3d_torch/csrc/raster_topk.cu",
                       "replaces": "st3d/kernels/raster_pallas.py:693",
                       "max_abs_err": float(id_err),
                       "id_mismatches": mismatches, "ms": ms,
                       "plain_ms": plain_ms},
                      pairs * PAIR_OPS["topk_test"]
                      + eligible * PAIR_OPS["topk_eligible"],
                      raster_bytes(coeffs, 19, bounds, 4 * k, SIZE),
                      F32_FLOPS)


def stream_counts(coeffs, bounds, ranges, size):
    """K6's work in hard mode on these faces, over the 256-pixel blocks (at
    512² each lies in one image row): the chunks walked by the TPU kernel's
    walk (the ranges' lengths), the chunks whose row band meets the block's
    rows (the ones the redesigned kernel tests), the faces of those chunks
    whose own y-extent meets the rows, the faces of the mesh that do, and
    the (pixel, face) pairs needed."""
    import torch
    from st3d_torch.kernels.raster import FACE_CHUNK, _band_overlap

    n, _, f_pad = coeffs.shape
    per_row = size // 256                   # blocks a row
    ov = _band_overlap(bounds, size, size, 256, 0.0)    # (N, blocks, chunks)
    spans = (ranges[..., 1] - ranges[..., 0] + 1).clamp(min=0)
    # Faces meeting row r: ymin <= r <= ymax, by a difference array per
    # chunk (padding faces have ymin 1e9 and meet none).
    lo = torch.ceil(coeffs[:, 17]).clamp(0, size).long()
    hi = (torch.floor(coeffs[:, 18]) + 1).clamp(0, size).long()
    hi = torch.maximum(hi, lo)
    chunk = (torch.arange(f_pad, device=coeffs.device) // FACE_CHUNK
             ).expand(n, f_pad)
    diff = torch.zeros((n, f_pad // FACE_CHUNK, size + 1),
                       device=coeffs.device)
    ones = torch.ones_like(coeffs[:, 17])
    diff.view(n, -1).scatter_add_(1, chunk * (size + 1) + lo, ones)
    diff.view(n, -1).scatter_add_(1, chunk * (size + 1) + hi, -ones)
    rows = torch.cumsum(diff, dim=2)[:, :, :size]       # (N, chunks, rows)
    block_rows = rows.repeat_interleave(per_row, dim=2).transpose(1, 2)
    return {"walked": int(spans.sum()), "tested": int(ov.sum()),
            "faces_in_tested": int((block_rows * ov).sum()),
            "faces_in_rows": int(rows.sum()) * per_row,
            "pairs": needed_pairs(coeffs, size, 0.0)}


def _stream_pair(kr, coeffs, bounds, size, soft):
    """K6 (redesigned) and its every-chunk twin on the same inputs, each
    with its tested-chunk count: fails unless all outputs are equal."""
    import torch

    tile = kr.cull_tile(size, size, soft)
    margin = kr.soft_cull_margin(1.0) if soft else 0.0
    ranges = kr.stream_ranges(bounds, size, size, tile, margin)
    cnt = torch.zeros(2, dtype=torch.int64, device=coeffs.device)
    got = kr.raster_stream(coeffs, bounds, ranges, size, size, tile, soft,
                           margin, cnt[0:1])
    old = kr.raster_stream_every_chunk(coeffs, bounds, ranges, size, size,
                                       tile, soft, margin, cnt[1:2])
    torch.cuda.synchronize()
    for a, b in zip(got, old):
        if a is not None and not torch.equal(a, b):
            fail(f"K6 soft={soft} differs from its every-chunk walk")
    return got, ranges, tile, margin, int(cnt[0]), int(cnt[1])


def raster_stream_check(dev):
    """K6 forced at 81,920 faces x 256² against its plain version (hard and
    soft), then at 327,680 faces x 512² x 4 against K1 (bit-equal
    pix_to_face and zbuf, hard and soft); every call also against the TPU
    kernel's walk (``raster_stream_every_chunk``, all outputs equal), with
    the chunks each tested."""
    import torch
    from st3d_torch.kernels import raster as kr

    size = 256
    _, coeffs, bounds = sphere_faces(dev, 6, size)
    plain_ms, zerr = None, 0.0
    for soft in (False, True):
        got, ranges, tile, _, n_new, n_old = _stream_pair(kr, coeffs, bounds,
                                                          size, soft)
        t0 = time.perf_counter()
        want = kr.raster_stream_plain(coeffs, ranges, size, size, tile, soft)
        torch.cuda.synchronize()
        if not soft:
            plain_ms = 1e3 * (time.perf_counter() - t0)
        bad = int((got[0] != want[0]).sum())
        if soft:
            bad += int((got[2] != want[2]).sum())
        hit = want[0] >= 0
        zrel = float(((got[1] - want[1]).abs() / want[1].abs())[hit].max())
        zerr = max(zerr, float((got[1] - want[1]).abs().max()))
        print(f"K6 raster_stream soft={soft} {coeffs.shape[2]} padded faces "
              f"{size}²: id mismatches {bad}, zbuf max rel err {zrel:.3g}, "
              f"chunks tested {n_new} of {n_old} walked")
        if bad or zrel > 1e-6:
            fail(f"K6 soft={soft} differs from its plain version")

    _, coeffs, bounds = sphere_faces(dev, STREAM_LEVEL, SIZE)
    if not kr.use_stream(coeffs.shape[2]):
        fail("the level-7 sphere does not pass the resident budget")
    for soft in (False, True):
        got, ranges, tile, margin, n_new, n_old = _stream_pair(
            kr, coeffs, bounds, SIZE, soft)
        want = (kr.raster_soft(coeffs, bounds, SIZE, SIZE, margin, tile)
                if soft else kr.raster_hard(coeffs, bounds, SIZE, SIZE))
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        zerr = max(zerr, float((got[1] - want[1]).abs().max()))
        near = (f", nearest equal at "
                f"{float((got[2] == want[2]).float().mean()):.6f}"
                if soft else "")
        print(f"K6 vs K1 soft={soft} at {coeffs.shape[2]} padded faces x "
              f"{SIZE}² x {VIEWS}: pix_to_face and zbuf bit-equal {same}"
              + near + f"; chunks tested {n_new} of {n_old} walked")
        if not same:
            fail(f"K6 soft={soft} differs from K1 at 327,680 faces")
        if not soft:
            hard = (tile, ranges)
    tile, ranges = hard
    ms = cuda_ms(lambda: kr.raster_stream(coeffs, bounds, ranges, SIZE, SIZE,
                                          tile, False), reps=10)
    old_ms = cuda_ms(lambda: kr.raster_stream_every_chunk(
        coeffs, bounds, ranges, SIZE, SIZE, tile, False), reps=3, warmup=1)
    k1_ms = cuda_ms(lambda: kr.raster_hard(coeffs, bounds, SIZE, SIZE),
                    reps=3, warmup=1)
    cnt = stream_counts(coeffs, bounds, ranges, SIZE)
    print(f"K6 raster_stream hard at 327,680 faces (pristine sphere): kernel "
          f"{ms:.3f} ms, every-chunk walk {old_ms:.3f} ms, K1 on the same "
          f"faces {k1_ms:.3f} ms, plain (81,920 faces, 256²) "
          f"{plain_ms:.1f} ms; counts " + json.dumps(cnt))
    # max_abs_err: the largest zbuf error against the plain version (81,920
    # faces) and against K1 (327,680 faces), hard and soft.
    rec = {"name": "raster_stream", "route": "cuda",
           "source": "st3d_torch/csrc/raster_stream.cu",
           "replaces": "st3d/kernels/raster_pallas.py:447",
           "max_abs_err": zerr, "ms": ms, "plain_ms": plain_ms,
           "plain_at": "81,920 faces, 256², 4 views (the plain version at "
                       "327,680 faces x 512² would take minutes)",
           "every_chunk_ms": old_ms, "k1_ms": k1_ms, "counts": cnt}
    return with_bound(rec, cnt["pairs"] * PAIR_OPS["hard"],
                      raster_bytes(coeffs, 12, ranges, 8, SIZE), F32_FLOPS)


def raster_stream_run_check(dev, obj, rec):
    """K6 on the faces of the 327,680-face vertex run as they stand after
    its epochs (its ``final.obj`` under the run's fixed cameras), where one
    stretched face widens its chunk's band: the counts of
    ``stream_counts``; hard and soft equal to the every-chunk walk, hard
    outputs bit-equal to K1's (soft: to K1-soft's); ids and nearest
    bit-equal to the plain version on the same faces at the largest of
    128², 96² and 64² whose walk the plain version finishes in seconds;
    times. Updates ``rec`` (the K6 row) with these faces' time and bound."""
    import torch
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.io.obj import load_obj
    from st3d_torch.kernels import raster as kr
    from st3d_torch.render.rasterize import face_verts_screen

    data = load_obj(obj, load_textures=False)
    verts = torch.tensor(data.verts, device=dev)
    faces = torch.tensor(data.faces, device=dev).long()
    cams = build_fixed_cameras(VIEWS, seed=0).to(dev)

    def faces_at(size):
        return kr.preprocess(face_verts_screen(verts, faces, cams, size))[:2]

    coeffs, bounds = faces_at(SIZE)
    for soft in (False, True):
        got, ranges, tile, margin, n_new, n_old = _stream_pair(
            kr, coeffs, bounds, SIZE, soft)
        want = (kr.raster_soft(coeffs, bounds, SIZE, SIZE, margin, tile)
                if soft else kr.raster_hard(coeffs, bounds, SIZE, SIZE))
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        print(f"K6 on the vertex run's faces soft={soft}: pix_to_face and "
              f"zbuf bit-equal to K1 {same}, equal to the every-chunk walk; "
              f"chunks tested {n_new} of {n_old} walked")
        if not same:
            fail(f"K6 soft={soft} differs from K1 on the run's faces")
        if not soft:
            hard = (tile, ranges)
    tile, ranges = hard
    ms = cuda_ms(lambda: kr.raster_stream(coeffs, bounds, ranges, SIZE, SIZE,
                                          tile, False), reps=10)
    old_ms = cuda_ms(lambda: kr.raster_stream_every_chunk(
        coeffs, bounds, ranges, SIZE, SIZE, tile, False), reps=3, warmup=1)
    k1_ms = cuda_ms(lambda: kr.raster_hard(coeffs, bounds, SIZE, SIZE),
                    reps=3, warmup=1)
    ranges_ms = cuda_ms(lambda: kr.stream_ranges(bounds, SIZE, SIZE, tile,
                                                 0.0), reps=3, warmup=1)
    cnt = stream_counts(coeffs, bounds, ranges, SIZE)
    print(f"K6 raster_stream hard on the vertex run's faces: kernel "
          f"{ms:.3f} ms, every-chunk walk {old_ms:.3f} ms, K1 {k1_ms:.3f} "
          f"ms, stream_ranges {ranges_ms:.3f} ms; counts " + json.dumps(cnt))
    # The plain version tests every pair its ranges hold: the largest size
    # whose walk holds at most 2e9 pairs.
    for size in (128, 96, 64):
        c_s, b_s = faces_at(size)
        walked = 0
        for soft in (False, True):
            t = kr.cull_tile(size, size, soft)
            r = kr.stream_ranges(b_s, size, size, t,
                                 kr.soft_cull_margin(1.0) if soft else 0.0)
            walked = max(walked, int((r[..., 1] - r[..., 0] + 1).clamp(
                min=0).sum()) * t * kr.FACE_CHUNK)
        if walked <= 2e9 or size == 64:
            break
    plain_ms = None
    for soft in (False, True):
        got, r, t, _, n_new, n_old = _stream_pair(kr, c_s, b_s, size, soft)
        t0 = time.perf_counter()
        want = kr.raster_stream_plain(c_s, r, size, size, t, soft)
        torch.cuda.synchronize()
        if not soft:
            plain_ms = 1e3 * (time.perf_counter() - t0)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if soft:
            same = same and torch.equal(got[2], want[2])
        print(f"K6 on the run's faces at {size}² soft={soft}: ids, zbuf"
              f"{' and nearest' if soft else ''} bit-equal to the plain "
              f"version {same}; chunks tested {n_new} of {n_old} walked")
        if not same:
            fail(f"K6 soft={soft} differs from its plain version on the "
                 f"run's faces at {size}²")
    rec.update({"pristine_ms": rec["ms"], "pristine_bound_ms":
                rec["bound_ms"], "pristine_counts": rec.pop("counts"),
                "ms": ms, "every_chunk_ms": old_ms, "k1_ms": k1_ms,
                "stream_ranges_ms": ranges_ms, "counts": cnt,
                "plain_ms": plain_ms,
                "plain_at": f"the vertex run's faces at {size}², 4 views",
                "faces": "the 327,680-face vertex run's final.obj"})
    with_bound(rec, cnt["pairs"] * PAIR_OPS["hard"],
               raster_bytes(coeffs, 12, ranges, 8, SIZE), F32_FLOPS,
               rec["library_ms"])


def _tie_check(fv, p_a, p_b, z):
    """Where the mesh ids p_a and p_b (N, S, S) differ, both faces must cover
    the pixel with 1/z bit-equal to 1/z (the planes evaluated as the kernels
    do); returns the number of such pixels."""
    import torch
    from st3d_torch.kernels.raster import face_coeffs

    v, y, x = torch.nonzero(p_a != p_b, as_tuple=True)
    planes = face_coeffs(fv)
    for ids in (p_a[v, y, x], p_b[v, y, x]):
        blk = planes[v, :, ids.long()]
        px, py = x.float(), y.float()
        b = [px * blk[:, r] + py * blk[:, r + 1] + blk[:, r + 2]
             for r in (0, 3, 6, 9)]
        cover = (b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0)
        if not (bool(cover.all()) and torch.equal(1.0 / b[3], z[v, y, x])):
            fail("K9 and K1 differ at a pixel that is not an exact 1/z tie")
    return int(v.numel())


def raster_2d_check(dev):
    """K9 against its plain version at 512² x 4, ico level 4, and against K1
    at level 7 (327,680 faces): zbuf bit-equal, ids apart only at ties."""
    import torch
    from st3d_torch.kernels import raster as kr

    fv, coeffs1, bounds1 = sphere_faces(dev, ICO_LEVEL, SIZE)
    coeffs, bounds, _ = kr.preprocess_2d(fv, SIZE)
    p2f, z = kr.raster_2d(coeffs, bounds, SIZE, SIZE)
    p2f_p, z_p = kr.raster_2d_plain(coeffs, bounds, SIZE, SIZE)
    torch.cuda.synchronize()
    mismatch = int((p2f != p2f_p).sum())
    hit = p2f_p >= 0
    zerr = float((z - z_p).abs().max())
    zrel = float(((z - z_p).abs() / z_p.abs())[hit].max())
    print(f"K9 raster_2d level {ICO_LEVEL}: pix_to_face mismatches "
          f"{mismatch}, zbuf max rel err {zrel:.3g}")
    if mismatch or zrel > 1e-6:
        fail(f"K9 differs from its plain version: {mismatch} ids, zbuf rel "
             f"{zrel}")
    ms = cuda_ms(lambda: kr.raster_2d(coeffs, bounds, SIZE, SIZE))
    plain_ms = cuda_ms(lambda: kr.raster_2d_plain(coeffs, bounds, SIZE,
                                                  SIZE), reps=3, warmup=1)
    k1_ms = cuda_ms(lambda: kr.raster_hard(coeffs1, bounds1, SIZE, SIZE))
    ties = {}
    for level in (ICO_LEVEL, STREAM_LEVEL):
        fv = sphere_faces(dev, level, SIZE)[0]
        got = kr.rasterize_2d_batched(fv, SIZE)
        want = kr.rasterize_batched(fv, SIZE, stream=False)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            fail(f"K9 zbuf differs from K1's at level {level}")
        ties[level] = _tie_check(fv, got[0], want[0], got[1])
        print(f"K9 vs K1 at {fv.shape[1]} faces x {SIZE}² x {VIEWS}: zbuf "
              f"bit-equal, ids differ at {ties[level]} px, each an exact "
              f"1/z tie")
    c7, b7, _ = kr.preprocess_2d(fv, SIZE)
    ms7 = cuda_ms(lambda: kr.raster_2d(c7, b7, SIZE, SIZE), reps=3, warmup=1)
    k7 = kr.preprocess(fv)
    k1_ms7 = cuda_ms(lambda: kr.raster_hard(k7[0], k7[1], SIZE, SIZE),
                     reps=3, warmup=1)
    pairs = needed_pairs(coeffs, SIZE, 0.0)
    print(f"K9 raster_2d level {ICO_LEVEL}: kernel {ms:.3f} ms (K1 "
          f"{k1_ms:.3f}), plain {plain_ms:.3f} ms, {pairs} pairs needed "
          f"(bbox); at 327,680 faces {ms7:.3f} ms (K1 {k1_ms7:.3f})")
    rec = {"name": "raster_2d", "route": "cuda",
           "source": "st3d_torch/csrc/raster_2d.cu",
           "replaces": "st3d/kernels/raster_pallas.py:885",
           "max_abs_err": zerr, "ms": ms, "plain_ms": plain_ms,
           "k1_ms": k1_ms, "ms_327680_faces": ms7,
           "k1_ms_327680_faces": k1_ms7,
           "tie_pixels_vs_k1": {str(k): v for k, v in ties.items()},
           "path": "none: no entry point calls K9, in the JAX package or "
                   "the port"}
    return with_bound(rec, pairs * PAIR_OPS["hard"],
                      raster_bytes(coeffs, 12, bounds, 8, SIZE), F32_FLOPS)


def _launched(before):
    """K2/K3 launch counts that moved since ``before``."""
    from st3d_torch.kernels.conv import LAUNCHES

    return {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}


def _conv_operands(gen, dev, cin, cout, h, dtype):
    """x, w (He-scaled), b and a cotangent at batch VIEWS, h x h."""
    import torch

    x = torch.randn((VIEWS, h, h, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((cout,), generator=gen, device=dev)).to(dtype)
    ct = torch.randn((VIEWS, h, h, cout), generator=gen, device=dev).to(dtype)
    return x, w, b, ct


def _conv_fwd_dx(x, w, b, ct, relu, tol, key, what):
    """K2's forward and input gradient through ``conv3x3_nhwc`` against the
    plain versions: max-abs error <= tol * max|plain|; fails unless exactly
    two launches of ``key`` were made. Returns (worst error, text)."""
    import torch
    from st3d_torch.kernels.conv import (
        LAUNCHES, _transpose_conv, conv3x3_nhwc, conv3x3_nhwc_plain,
        transpose_weights)

    before = dict(LAUNCHES)
    y_k = conv3x3_nhwc(x, w, b, relu)
    d_k = _transpose_conv(ct, w)
    torch.cuda.synchronize()
    if _launched(before) != {key: 2}:
        fail(f"K2 {what}: launched {_launched(before)}, want {{{key}: 2}}")
    zb = torch.zeros(x.shape[3], dtype=x.dtype, device=x.device)
    y_p = conv3x3_nhwc_plain(x, w, b, relu)
    d_p = conv3x3_nhwc_plain(ct, transpose_weights(w, ct.dtype), zb)
    worst, errs = 0.0, []
    for part, a, ref in (("fwd", y_k, y_p), ("dx", d_k, d_p)):
        err = float((a.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        errs.append(f"{part} {err:.3g}/{scale:.3g}")
        worst = max(worst, err)
        if not err <= tol * scale:
            fail(f"K2 {what} {part}: max err {err} > {tol} * {scale}")
    return worst, " ".join(errs)


def conv_check(dev):
    """K2 at every VGG conv of the main path (batch 4, 512² input), forward
    and input gradient: in bf16 on the tensor-core kernel, in float32 on the
    3xTF32 tensor-core kernel (conv1_1's odd widths: ``narrow_check``).
    Times (CUDA events) of the 12-conv forward: bf16
    against cuDNN's bf16 ``F.conv2d``, float32 against ``F.conv2d`` in
    float32 with TF32 off (the library time) and, for information, on. The
    3xTF32 bound counts its three products at the TF32 rate."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels.conv import _transpose_conv, conv3x3_nhwc
    from st3d_torch.kernels.conv import conv3x3_nhwc_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    keys = {torch.bfloat16: "conv3x3_wgmma", torch.float32: "conv3x3_tf32x3"}
    # (passes over the products, rate) of each route's bound.
    rates = {torch.bfloat16: (1, BF16_FLOPS), torch.float32: (3, TF32_FLOPS)}
    tot = {k: {"err": 0.0, "ms": 0.0, "dx": 0.0, "plain": 0.0, "lib": 0.0,
               "lib_tf32": 0.0, "bound": 0.0, "flops": 0, "bytes": 0}
           for k in keys.values()}
    for cin, cout, h in VGG_K2_CONVS:
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            key, t = keys[dtype], tot[keys[dtype]]
            x, w, b, ct = _conv_operands(gen, dev, cin, cout, h, dtype)
            relu = cin == cout and h != 32
            what = f"{cin:>3}->{cout:<3} {h:>3}² {str(dtype)[6:]}"
            err, text = _conv_fwd_dx(x, w, b, ct, relu, tol, key, what)
            t["err"] = max(t["err"], err)
            t_k = cuda_ms(lambda: conv3x3_nhwc(x, w, b, relu), 5)
            t_d = cuda_ms(lambda: _transpose_conv(ct, w), 5)
            t_p = cuda_ms(lambda: conv3x3_nhwc_plain(x, w, b, relu), 3, 1)
            # Library yardstick: cuDNN's conv + bias on the same data,
            # channels-last (ReLU not included); float32 with TF32 off, and
            # on for information.
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            t_l = cuda_ms(lambda: F.conv2d(xl, wl, b, padding=1), 5)
            t_l32 = 0.0
            if dtype == torch.float32:
                torch.backends.cudnn.allow_tf32 = True
                t_l32 = cuda_ms(lambda: F.conv2d(xl, wl, b, padding=1), 5)
                torch.backends.cudnn.allow_tf32 = False
            flops = 2 * 9 * cin * cout * h * h * VIEWS
            nbytes = x.element_size() * (VIEWS * h * h * (cin + cout)
                                         + 9 * cin * cout + cout)
            passes, rate = rates[dtype]
            t_b = bound(passes * flops, nbytes, rate)[0]
            for k, v in (("ms", t_k), ("dx", t_d), ("plain", t_p),
                         ("lib", t_l), ("lib_tf32", t_l32), ("bound", t_b),
                         ("flops", flops), ("bytes", nbytes)):
                t[k] += v
            print(f"K2 {key} {what} {text}  kernel {t_k:.3f} ms "
                  f"({flops / t_k / 1e9:.1f} TFLOP/s), dx {t_d:.3f} ms, "
                  f"plain {t_p:.3f} ms, F.conv2d {t_l:.3f} ms"
                  + (f" (TF32 on {t_l32:.3f})" if t_l32 else "")
                  + f", bound {t_b:.4f} ms")
    recs = []
    for dtype, key in keys.items():
        t = tot[key]
        name = str(dtype)[6:]
        lib32 = (f", TF32 on {t['lib_tf32']:.3f} ms"
                 if dtype == torch.float32 else "")
        print(f"K2 {key} one {name} VGG forward (12 convs): kernel "
              f"{t['ms']:.3f} ms ({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s), "
              f"dx {t['dx']:.3f} ms, plain {t['plain']:.3f} ms, F.conv2d "
              f"{t['lib']:.3f} ms ({t['ms'] / t['lib']:.2f}x){lib32}, bound "
              f"{t['bound']:.4f} ms")
        passes, rate = rates[dtype]
        rec = {"name": key, "route": "cuda",
               "source": f"st3d_torch/csrc/{key}.cu",
               "replaces": "st3d/kernels/conv_pallas.py:128",
               "dtype": name, "max_abs_err": t["err"], "ms": t["ms"],
               "dx_ms": t["dx"], "plain_ms": t["plain"],
               "bound_ms": t["bound"],
               "bound_by": bound(passes * t["flops"], t["bytes"], rate)[1],
               "library_ms": t["lib"]}
        if dtype == torch.float32:
            rec["library_ms_tf32_on"] = t["lib_tf32"]
        recs.append(rec)
    return recs


# (Cin, Cout, H) of K2 at the widths TMA cannot stride: conv1_1 and its
# input gradient at the main path's 512², two more odd pairs smaller.
NARROW_CONVS = [(3, 64, SIZE), (64, 3, SIZE), (5, 12, 128), (12, 5, 128)]
NARROW_KEYS = {"bfloat16": "conv3x3_narrow_wgmma",
               "float32": "conv3x3_narrow_tf32x3"}


def _exact_twins(gen, dev, cin, cout, h, dtype, key, what):
    """Forward (with ReLU) and dx on data exact in bf16 and TF32 (x and the
    cotangent in quarters, weights and bias in eighths): every sum is exact
    in float32, so the kernel must equal the plain version bit for bit."""
    import torch
    from st3d_torch.kernels.conv import (LAUNCHES, _transpose_conv,
                                         conv3x3_nhwc, conv3x3_nhwc_plain,
                                         transpose_weights)

    def grid(size, unit):
        return (torch.randint(-4, 5, size, generator=gen, device=dev)
                .float() * unit).to(dtype)

    x, ct = grid((VIEWS, h, h, cin), 0.25), grid((VIEWS, h, h, cout), 0.25)
    w, b = grid((3, 3, cin, cout), 0.125), grid((cout,), 0.125)
    before = dict(LAUNCHES)
    y, dx = conv3x3_nhwc(x, w, b, True), _transpose_conv(ct, w)
    torch.cuda.synchronize()
    if _launched(before) != {key: 2}:
        fail(f"K2 {what} exact twins: launched {_launched(before)}")
    zb = torch.zeros(cin, dtype=dtype, device=dev)
    same = (torch.equal(y, conv3x3_nhwc_plain(x, w, b, True))
            and torch.equal(dx, conv3x3_nhwc_plain(
                ct, transpose_weights(w, dtype), zb)))
    if not same:
        fail(f"K2 {what}: not bit-equal to the plain version on exact data")


def narrow_check(dev):
    """K2 at the widths TMA cannot stride, on the narrow tensor-core
    kernels (bf16 ``conv3x3_narrow_wgmma``, float32 ``conv3x3_narrow_tf32x3``)
    at ``NARROW_CONVS``, batch 4: forward and input gradient against the
    plain version (max-abs error <= 1e-2 * max|plain| in bf16, <= 1e-4 in
    float32), each call on its route's kernel, and the exact-data twins
    bit-equal in both dtypes. At 3 -> 64 and 64 -> 3 (512² x 4), each timed
    (CUDA events over the wrapper's call, and its kernel's device time
    under the profiler) beside the CUDA-core ``conv3x3_nhwc`` (launched by
    no route) and ``F.conv2d`` on the same inputs (float32 with TF32 off).
    The bound is the bytes (x, y and the weights once) over 3.35 TB/s, or
    the products on the tensor cores (float32: three TF32 passes)."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels.conv import (conv3x3_cuda_core, conv3x3_nhwc,
                                         conv3x3_nhwc_plain)

    gen = torch.Generator(device=dev).manual_seed(5)
    recs, core = [], {}
    for dtype, tol, passes, rate in ((torch.bfloat16, 1e-2, 1, BF16_FLOPS),
                                     (torch.float32, 1e-4, 3, TF32_FLOPS)):
        name = str(dtype)[6:]
        key = NARROW_KEYS[name]
        rec = {"name": key, "route": "cuda",
               "source": f"st3d_torch/csrc/{key}.cu",
               "replaces": "st3d/kernels/conv_pallas.py:128", "dtype": name,
               "shape": "3->64 at 512² x 4 (conv1_1); dx_*: 64->3",
               "max_abs_err": 0.0}
        for cin, cout, h in NARROW_CONVS:
            what = f"{cin:>2}->{cout:<2} {h}² {name}"
            x, w, b, ct = _conv_operands(gen, dev, cin, cout, h, dtype)
            err, text = _conv_fwd_dx(x, w, b, ct, False, tol, key, what)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            _exact_twins(gen, dev, cin, cout, h, dtype, key, what)
            if h != SIZE:
                print(f"K2 {key} {what} {text}, exact twins bit-equal")
                continue
            t_k = cuda_ms(lambda: conv3x3_nhwc(x, w, b), 10)
            dev_k = sum(v for k, v in profiled_ms(
                lambda: conv3x3_nhwc(x, w, b))[1].items() if "narrow" in k)
            t_c = cuda_ms(lambda: conv3x3_cuda_core(x, w, b), 5)
            ref = conv3x3_nhwc_plain(x, w, b).float()
            err_c = float((conv3x3_cuda_core(x, w, b).float() - ref).abs()
                          .max())
            if not err_c <= tol * float(ref.abs().max()):
                fail(f"conv3x3_nhwc {what}: max err {err_c}")
            t_p = cuda_ms(lambda: conv3x3_nhwc_plain(x, w, b), 3, 1)
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            t_l = cuda_ms(lambda: F.conv2d(xl, wl, b, padding=1), 10)
            px = VIEWS * h * h
            t_b, by = bound(passes * 2 * 9 * cin * cout * px,
                            x.element_size() * (px * (cin + cout)
                                                + 9 * cin * cout + cout),
                            rate)
            print(f"K2 {key} {what} {text}, exact twins bit-equal; kernel "
                  f"{t_k:.4f} ms ({dev_k:.4f} device), CUDA-core "
                  f"conv3x3_nhwc {t_c:.4f} ms, F.conv2d {t_l:.4f} ms "
                  f"({t_k / t_l:.2f}x), plain {t_p:.3f} ms, bound "
                  f"{t_b:.4f} ms ({by})")
            part = {"ms": t_k, "device_ms": dev_k, "plain_ms": t_p,
                    "bound_ms": t_b, "bound_by": by, "library_ms": t_l,
                    "cuda_core_ms": t_c}
            if cin == 3:
                rec.update(part)
            else:
                rec.update({"dx_" + k: v for k, v in part.items()})
            core.setdefault((cin, cout), {})[name] = (t_c, t_b, by, t_l, t_p,
                                                      err_c)
        recs.append(rec)
    # The CUDA-core kernel, launched by no route: its times above, the bf16
    # 3 -> 64 as its row.
    t_c, t_b, by, t_l, t_p, err_c = core[(3, 64)]["bfloat16"]
    recs.append({"name": "conv3x3_nhwc", "route": "cuda",
                 "source": "st3d_torch/csrc/conv3x3_nhwc.cu",
                 "replaces": "st3d/kernels/conv_pallas.py:128",
                 "dtype": "bfloat16",
                 "shape": "3->64 at 512² x 4 (launched by no route; timed "
                          "beside the narrow kernels)",
                 "max_abs_err": err_c, "ms": t_c, "plain_ms": t_p,
                 "bound_ms": t_b, "bound_by": by, "library_ms": t_l,
                 "times": {f"{ci}->{co} {dt}": v[0] for (ci, co), d in
                           core.items() for dt, v in d.items()}})
    return recs


def gram_check(dev):
    """K3 at the four style-Gram shapes of the main path: bf16 on the
    tensor-core kernel, float32 on the 3xTF32 one (each bit-identical on a
    second call), the CUDA-core kernel held and timed on the same float32
    inputs, plus conv1_1's 27-wide PᵀP in bf16 (CUDA cores, beside one
    ``torch.bmm`` in bf16). Times of the
    four Grams: bf16 against ``torch.bmm`` in bf16 (its output rounded to
    bf16, where K3 keeps float32), float32 against ``torch.bmm`` in float32
    with TF32 off."""
    import torch
    from st3d_torch.kernels.conv import (LAUNCHES, gram_cuda_core, gram_nhwc,
                                         gram_nhwc_plain)

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = {torch.bfloat16: "gram_wgmma", torch.float32: "gram_tf32x3"}
    # (passes over the products, rate) of each kernel's bound.
    rates = {"gram_wgmma": (1, BF16_FLOPS), "gram_tf32x3": (3, TF32_FLOPS),
             "gram_nhwc": (1, F32_FLOPS)}
    tot = {k: {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0,
               "bound": 0.0} for k in rates}
    shapes = [(h * h, c, dtype) for h, c in GRAM_SHAPES
              for dtype in keys] + [(SIZE * SIZE, 27, torch.bfloat16)]

    def held(key, fn, y, g_p, tol):
        """fn(y) twice: one launch of ``key`` each, bit-identical, within
        ``tol`` relative Frobenius of ``g_p``; returns (Gram, text)."""
        before = dict(LAUNCHES)
        g_k = fn(y)
        again = fn(y)
        torch.cuda.synchronize()
        if _launched(before) != {key: 2}:
            fail(f"K3 {key} {tuple(y.shape)}: launched {_launched(before)}, "
                 f"want {{{key}: 2}}")
        if not torch.equal(g_k, again):
            fail(f"K3 {key} {tuple(y.shape)}: differs between calls")
        rel = float(torch.linalg.norm(g_k - g_p) / torch.linalg.norm(g_p))
        text = (f"K3 {key} {tuple(y.shape)} {str(y.dtype)[6:]} rel fro err "
                f"{rel:.3g}, bit-identical on a second call")
        if rel > tol:
            fail(f"{text}: > {tol}")
        tot[key]["err"] = max(tot[key]["err"], float((g_k - g_p).abs().max()))
        return text

    t27 = None
    for pixels, c, dtype in shapes:
        tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
        key = "gram_nhwc" if c == 27 else keys[dtype]
        y = torch.relu(torch.randn((VIEWS, pixels, c), generator=gen,
                                   device=dev)).to(dtype)
        g_p = gram_nhwc_plain(y)
        line = held(key, gram_nhwc, y, g_p, tol)
        if c == 27:
            # conv1_1's PᵀP on the CUDA cores, beside one torch.bmm in bf16
            # (bf16 out, as the bf16 Grams' yardstick).
            t27 = cuda_ms(lambda: gram_nhwc(y))
            t27_lib = cuda_ms(lambda: torch.bmm(y.transpose(1, 2), y))
            t27_b = bound(2 * VIEWS * pixels * c * c,
                          y.element_size() * VIEWS * pixels * c
                          + 4 * VIEWS * c * c, F32_FLOPS)
            print(f"{line}  kernel {t27:.3f} ms, bmm {t27_lib:.3f} ms, bound "
                  f"{t27_b[0]:.4f} ms ({t27_b[1]})")
            continue
        flops = 2 * VIEWS * pixels * c * c
        nbytes = y.element_size() * VIEWS * pixels * c + 4 * VIEWS * c * c
        t_p = cuda_ms(lambda: gram_nhwc_plain(y))
        t_l = cuda_ms(lambda: torch.bmm(y.transpose(1, 2), y))
        timed = [(key, gram_nhwc)]
        if dtype == torch.float32:
            # The CUDA-core kernel float32 took before, on the same inputs.
            print(line)
            line = held("gram_nhwc", gram_cuda_core, y, g_p, tol)
            timed.append(("gram_nhwc", gram_cuda_core))
        print(line)
        for k, fn in timed:
            t_k = cuda_ms(lambda: fn(y))
            passes, rate = rates[k]
            t_b = bound(passes * flops, nbytes, rate)[0]
            for f, v in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                         ("bound", t_b)):
                tot[k][f] += v
            print(f"K3 {k} ({VIEWS},{pixels},{c}) {str(dtype)[6:]}  kernel "
                  f"{t_k:.3f} ms ({flops / t_k / 1e9:.1f} TFLOP/s) plain "
                  f"{t_p:.3f} ms bmm {t_l:.3f} ms bound {t_b:.4f} ms")
    recs = []
    for key, dtype in (("gram_wgmma", "bfloat16"), ("gram_tf32x3", "float32"),
                       ("gram_nhwc", "float32")):
        t = tot[key]
        print(f"K3 {key} the four {dtype} style Grams: kernel "
              f"{t['ms']:.3f} ms, plain {t['plain']:.3f} ms, bmm "
              f"{t['lib']:.3f} ms ({t['ms'] / t['lib']:.2f}x), bound "
              f"{t['bound']:.4f} ms")
        rec = {"name": key, "route": "cuda",
               "source": f"st3d_torch/csrc/{key}.cu",
               "replaces": "st3d/kernels/conv_pallas.py:548",
               "dtype": dtype, "max_abs_err": t["err"], "ms": t["ms"],
               "plain_ms": t["plain"], "bound_ms": t["bound"],
               "bound_by": "operations", "library_ms": t["lib"]}
        if key == "gram_tf32x3":
            rec["cuda_core_ms"] = tot["gram_nhwc"]["ms"]
        if key == "gram_nhwc":
            rec["shapes"] = ("the four f32 style Grams (the widths "
                             "gram_route now sends to gram_tf32x3)")
            rec.update({"ms_27_wide_bf16": t27,
                        "library_ms_27_wide_bf16": t27_lib,
                        "bound_ms_27_wide_bf16": t27_b[0]})
        recs.append(rec)
    return recs


def _max_err(got, ref, tol, what):
    """max|got - ref| against tol * max|ref|; raises past it."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if not err <= tol * scale:
        fail(f"{what}: max err {err} > {tol} * {scale}")
    return err, scale


def _idx_mismatches(idx, idx_ref, pre_pool, tol):
    """idx cells that differ where the plain top two of the window are more
    than ``tol`` apart; also the share of cells so separated."""
    bsz, h, wd, c = pre_pool.shape
    win = pre_pool.float().reshape(bsz, h // 2, 2, wd // 2, 2, c)
    win = win.permute(0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, c, 4)
    top2 = win.sort(dim=-1).values[..., -2:]
    separated = (top2[..., 1] - top2[..., 0]) > tol
    return (int(((idx != idx_ref) & separated).sum()),
            float(separated.float().mean()))


C_KEYS = {"bfloat16": "conv3x3_relu_pool_wgmma",
          "float32": "conv3x3_relu_pool_tf32x3"}
D_KEYS = {"bfloat16": "pool_route_wgmma", "float32": "pool_route_tf32x3"}


def c_versus(x, w, b, c_ms, key, what):
    """Prints the tensor-core C's time beside, on the same inputs, the
    CUDA-core C it replaces, K2's forward (conv + bias + ReLU, no pool) and
    a three-call composition of torch ops (``F.max_pool2d(F.relu(
    F.conv2d(...)), 2, return_indices=True)``: not one library call of the
    same function, its index counts in the whole plane); returns them."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels import conv as kconv

    old = cuda_ms(lambda: kconv.conv3x3_relu_pool_cuda_core(x, w, b), 5)
    k2 = cuda_ms(lambda: kconv.conv3x3_nhwc(x, w, b, True), 5)
    xl = x.permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    comp = cuda_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xl, wl, b, padding=1)),
                                        2, return_indices=True), 5)
    torch.cuda.synchronize()
    print(f"C {what}: {key} {c_ms:.3f} ms, the CUDA-core "
          f"conv3x3_relu_pool on the same inputs {old:.3f} ms, K2's forward "
          f"at the same shape {k2:.3f} ms, the composition max_pool2d(relu("
          f"conv2d)) {comp:.3f} ms")
    return {"cuda_core_ms": old, "k2_fwd_ms": k2, "composition_ms": comp}


def d_versus(ct, pooled, idx, w, d_ms, key, what):
    """Prints the tensor-core D's time beside the CUDA-core D on the same
    inputs and K2's dx (the transpose conv alone, on the routed cotangent
    at full resolution) at the same shape; returns them."""
    import torch
    from st3d_torch.kernels import conv as kconv

    old = cuda_ms(lambda: kconv.pool_route_cuda_core(ct, pooled, idx, w), 5)
    routed = kconv.route_pool_cotangent(ct, pooled, idx)
    dx = cuda_ms(lambda: kconv._transpose_conv(routed, w), 5)
    torch.cuda.synchronize()
    print(f"D {what}: {key} {d_ms:.3f} ms, the CUDA-core "
          f"pool_route_conv3x3_bwd on the same inputs {old:.3f} ms, K2's dx "
          f"at the same shape {dx:.3f} ms")
    return {"cuda_core_ms": old, "k2_dx_ms": dx}


def _add(rec, extra):
    for k, v in extra.items():
        rec[k] = rec.get(k, 0.0) + v


A_KEYS = {"bfloat16": "conv1_1_stats_wgmma",
          "float32": "conv1_1_stats_tf32x3"}
B_KEYS = {"bfloat16": "conv1_1_bwd_wgmma", "float32": "conv1_1_bwd_tf32x3"}


def _s1_launched(before):
    """A/B launch counts that moved since ``before``."""
    from st3d_torch.kernels.stage1 import LAUNCHES

    return {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}


def profiled_ms(fn, reps=10):
    """Device time of one call of ``fn``: the time of its CUDA kernels
    under ``torch.profiler`` over ``reps`` calls after a warm-up, so the
    host's issue is left out. Returns (ms, {kernel: ms per call})."""
    import torch
    from st3d_torch.profile_step import kernel_ms

    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = kernel_ms(prof.events(), reps)
    if not per:
        fail("torch.profiler saw no device time")
    return sum(per.values()), per


def _stats_err(ptp, s27, ptp_p, s27_p, what, x):
    """PᵀP and s27 against the plain version: relative Frobenius <= 1e-4
    (sums of 2¹⁸ terms per image, taken in another order); also printed
    against a float64 sum of the same patches, which shows whether the
    kernel or the plain float32 sum is the further off."""
    import torch
    from st3d_torch.kernels.stage1 import patches27

    flat = patches27(x).double().reshape(x.shape[0], -1, 27)
    exact = {"PtP": flat.transpose(1, 2) @ flat, "s27": flat.sum(dim=1)}
    worst = 0.0
    for part, got, ref in (("PtP", ptp, ptp_p), ("s27", s27, s27_p)):
        rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
        e64 = exact[part]
        rel64 = float(torch.linalg.norm(got.double() - e64)
                      / torch.linalg.norm(e64))
        plain64 = float(torch.linalg.norm(ref.double() - e64)
                        / torch.linalg.norm(e64))
        print(f"{what} {part} rel fro err {rel:.3g} (against float64: "
              f"kernel {rel64:.3g}, plain {plain64:.3g})")
        if rel > 1e-4:
            fail(f"{what} {part}: rel fro err {rel} > 1e-4")
        worst = max(worst, rel)
    return worst


def ab_versus(x, w1, b1, dz, sym, ds, plain, dx_ref, tol, res):
    """The CUDA-core A and B, which both dtypes took before the
    tensor-core ones, on the same inputs: held against the plain versions
    and timed (events and profiler) beside the tensor-core kernels; in
    float32 they are also entries of their own (``conv1_1_stats``,
    ``conv1_1_bwd``). In bf16, F.conv2d 3 -> 64 + bias, the nearest library
    call to A's z half (no statistics, no ReLU)."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels import stage1 as ks1

    name = str(x.dtype)[6:]
    a, b = A_KEYS[name], B_KEYS[name]
    z_p, ptp_p, s27_p = plain
    before = dict(ks1.LAUNCHES)
    zc, ptpc, s27c = ks1.conv1_1_stats_cuda_core(x, w1, b1)
    dxc = ks1.conv1_1_bwd_cuda_core(x, dz, z_p, w1, sym, ds)
    torch.cuda.synchronize()
    if _s1_launched(before) != {"conv1_1_stats": 1, "conv1_1_bwd": 1}:
        fail(f"CUDA-core A, B: launched {_s1_launched(before)}")
    res[a]["cuda_core_max_abs_err"] = _max_err(
        zc, z_p, tol, f"A conv1_1_stats z {name}")[0]
    stats_err = _stats_err(ptpc, s27c, ptp_p, s27_p,
                           f"A conv1_1_stats {name}", x)
    res[b]["cuda_core_max_abs_err"] = _max_err(
        dxc, dx_ref, tol, f"B conv1_1_bwd dx {name}")[0]
    calls = {a: lambda: ks1.conv1_1_stats_cuda_core(x, w1, b1),
             b: lambda: ks1.conv1_1_bwd_cuda_core(x, dz, z_p, w1, sym, ds)}
    for key, fn in calls.items():
        res[key]["cuda_core_ms"] = cuda_ms(fn, 5)
        res[key]["cuda_core_device_ms"] = profiled_ms(fn)[0]
    if name == "float32":
        for cc, key in (("conv1_1_stats", a), ("conv1_1_bwd", b)):
            r = res[key]
            res[cc].update(max_abs_err=r["cuda_core_max_abs_err"],
                           ms=r["cuda_core_ms"],
                           device_ms=r["cuda_core_device_ms"],
                           plain_ms=r["plain_ms"])
        res["conv1_1_stats"]["stats_rel_fro_err"] = stats_err
    else:
        xl = x.permute(0, 3, 1, 2)
        wl = w1.permute(3, 2, 0, 1).contiguous()
        res[a]["conv2d_z_half_ms"] = cuda_ms(
            lambda: F.conv2d(xl, wl, b1, padding=1), 5)
    work = stage1_work()
    for key, what in ((a, "A"), (b, "B")):
        r = res[key]
        print(f"{what} {name}: {key} {r['ms']:.3f} ms (device "
              f"{r['device_ms']:.4f}, bound {bound(*work[key])[0]:.4f}), the "
              f"CUDA-core kernel on the same inputs {r['cuda_core_ms']:.3f} "
              f"ms (device {r['cuda_core_device_ms']:.4f})"
              + (f", F.conv2d bf16 3 -> 64 {r['conv2d_z_half_ms']:.3f} ms"
                 if "conv2d_z_half_ms" in r else ""))


def stage1_work():
    """(operations, bytes, rate) of each stage-1 kernel at 4 x 512²: A
    conv1_1 (27 -> 64) plus the 27 x 27 patch statistics; B the same two
    products backwards; C and D conv1_2 (64 -> 64, 9 taps) forward and
    input gradient. bf16 at the bf16 tensor rate; the float32 routes at
    their own: the three TF32 products of the 3xTF32 A, B, C and D at the
    TF32 rate, the CUDA-core A, B, C and D at the fp32 rate; float32 moves
    twice the bytes."""
    px = VIEWS * SIZE * SIZE
    conv12 = 2 * px * 9 * 64 * 64
    c11 = 2 * px * 27 * (64 + 27)
    stats = 4 * VIEWS * (27 * 27 + 27)
    a_bytes, b_bytes = px * (3 + 64), px * (3 + 64 + 64 + 3)
    return {
        "conv1_1_stats_wgmma": (c11, 2 * a_bytes + stats, BF16_FLOPS),
        "conv1_1_bwd_wgmma": (c11, 2 * b_bytes + stats, BF16_FLOPS),
        "conv1_1_stats_tf32x3": (3 * c11, 4 * a_bytes + stats, TF32_FLOPS),
        "conv1_1_bwd_tf32x3": (3 * c11, 4 * b_bytes + stats, TF32_FLOPS),
        "conv1_1_stats": (c11, 4 * a_bytes + stats, F32_FLOPS),
        "conv1_1_bwd": (c11, 4 * b_bytes + stats, F32_FLOPS),
        "conv3x3_relu_pool_wgmma": (conv12, 2 * px * 64 + 3 * (px // 4) * 64,
                                    BF16_FLOPS),
        "pool_route_wgmma": (conv12, 5 * (px // 4) * 64 + 2 * px * 64,
                             BF16_FLOPS),
        "conv3x3_relu_pool_tf32x3": (3 * conv12,
                                     4 * px * 64 + 5 * (px // 4) * 64,
                                     TF32_FLOPS),
        "conv3x3_relu_pool": (conv12, 4 * px * 64 + 5 * (px // 4) * 64,
                              F32_FLOPS),
        "pool_route_tf32x3": (3 * conv12, 9 * (px // 4) * 64 + 4 * px * 64,
                              TF32_FLOPS),
        "pool_route_conv3x3_bwd": (conv12, 9 * (px // 4) * 64 + 4 * px * 64,
                                   F32_FLOPS),
    }


def stage1_check(dev):
    """Kernels A-D at the stage-1 shapes of the main path (4 x 512² x 3 ->
    64 -> 64, pool to 256²), each against its plain version, each call on
    its route's kernel: A, B, C and D on the tensor cores in bf16 and by
    3xTF32 in float32 (the CUDA-core A and B also on the inputs of both
    dtypes, the CUDA-core C and D on the float32 inputs). A's statistics
    bit-identical on a second call. A and B timed on both dtypes by CUDA
    events and by the profiler's kernel time."""
    import torch
    from st3d_torch.kernels import conv as kconv
    from st3d_torch.kernels import stage1 as ks1

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (VIEWS, SIZE, SIZE)
    names = KERNELS[3:] + (A_KEYS["float32"], B_KEYS["float32"],
                           C_KEYS["float32"], D_KEYS["float32"],
                           "conv1_1_stats", "conv1_1_bwd",
                           "conv3x3_relu_pool", "pool_route_conv3x3_bwd")
    res = {n: {"max_abs_err": 0.0} for n in names}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        name = str(dtype)[6:]
        a_key, b_key = A_KEYS[name], B_KEYS[name]
        c_key, d_key = C_KEYS[name], D_KEYS[name]
        x = torch.rand(shape + (3,), generator=gen, device=dev).to(dtype)
        w1 = (torch.randn((3, 3, 3, 64), generator=gen, device=dev)
              * (2.0 / 27) ** 0.5).to(dtype)
        b1 = (0.1 * torch.randn((64,), generator=gen, device=dev)).to(dtype)
        w2 = (torch.randn((3, 3, 64, 64), generator=gen, device=dev)
              * (2.0 / 576) ** 0.5).to(dtype)
        b2 = (0.1 * torch.randn((64,), generator=gen, device=dev)).to(dtype)
        dz = torch.randn(shape + (64,), generator=gen, device=dev).to(dtype)
        # dPᵀP at 0.1 and ds27 at 1 make P·S and ds27 large enough that
        # dropping either, or taking S of the wrong image, moves dx by more
        # than ten tolerances: held below, so B's check sees its fold.
        dg = 0.1 * torch.randn((VIEWS, 27, 27), generator=gen, device=dev)
        sym = dg + dg.transpose(1, 2)
        ds = torch.randn((VIEWS, 27), generator=gen, device=dev)
        ct = torch.randn((VIEWS, SIZE // 2, SIZE // 2, 64), generator=gen,
                         device=dev).to(dtype)

        # A: z and the patch statistics, on its route, twice.
        before = dict(ks1.LAUNCHES)
        z, ptp, s27 = ks1.conv1_1_stats(x, w1, b1)
        torch.cuda.synchronize()
        if _s1_launched(before) != {a_key: 1}:
            fail(f"A {name}: launched {_s1_launched(before)}, want {a_key}")
        z_p, ptp_p, s27_p = ks1.conv1_1_stats_plain(x, w1, b1)
        errs = {a_key: _max_err(z, z_p, tol, f"A z {name}")}
        res[a_key]["stats_rel_fro_err"] = _stats_err(
            ptp, s27, ptp_p, s27_p, f"A {a_key} {name}", x)
        again = ks1.conv1_1_stats(x, w1, b1)
        if not (torch.equal(again[1], ptp) and torch.equal(again[2], s27)):
            fail(f"A {a_key} {name}: statistics differ on a second call")
        # B: dx from the plain forward's z, on its route.
        before = dict(ks1.LAUNCHES)
        dx = ks1.conv1_1_bwd(x, dz, z_p, w1, sym, ds)
        torch.cuda.synchronize()
        if _s1_launched(before) != {b_key: 1}:
            fail(f"B {name}: launched {_s1_launched(before)}, want {b_key}")
        dx_p = ks1.conv1_1_bwd_plain(x, dz, z_p, w1, sym, ds)
        errs[b_key] = _max_err(dx, dx_p, tol, f"B dx {name}")
        moves = {}
        for what, s_, d_ in (("sym = 0", torch.zeros_like(sym), ds),
                             ("ds27 = 0", sym, torch.zeros_like(ds)),
                             ("S of the next image", sym.roll(1, 0), ds)):
            moved = float((ks1.conv1_1_bwd_plain(x, dz, z_p, w1, s_, d_)
                           .float() - dx_p.float()).abs().max())
            moves[what] = moved / (tol * errs[b_key][1])
            if not moved > 10 * tol * errs[b_key][1]:
                fail(f"B dx {name}: {what} moves the plain dx by only "
                     f"{moved}, so the check cannot hold the statistics "
                     f"fold")
        print(f"B {b_key} {name}: the plain dx moves by "
              + ", ".join(f"{v:.1f} tolerances at {k}"
                          for k, v in moves.items()))
        # C: pooled and idx from the plain forward's z, on its route.
        before = dict(kconv.LAUNCHES)
        pooled, idx = kconv.conv3x3_relu_pool(z_p, w2, b2)
        torch.cuda.synchronize()
        if _launched(before) != {c_key: 1}:
            fail(f"C {name}: launched {_launched(before)}, want {c_key}")
        pooled_p, idx_p = kconv.conv3x3_relu_pool_plain(z_p, w2, b2)
        errs[c_key] = _max_err(pooled, pooled_p, tol, f"C pooled {name}")
        bad, sep = _idx_mismatches(
            idx, idx_p, kconv.conv3x3_nhwc_plain(z_p, w2, b2, True),
            tol * errs[c_key][1])
        print(f"C {c_key} {name} idx mismatches {bad} where separated "
              f"({sep:.3f} of the cells), elsewhere "
              f"{int((idx != idx_p).sum())}")
        if bad:
            fail(f"C idx {name}: {bad} mismatches where separated")
        # D: dz from the plain forward's pooled and idx, on its route.
        before = dict(kconv.LAUNCHES)
        dz2 = kconv.pool_route_conv3x3_bwd(ct, pooled_p, idx_p, w2)
        torch.cuda.synchronize()
        if _launched(before) != {d_key: 1}:
            fail(f"D {name}: launched {_launched(before)}, want {d_key}")
        dz2_p = kconv.pool_route_conv3x3_bwd_plain(ct, pooled_p, idx_p, w2)
        errs[d_key] = _max_err(dz2, dz2_p, tol, f"D dz {name}")
        if dtype == torch.float32:
            # The CUDA-core C and D, which float32 took before the 3xTF32
            # ones.
            p_cc, idx_cc = kconv.conv3x3_relu_pool_cuda_core(z_p, w2, b2)
            errs["conv3x3_relu_pool"] = _max_err(
                p_cc, pooled_p, tol, f"C conv3x3_relu_pool pooled {name}")
            bad, _ = _idx_mismatches(
                idx_cc, idx_p, kconv.conv3x3_nhwc_plain(z_p, w2, b2, True),
                tol * errs["conv3x3_relu_pool"][1])
            if bad:
                fail(f"C conv3x3_relu_pool idx {name}: {bad} mismatches "
                     f"where separated")
            dz_cc = kconv.pool_route_cuda_core(ct, pooled_p, idx_p, w2)
            errs["pool_route_conv3x3_bwd"] = _max_err(
                dz_cc, dz2_p, tol, f"D pool_route_conv3x3_bwd dz {name}")
        torch.cuda.synchronize()

        calls = {
            a_key: (lambda: ks1.conv1_1_stats(x, w1, b1),
                    lambda: ks1.conv1_1_stats_plain(x, w1, b1)),
            b_key: (
                lambda: ks1.conv1_1_bwd(x, dz, z_p, w1, sym, ds),
                lambda: ks1.conv1_1_bwd_plain(x, dz, z_p, w1, sym, ds)),
            c_key: (
                lambda: kconv.conv3x3_relu_pool(z_p, w2, b2),
                lambda: kconv.conv3x3_relu_pool_plain(z_p, w2, b2)),
            d_key: (
                lambda: kconv.pool_route_conv3x3_bwd(ct, pooled_p, idx_p, w2),
                lambda: kconv.pool_route_conv3x3_bwd_plain(ct, pooled_p,
                                                           idx_p, w2)),
        }
        for n, (err, scale) in errs.items():
            r = res[n]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            line = f"{n} {name} max err {err:.3g}/{scale:.3g}"
            # Timed on each dtype's route (the CUDA-core C and D below,
            # beside 3xTF32's); A and B also by the profiler's kernel time,
            # since an event loop over a call this short times its issue.
            if n in calls:
                r["ms"] = cuda_ms(calls[n][0], 5)
                r["plain_ms"] = cuda_ms(calls[n][1], 3, 1)
                line += (f"  kernel {r['ms']:.3f} ms plain "
                         f"{r['plain_ms']:.3f} ms")
            if n in (a_key, b_key):
                r["device_ms"], per = profiled_ms(calls[n][0])
                line += f" device {r['device_ms']:.4f} ms " + json.dumps(
                    {k[:48]: round(v, 4) for k, v in per.items()})
            print(line)
        ab_versus(x, w1, b1, dz, sym, ds, (z_p, ptp_p, s27_p), dx_p, tol,
                  res)
        what = f"conv1_2 4 x 512² x 64 -> 64 {name}"
        res[d_key].update(d_versus(ct, pooled_p, idx_p, w2, res[d_key]["ms"],
                                   d_key, what))
        res[c_key].update(c_versus(z_p, w2, b2, res[c_key]["ms"], c_key,
                                   what))
        if dtype == torch.float32:
            for cc_key, key in (("conv3x3_relu_pool", c_key),
                                ("pool_route_conv3x3_bwd", d_key)):
                res[cc_key]["ms"] = res[key]["cuda_core_ms"]
                res[cc_key]["plain_ms"] = res[key]["plain_ms"]
    meta = {
        "conv1_1_stats_wgmma": ("st3d_torch/csrc/conv1_1_stats_wgmma.cu",
                                "st3d/kernels/stage1_pallas.py:446"),
        "conv1_1_bwd_wgmma": ("st3d_torch/csrc/conv1_1_bwd_wgmma.cu",
                              "st3d/kernels/stage1_pallas.py:583"),
        "conv1_1_stats_tf32x3": ("st3d_torch/csrc/conv1_1_stats_tf32x3.cu",
                                 "st3d/kernels/stage1_pallas.py:446"),
        "conv1_1_bwd_tf32x3": ("st3d_torch/csrc/conv1_1_bwd_tf32x3.cu",
                               "st3d/kernels/stage1_pallas.py:583"),
        "conv1_1_stats": ("st3d_torch/csrc/conv1_1_stats.cu",
                          "st3d/kernels/stage1_pallas.py:446"),
        "conv1_1_bwd": ("st3d_torch/csrc/conv1_1_bwd.cu",
                        "st3d/kernels/stage1_pallas.py:583"),
        "conv3x3_relu_pool_wgmma": ("st3d_torch/csrc/conv3x3_wgmma.cu",
                                    "st3d/kernels/stage1_pallas.py:485, "
                                    "st3d/kernels/conv_pallas.py:760"),
        "conv3x3_relu_pool_tf32x3": ("st3d_torch/csrc/conv3x3_tf32x3.cu",
                                     "st3d/kernels/stage1_pallas.py:485, "
                                     "st3d/kernels/conv_pallas.py:760"),
        "conv3x3_relu_pool": ("st3d_torch/csrc/conv3x3_relu_pool.cu",
                              "st3d/kernels/stage1_pallas.py:485, "
                              "st3d/kernels/conv_pallas.py:760"),
        "pool_route_wgmma": ("st3d_torch/csrc/pool_route_wgmma.cu",
                             "st3d/kernels/stage1_pallas.py:539, "
                             "st3d/kernels/conv_pallas.py:785"),
        "pool_route_tf32x3": ("st3d_torch/csrc/pool_route_tf32x3.cu",
                              "st3d/kernels/stage1_pallas.py:539, "
                              "st3d/kernels/conv_pallas.py:785"),
        "pool_route_conv3x3_bwd": ("st3d_torch/csrc/pool_route_conv3x3_bwd.cu",
                                   "st3d/kernels/stage1_pallas.py:539, "
                                   "st3d/kernels/conv_pallas.py:785"),
    }
    work = stage1_work()
    f32 = (A_KEYS["float32"], B_KEYS["float32"], C_KEYS["float32"],
           D_KEYS["float32"], "conv1_1_stats", "conv1_1_bwd",
           "conv3x3_relu_pool", "pool_route_conv3x3_bwd")
    return [with_bound({"name": n, "route": "cuda", "source": meta[n][0],
                        "replaces": meta[n][1],
                        "dtype": "float32" if n in f32 else "bfloat16",
                        **res[n]}, *work[n]) for n in names]


def stage1v3_check(dev):
    """Kernels E and F at the stage-1 shapes of the main path (4 x 512² x 3
    -> 64), each against its plain version, bf16 and f32."""
    import torch
    from st3d_torch.kernels import stage1v3 as ks3

    gen = torch.Generator(device=dev).manual_seed(4)
    shape = (VIEWS, SIZE, SIZE)
    res = {n: {"max_abs_err": 0.0} for n in V3_KERNELS}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        name = str(dtype)[6:]
        x = torch.rand(shape + (3,), generator=gen, device=dev).to(dtype)
        w = (torch.randn((3, 3, 3, 64), generator=gen, device=dev)
             * (2.0 / 27) ** 0.5).to(dtype)
        b = (0.1 * torch.randn((64,), generator=gen, device=dev)).to(dtype)
        dz = torch.randn(shape + (64,), generator=gen, device=dev).to(dtype)
        # dG at 3e-2 makes y_r·S about a third of dz·mask, so F's Gram fold
        # moves dx by tens of tolerances: held below, with S of the wrong
        # image too.
        dg = 3e-2 * torch.randn((VIEWS, 64, 64), generator=gen, device=dev)
        sym = dg + dg.transpose(1, 2)

        z, g64 = ks3.conv1_1_gram(x, w, b)
        z_p, g_p = ks3.conv1_1_gram_plain(x, w, b)
        errs = {"conv1_1_gram": _max_err(z, z_p, tol, f"E z {name}")}
        rel = float(torch.linalg.norm(g64 - g_p) / torch.linalg.norm(g_p))
        print(f"E conv1_1_gram {name} g64 rel fro err {rel:.3g}")
        if rel > 1e-4:
            fail(f"E g64 {name}: rel fro err {rel} > 1e-4")
        dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
        dx_p = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
        errs["conv1_1_gram_bwd"] = _max_err(dx, dx_p, tol, f"F dx {name}")
        for what, other in (("sym = 0", torch.zeros_like(sym)),
                            ("S of the next image", sym.roll(1, 0))):
            moved = float((ks3.conv1_1_gram_bwd_plain(x, dz, w, b, other)
                           .float() - dx_p.float()).abs().max())
            if not moved > 10 * tol * errs["conv1_1_gram_bwd"][1]:
                fail(f"F dx {name}: {what} moves the plain dx by only "
                     f"{moved}, so the check cannot hold the Gram fold")
        torch.cuda.synchronize()
        calls = {
            "conv1_1_gram": (lambda: ks3.conv1_1_gram(x, w, b),
                             lambda: ks3.conv1_1_gram_plain(x, w, b)),
            "conv1_1_gram_bwd": (
                lambda: ks3.conv1_1_gram_bwd(x, dz, w, b, sym),
                lambda: ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)),
        }
        for n, (err, scale) in errs.items():
            r = res[n]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            line = f"{n} {name} max err {err:.3g}/{scale:.3g}"
            if dtype == torch.bfloat16:
                r["ms"] = cuda_ms(calls[n][0], 5)
                r["plain_ms"] = cuda_ms(calls[n][1], 3, 1)
                line += (f"  kernel {r['ms']:.3f} ms plain "
                         f"{r['plain_ms']:.3f} ms")
            print(line)
    # Bounds at bf16, 4 x 512²: E conv1_1 (27 -> 64) and the 64 x 64 Gram,
    # reading x, writing z and g64; F the recompute, y_r·S and the
    # transpose conv (64 -> 27), reading x and dz, writing dx.
    px = VIEWS * SIZE * SIZE
    work = {
        "conv1_1_gram": (2 * px * 64 * (27 + 64),
                         2 * px * (3 + 64) + 4 * VIEWS * 64 * 64),
        "conv1_1_gram_bwd": (2 * px * 64 * (27 + 64 + 27),
                             2 * px * (3 + 64 + 3) + 4 * VIEWS * 64 * 64),
    }
    meta = {"conv1_1_gram": "st3d/kernels/stage1v3_pallas.py:256",
            "conv1_1_gram_bwd": "st3d/kernels/stage1v3_pallas.py:366"}
    return [with_bound({"name": n, "route": "cuda",
                        "source": f"st3d_torch/csrc/{n}.cu",
                        "replaces": meta[n], **res[n]}, *work[n], BF16_FLOPS)
            for n in V3_KERNELS]


def k8_check(dev):
    """Kernels C and D at K8's shapes (conv2_2, conv3_4, conv4_4 at 512²),
    each against its plain version, bf16 and f32 (both on the tensor cores,
    by 3xTF32 in f32); times summed over the three convs, each beside the
    CUDA-core kernel on the same inputs and K2 at the same shape."""
    import torch
    from st3d_torch.kernels import conv as kconv

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(5)
    names = tuple(C_KEYS.values()) + tuple(D_KEYS.values())
    res = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
           for n in names}
    work = {n: [0, 0] for n in names}
    for c, h in K8_CONVS:
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            dname = str(dtype)[6:]
            c_key, d_key = C_KEYS[dname], D_KEYS[dname]
            name = f"{c}->{c} {h}² {dname}"
            x = torch.relu(torch.randn((VIEWS, h, h, c), generator=gen,
                                       device=dev)).to(dtype)
            w = (torch.randn((3, 3, c, c), generator=gen, device=dev)
                 * (2.0 / (9 * c)) ** 0.5).to(dtype)
            b = (0.1 * torch.randn((c,), generator=gen, device=dev)).to(dtype)
            ct = torch.randn((VIEWS, h // 2, h // 2, c), generator=gen,
                             device=dev).to(dtype)
            before = dict(kconv.LAUNCHES)
            pooled, idx = kconv.conv3x3_relu_pool(x, w, b)
            torch.cuda.synchronize()
            if _launched(before) != {c_key: 1}:
                fail(f"K8 C {name}: launched {_launched(before)}, want "
                     f"{c_key}")
            p_p, idx_p = kconv.conv3x3_relu_pool_plain(x, w, b)
            err_c = _max_err(pooled, p_p, tol, f"K8 C pooled {name}")
            bad, sep = _idx_mismatches(
                idx, idx_p, kconv.conv3x3_nhwc_plain(x, w, b, True),
                tol * err_c[1])
            if bad:
                fail(f"K8 C idx {name}: {bad} mismatches where separated")
            before = dict(kconv.LAUNCHES)
            dz = kconv.pool_route_conv3x3_bwd(ct, p_p, idx_p, w)
            torch.cuda.synchronize()
            if _launched(before) != {d_key: 1}:
                fail(f"K8 D {name}: launched {_launched(before)}, want "
                     f"{d_key}")
            dz_p = kconv.pool_route_conv3x3_bwd_plain(ct, p_p, idx_p, w)
            err_d = _max_err(dz, dz_p, tol, f"K8 D dz {name}")
            torch.cuda.synchronize()
            line = (f"K8 {name}: C {c_key} pooled err "
                    f"{err_c[0]:.3g}/{err_c[1]:.3g}, idx mismatches where "
                    f"separated {bad} ({sep:.3f} of the cells); D {d_key} dz "
                    f"err {err_d[0]:.3g}/{err_d[1]:.3g}")
            for n, err in ((c_key, err_c), (d_key, err_d)):
                if n in res:
                    res[n]["max_abs_err"] = max(res[n]["max_abs_err"], err[0])
            px = VIEWS * h * h
            flops = 2 * 9 * c * c * px
            e = x.element_size()
            t_d = cuda_ms(lambda: kconv.pool_route_conv3x3_bwd(
                ct, p_p, idx_p, w), 5)
            tp_d = cuda_ms(lambda: kconv.pool_route_conv3x3_bwd_plain(
                ct, p_p, idx_p, w), 3, 1)
            res[d_key]["ms"] += t_d
            res[d_key]["plain_ms"] += tp_d
            work[d_key][0] += flops * (3 if dtype == torch.float32 else 1)
            work[d_key][1] += ((2 * e + 1) * (px // 4) * c + e * px * c
                               + e * 9 * c * c)
            line += f"  D {t_d:.3f} ms (plain {tp_d:.3f})"
            t_c = cuda_ms(lambda: kconv.conv3x3_relu_pool(x, w, b), 5)
            tp_c = cuda_ms(lambda: kconv.conv3x3_relu_pool_plain(x, w, b),
                           3, 1)
            res[c_key]["ms"] += t_c
            res[c_key]["plain_ms"] += tp_c
            work[c_key][0] += flops * (3 if dtype == torch.float32 else 1)
            work[c_key][1] += (e * px * c + (e + 1) * (px // 4) * c
                               + e * 9 * c * c)
            line += f", C {t_c:.3f} ms (plain {tp_c:.3f})"
            print(line)
            _add(res[c_key], c_versus(x, w, b, t_c, c_key, f"K8 {name}"))
            _add(res[d_key], d_versus(ct, p_p, idx_p, w, t_d, d_key,
                                      f"K8 {name}"))
    for n in names:
        r = res[n]
        other = ("K2's forward", r["k2_fwd_ms"]) if "k2_fwd_ms" in r else (
            "K2's dx", r["k2_dx_ms"])
        print(f"K8 over conv2_2, conv3_4, conv4_4: {n} {r['ms']:.3f} ms "
              f"(CUDA-core kernel {r['cuda_core_ms']:.3f} ms, {other[0]} "
              f"{other[1]:.3f} ms"
              + (f", composition {r['composition_ms']:.3f} ms"
                 if "composition_ms" in r else "") + ")")
    f32 = (C_KEYS["float32"], D_KEYS["float32"])
    source = {C_KEYS["bfloat16"]: "conv3x3_wgmma",
              C_KEYS["float32"]: "conv3x3_tf32x3"}
    replaces = {n: "st3d/kernels/conv_pallas.py:" + (
        "505" if n in C_KEYS.values() else "527") for n in names}
    return [with_bound({"name": f"{n} (K8)", "route": "cuda",
                        "source": f"st3d_torch/csrc/{source.get(n, n)}.cu",
                        "replaces": replaces[n],
                        "dtype": "float32" if n in f32 else "bfloat16",
                        "shapes": "conv2_2, conv3_4, conv4_4 at 512² x 4",
                        **res[n]}, *work[n],
                       TF32_FLOPS if n in f32 else BF16_FLOPS)
            for n in names]


def write_scene(root, size, seed, level=ICO_LEVEL):
    """Synthetic scene written with the port's own writers: an ico-sphere
    with spherical UVs and a seeded texture, plus a seeded style PNG."""
    from st3d_torch.profile_step import write_sphere_scene

    return write_sphere_scene(root, size, seed, level, sphere(level))


def read_log(out):
    with open(os.path.join(out, "log.txt")) as f:
        lines = f.read().strip().splitlines()
    if lines[0] != "Logger:":
        fail(f"{out}/log.txt has no Logger: header")
    return [float(l.rsplit(" ", 1)[1]) for l in lines[1:]]


def launch_counts():
    from st3d_torch.kernels import conv as kconv
    from st3d_torch.kernels import raster as kraster
    from st3d_torch.kernels import stage1 as ks1
    from st3d_torch.kernels import stage1v3 as ks3

    return (kraster.LAUNCHES, kconv.LAUNCHES, ks1.LAUNCHES, ks3.LAUNCHES)


def drive(path, route, run, raster="raster_hard", want=None):
    """Run ``run()`` on a VGG route with every launch count set to 0 just
    before; fail unless exactly the route's kernels (``want`` if given)
    launched, with ``raster`` as the visibility kernel (None: no raster
    kernel). Returns the counts read just after."""
    env, route_want = ROUTES[route]
    want = ((want or route_want) - {"raster_hard"}) | (
        {raster} if raster else set())
    for counts in launch_counts():
        for k in counts:
            counts[k] = 0
    os.environ.update(env)
    try:
        run()
    finally:
        for k in env:
            os.environ.pop(k)
    launches = {k: n for counts in launch_counts() for k, n in counts.items()}
    ran = {k for k, n in launches.items() if n > 0}
    if ran != want:
        fail(f"{path} on route {route}: launched {sorted(ran)}, want "
             f"{sorted(want)}")
    return launches


def check_fused_pool_counts(default, fused):
    """The fused-pool route against the default one over the same epochs:
    C and D launch four times as often (conv1_2, conv2_2, conv3_4, conv4_4
    instead of conv1_2 alone), and each C or D launch at K8's convs
    replaces a K2 launch: three K2 launches fewer per C and per D."""
    c, d, k2 = C_KEYS["bfloat16"], D_KEYS["bfloat16"], "conv3x3_wgmma"
    want_k2 = default[k2] - 3 * (default[c] + default[d])
    if (fused[c] != 4 * default[c] or fused[d] != 4 * default[d]
            or fused[k2] != want_k2):
        fail(f"fused-pool counts C {fused[c]} D {fused[d]} K2 {fused[k2]}, "
             f"want {4 * default[c]}, {4 * default[d]}, {want_k2}")
    print(f"fused-pool route: C {default[c]} -> {fused[c]}, D {default[d]} "
          f"-> {fused[d]}, K2 {default[k2]} -> {fused[k2]} launches over "
          f"{EPOCHS} epochs")


def check_stage1_counts(runs):
    """A and B once a step: B runs only in each step's backward, so it
    launches once per epoch; A runs in each step's forward and in the same
    set-up passes (the content and style targets) on every run that takes
    it. ``runs``: {what: (launches, epochs, dtype)}."""
    setups = {}
    for what, (launches, epochs, dtype) in runs.items():
        a, b = A_KEYS[dtype], B_KEYS[dtype]
        if launches[b] != epochs:
            fail(f"{what}: {b} launched {launches[b]} times, want one a "
                 f"step ({epochs})")
        setups[what] = launches[a] - epochs
    print("A and B once a step: " + json.dumps(
        {what: {"epochs": epochs, A_KEYS[dtype]: launches[A_KEYS[dtype]],
                B_KEYS[dtype]: launches[B_KEYS[dtype]]}
         for what, (launches, epochs, dtype) in runs.items()}))
    if len(set(setups.values())) != 1 or min(setups.values()) < 0:
        fail(f"A's launches beyond one a step differ between runs: {setups}")


def route_entries(kernels, default, routes):
    """Launch counts on the opt-in routes: E and F get theirs from the v3
    run; K10c/K10d (C and D at stage 1's shapes, as measured there) and K8
    (C and D at its own shapes) are added as entries of their own."""
    by_name = {k["name"]: k for k in kernels}
    for n in V3_KERNELS:
        by_name[n]["launches"] = routes["v3"][n]
    out = []
    for n, k10, line in (
            (C_KEYS["bfloat16"], "K10c",
             "st3d/kernels/stage1v3_pallas.py:286"),
            ("pool_route_wgmma", "K10d",
             "st3d/kernels/stage1v3_pallas.py:345")):
        rec = dict(by_name[n], name=f"{n} ({k10})", replaces=line,
                   launches=routes["v3"][n])
        for key in ("launches_texture_target", "launches_first_approach"):
            rec.pop(key, None)
        out.append(rec)
        k8 = by_name[f"{n} (K8)"]
        k8["launches"] = routes["fused_pool"][n]
        k8["launches_at_k8_shapes"] = routes["fused_pool"][n] - default[n]
    return out


def check_outputs(out):
    if not os.path.isfile(os.path.join(out, "final.obj")):
        fail(f"{out}: final.obj missing")
    n_views = len(os.listdir(os.path.join(out, "final_render")))
    if n_views != 12:
        fail(f"{out}: final_render holds {n_views} views, want 12")


def second_approach_argv(obj, style, epochs, dtype, out):
    return ["--obj_path", obj, "--style_path", style, "--size", str(SIZE),
            "--n_views", str(VIEWS), "--batch_size", str(VIEWS),
            "--compute_dtype", dtype, "--epochs", str(epochs),
            "--save_intermediate", "False", "--randomize_views", "False",
            "--device", "cuda", "--output_path", out]


def median_step_ms(out, last):
    """Median ``step_s`` of the last ``last`` epochs after the first, in ms;
    also how many epochs that was."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [json.loads(l)["step_s"] for l in f]
    tail = steps[1:][-last:]
    return 1e3 * statistics.median(tail), len(tail)


def second_approach_path(tmp, obj, style, route, epochs, dtype="bfloat16",
                         want=None):
    from st3d_torch.second_approach import main as second_approach

    out = os.path.join(tmp, f"second_{route}_{dtype}")
    t0 = time.perf_counter()
    launches = drive("second approach", route, lambda: second_approach(
        second_approach_argv(obj, style, epochs, dtype, out)), want=want)
    wall = time.perf_counter() - t0
    if route in STAGE1_OFF and launches["gram_nhwc"] != epochs:
        fail(f"route {route}: gram_nhwc (conv1_1's PᵀP) launched "
             f"{launches['gram_nhwc']} times, want one a step ({epochs})")
    losses = read_log(out)
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        fail(f"second approach losses not {epochs} finite values: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"second approach loss did not fall: {losses[0]} -> "
             f"{losses[-1]}")
    check_outputs(out)
    step_ms, n = median_step_ms(out, 10)
    print(f"second approach {SIZE}² x {VIEWS} views {dtype}, route {route}: "
          f"loss {losses[0]:.6g} -> {losses[-1]:.6g} over {epochs} epochs, "
          f"median step {step_ms:.2f} ms over the last {n}, run "
          f"{wall:.1f}s, launches " + json.dumps(launches))
    return launches


def f32_texture_path(tmp, obj, style):
    """The texture step in float32, the CLI's default dtype, on the default
    route: K2 (forward and dx), K3, C and D on 3xTF32, never
    ``conv3x3_nhwc``, ``gram_nhwc``, ``conv3x3_relu_pool`` or
    ``pool_route_conv3x3_bwd`` (``drive`` fails on any launch outside
    ``F32_KERNELS``); C once and K3 four times a step. The targets' set-up
    adds two C launches (VGG on the content and the style images) and five
    Grams (the style image's five taps, conv1_1's 64-wide one included)."""
    launches = second_approach_path(tmp, obj, style, "default", F32_EPOCHS,
                                    "float32", want=F32_KERNELS)
    want = {C_KEYS["float32"]: F32_EPOCHS + 2,
            "gram_tf32x3": 4 * F32_EPOCHS + 5}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"f32 texture: launched {got}, want {want} ({F32_EPOCHS} "
             f"steps)")
    return launches


def steps_only(dev):
    """``--steps``: only the default route's step times at 512² x 4, with
    no launch-set check, so that the same script times them on an earlier
    tree of the port in the same call: the texture step in bf16 and in
    float32, the both target in bf16 hard (K1) and soft (K1-soft) (the
    median step over the last epochs, and the launches), and hot loop A in
    bf16 and in float32 (the first approach's default dtype).
    Each second-approach run is made twice in the process and the second
    one counts: the bf16 step of a fresh process's first run read 17-21 ms
    where the full smoke, later in its process, read 13.0 ms (H100)."""
    from st3d_torch.second_approach import main as second_approach

    runs = [("texture", "bfloat16", EPOCHS, 10, []),
            ("texture", "float32", F32_EPOCHS, 10, [])]
    for mode in ("hard", "soft"):
        target, extra, _, _ = VERTEX_RUNS[mode]
        runs.append((f"{target} {mode}", "bfloat16", BOTH_EPOCHS, 5,
                     ["--optimization_target", target] + extra))
    with tempfile.TemporaryDirectory() as tmp:
        obj, style = write_scene(tmp, SIZE, seed=0)
        for what, dtype, epochs, last, extra in runs:
            out = os.path.join(tmp, f"second_{what.replace(' ', '_')}_{dtype}")
            for counts in launch_counts():
                for k in counts:
                    counts[k] = 0
            for _ in range(2):
                second_approach(second_approach_argv(obj, style, epochs,
                                                     dtype, out) + extra)
            step_ms, n = median_step_ms(out, last)
            launches = {k: v for counts in launch_counts()
                        for k, v in counts.items() if v}
            print(f"second approach {SIZE}² x {VIEWS} views {dtype}, route "
                  f"default, {what}: median step {step_ms:.2f} ms over the "
                  f"last {n} of {epochs} epochs (second run), launches "
                  + json.dumps(launches))
    hot_loop_a_ms(dev, check=False)
    hot_loop_a_ms(dev, check=False, dtype="float32")


def moved(obj, out):
    """max |final.obj verts - input verts|."""
    from st3d_torch.io.obj import load_obj

    v0 = load_obj(obj, load_textures=False).verts
    v1 = load_obj(os.path.join(out, "final.obj"), load_textures=False).verts
    if v0.shape != v1.shape:
        fail(f"{out}/final.obj has {v1.shape} verts, the input {v0.shape}")
    return float(abs(v1 - v0).max())


def vertex_path(tmp, scenes, mode, card):
    """A vertex-optimisation run of the second approach in one raster mode
    (``VERTEX_RUNS``): finite falling losses, moved vertices, and the mode's
    raster kernel once per step (plus the content and final renders, and
    the hard-K saturation checks)."""
    from st3d_torch.second_approach import main as second_approach

    target, extra, level, kernel = VERTEX_RUNS[mode]
    obj, style = scenes[level]
    out = os.path.join(tmp, f"{target}_{mode}")
    t0 = time.perf_counter()
    launches = drive(f"{target} target {mode}", "default",
                     lambda: second_approach([
                         "--obj_path", obj, "--style_path", style,
                         "--size", str(SIZE), "--n_views", str(VIEWS),
                         "--batch_size", str(VIEWS), "--compute_dtype",
                         "bfloat16", "--epochs", str(BOTH_EPOCHS),
                         "--save_intermediate", "False",
                         "--randomize_views", "False",
                         "--optimization_target", target, "--device", "cuda",
                         "--output_path", out] + extra), raster=kernel)
    wall = time.perf_counter() - t0
    losses = read_log(out)
    what = f"{target}/{mode}"
    if len(losses) != BOTH_EPOCHS or not all(map(math.isfinite, losses)):
        fail(f"{what}: losses not {BOTH_EPOCHS} finite values: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{what}: loss did not fall: {losses[0]} -> {losses[-1]}")
    check_outputs(out)
    dv = moved(obj, out)
    if not dv > 0:
        fail(f"{what}: final.obj vertices did not move")
    # Every step, the content render and the final render; the blur window
    # adds a saturation check before the first step and one at the end.
    want = BOTH_EPOCHS + (4 if mode == "blur" else 2)
    if launches[kernel] != want:
        fail(f"{what}: {kernel} launched {launches[kernel]} times, want "
             f"{want}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [json.loads(l)["step_s"] for l in f]
    step_ms = 1e3 * statistics.median(steps[-5:])
    print(f"{target} target {mode} ({kernel}, ico level {level}) {SIZE}² x "
          f"{VIEWS} views bf16 on {card}: loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} over {BOTH_EPOCHS} epochs, max |dv| {dv:.4g}, "
          f"median step {step_ms:.2f} ms over the last 5, run {wall:.1f}s, "
          f"launches " + json.dumps(launches))
    return launches


def first_approach_path(tmp, obj, style, target="texture",
                        steps=(ST_STEPS, MSE_STEPS)):
    from st3d_torch.first_approach import main as first_approach

    st_steps, mse_steps = steps
    out = os.path.join(tmp, f"first_{target}")
    t0 = time.perf_counter()
    launches = drive("first approach", "default", lambda: first_approach([
        "--obj_path", obj, "--style_path", style, "--size", str(SIZE),
        "--n_views", str(VIEWS), "--batch_size", str(VIEWS),
        "--compute_dtype", "bfloat16", "--n_style_transfer_steps",
        str(st_steps), "--n_mse_steps", str(mse_steps),
        "--optimization_target", target,
        "--randomize_views", "False", "--device", "cuda",
        "--output_path", out]))
    wall = time.perf_counter() - t0
    losses = read_log(out)
    if len(losses) != mse_steps or not all(map(math.isfinite, losses)):
        fail(f"first approach losses not {mse_steps} finite values: {losses}")
    # On the vertex targets Adam's first step moves every vertex by lr in
    # each coordinate (its first update is lr * sign(g)), which costs more
    # than it gains; the loss falls from there.
    first = losses[0] if target == "texture" else losses[1]
    if not losses[-1] < first:
        fail(f"first approach {target} loss did not fall: {first} -> "
             f"{losses[-1]}")
    st = sorted(os.listdir(os.path.join(out, "2d_style_transfer")))
    if st != [f"view_{i}.png" for i in range(VIEWS)]:
        fail(f"2d_style_transfer holds {st}")
    check_outputs(out)
    if target != "texture" and launches["raster_hard"] != mse_steps + 2:
        fail(f"first approach {target}: K1 launched "
             f"{launches['raster_hard']} times, want {mse_steps + 2}")
    print(f"first approach {SIZE}² x {VIEWS} views bf16, target {target}, "
          f"{st_steps} style-transfer + {mse_steps} MSE steps: MSE loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}, run {wall:.1f}s, launches "
          + json.dumps(launches))
    return launches


def hot_loop_a_ms(dev, route="default", check=True, dtype="bfloat16"):
    """ms per hot-loop-A step at 512² x 4 in ``dtype`` on a VGG route: two
    synchronised runs of ``style_transfer`` (after a warm-up), their
    difference over the difference in steps, so the targets' set-up
    cancels; the route's VGG kernels must launch (unless ``check`` is
    False)."""
    import torch
    from st3d_torch.engine.style_transfer2d import style_transfer
    from st3d_torch.models.vgg import init_random_vgg19

    model = init_random_vgg19(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    content, style = (torch.rand((VIEWS, 3, SIZE, SIZE), generator=gen,
                                 device=dev) for _ in range(2))

    def run(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        style_transfer(content, content, style, model, steps=steps, lr=0.01,
                       dtype=getattr(torch, dtype))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times = []
    if check:
        drive("hot loop A", route,
              lambda: times.extend([run(3), run(5), run(25)]), raster=None)
    else:
        times.extend([run(3), run(5), run(25)])
    short, long = times[1:]
    ms = 1e3 * (long - short) / 20
    print(f"hot loop A {SIZE}² x {VIEWS} {dtype}, route {route}: {ms:.2f} ms "
          f"per step (25 steps {long:.3f}s, 5 steps {short:.3f}s)")
    return ms


def small_parity(tmp):
    """Both entry points at 64² on the GPU against the same runs on the CPU
    (plain versions): in f32 (K2, K3, C and D on 3xTF32),
    losses within rtol 1e-3, the second approach also on the both target in
    soft mode and on the v3 and fused-pool routes; and the second approach
    in bf16 on the default route (tensor-core K2, K3, C and D, K2 down to
    conv5_1's 4 x 4 images),
    losses within rtol 1e-2: bf16 rounds every activation, and the kernels
    sum in another order than the CPU, so the first loss moves by ~1e-3 and
    three Adam steps carry it."""
    from st3d_torch.first_approach import main as first_approach
    from st3d_torch.second_approach import main as second_approach

    obj, style = write_scene(os.path.join(tmp, "small"), 64, seed=1)
    common = ["--obj_path", obj, "--style_path", style, "--size", "64",
              "--n_views", "2", "--batch_size", "2",
              "--randomize_views", "False"]
    second = ["--epochs", "3", "--save_intermediate", "False"]
    entries = {
        "second": (second_approach, second, "default", "float32"),
        "first": (first_approach, ["--n_style_transfer_steps", "5",
                                   "--n_mse_steps", "5"], "default",
                  "float32"),
        "second both soft": (second_approach, second + [
            "--optimization_target", "both", "--soft_raster", "true"],
            "default", "float32"),
        "second v3": (second_approach, second, "v3", "float32"),
        "second fused_pool": (second_approach, second, "fused_pool",
                              "float32"),
        "second bf16": (second_approach, second, "default", "bfloat16"),
    }
    c_and_d = {}
    for entry, (fn, extra, route, dtype) in entries.items():
        runs = {}
        os.environ.update(ROUTES[route][0])
        try:
            for device in ("cuda", "cpu"):
                out = os.path.join(tmp, f"small_{entry.replace(' ', '_')}_"
                                   f"{device}")
                before = dict(launch_counts()[1])
                before_ab = dict(launch_counts()[2])
                fn(common + extra + ["--compute_dtype", dtype, "--device",
                                     device, "--output_path", out])
                runs[device] = read_log(out)
                if device == "cuda":
                    ran = {k for k, n in launch_counts()[1].items()
                           if n > before[k]}
                    k2 = ran & {"conv3x3_wgmma", "conv3x3_tf32x3",
                                "conv3x3_nhwc"}
                    c = ran & set(C_KEYS.values())
                    d = ran & (set(D_KEYS.values())
                               | {"pool_route_conv3x3_bwd"})
                    want = {"bfloat16": "conv3x3_wgmma",
                            "float32": "conv3x3_tf32x3"}[dtype]
                    if (k2 != {want} or c != {C_KEYS[dtype]}
                            or d != {D_KEYS[dtype]}):
                        fail(f"64² {entry}: K2 ran on {k2}, C on {c}, D on "
                             f"{d}, want {want}, {C_KEYS[dtype]} and "
                             f"{D_KEYS[dtype]}")
                    c_and_d[entry] = [launch_counts()[1][k] - before[k]
                                      for k in (C_KEYS[dtype], D_KEYS[dtype])]
                    ab = {k for k, n in launch_counts()[2].items()
                          if n > before_ab[k]}
                    want_ab = (set() if route == "v3"
                               else {A_KEYS[dtype], B_KEYS[dtype]})
                    if ab != want_ab:
                        fail(f"64² {entry}: A and B ran on {ab}, want "
                             f"{want_ab}")
        finally:
            for k in ROUTES[route][0]:
                os.environ.pop(k)
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(runs["cuda"], runs["cpu"]))
        tol = 1e-3 if dtype == "float32" else 1e-2
        print(f"64² {dtype} {entry} GPU vs CPU losses: {runs['cuda']} "
              f"vs {runs['cpu']}, max rel diff {rel:.3g} (tolerance {tol})")
        if len(runs["cuda"]) != len(runs["cpu"]) or rel > tol:
            fail(f"{entry}: GPU and CPU losses differ by {rel}")
    # In float32 too the fused-pool route takes C and D at conv2_2, conv3_4
    # and conv4_4 as well as conv1_2.
    base, fused = c_and_d["second"], c_and_d["second fused_pool"]
    print(f"64² float32 fused-pool route: C, D launches {fused}, default "
          f"route {base}")
    if fused != [4 * n for n in base]:
        fail(f"64² f32 fused-pool: C, D launched {fused}, want four times "
             f"the default route's {base}")


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--steps"]):
        print("usage: chip_smoke.py [--steps]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import st3d_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in ROUTE_ENV:
        os.environ.pop(k, None)
    if argv:
        print(smi())
        steps_only(dev)
        return 0
    seconds = {}
    mark = [time.perf_counter()]

    def lap(phase):
        """Wall seconds since the previous lap, kept under ``phase``."""
        now = time.perf_counter()
        seconds[phase] = round(now - mark[0], 2)
        mark[0] = now

    card_phase()
    card = smi()
    lap("build")
    kernels = [raster_check(dev)] + conv_check(dev) + narrow_check(dev)
    kernels += gram_check(dev)
    kernels += stage1_check(dev)
    lap("K1-K3, A-D checks")
    kernels += [raster_soft_check(dev), raster_stream_check(dev),
                raster_topk_check(dev)]
    lap("K1-soft, K6, K7 checks")
    kernels += stage1v3_check(dev) + k8_check(dev) + [raster_2d_check(dev)]
    lap("E, F, K8, K9 checks")
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {level: write_scene(tmp, SIZE, seed=0, level=level)
                  for level in (ICO_LEVEL, STREAM_LEVEL)}
        obj, style = scenes[ICO_LEVEL]
        lap("scenes")
        texture = second_approach_path(tmp, obj, style, "default", EPOCHS)
        for route in ("pr1", "k5"):
            second_approach_path(tmp, obj, style, route, ROUTE_EPOCHS)
        routes = {r: second_approach_path(tmp, obj, style, r, EPOCHS)
                  for r in ("v3", "fused_pool")}
        check_fused_pool_counts(texture, routes["fused_pool"])
        lap("texture target")
        f32 = f32_texture_path(tmp, obj, style)
        check_stage1_counts({
            "texture bf16": (texture, EPOCHS, "bfloat16"),
            "texture bf16 fused_pool": (routes["fused_pool"], EPOCHS,
                                        "bfloat16"),
            "texture f32": (f32, F32_EPOCHS, "float32")})
        lap("f32 texture target")
        vertex = {}
        for mode, (target, *_) in VERTEX_RUNS.items():
            vertex[mode] = vertex_path(tmp, scenes, mode, card)
            lap(f"{target} {mode}")
        raster_stream_run_check(
            dev, os.path.join(tmp, "both_stream", "final.obj"),
            next(k for k in kernels if k["name"] == "raster_stream"))
        lap("K6 on the run's faces")
        first = first_approach_path(tmp, obj, style)
        first_approach_path(tmp, obj, style, "both",
                            (FA_BOTH_STEPS, FA_BOTH_STEPS))
        hot_loop_a_ms(dev)
        hot_loop_a_ms(dev, "v3")
        lap("first approach")
        small_parity(tmp)
        lap("64² parity")
    print("phase seconds " + json.dumps(seconds))
    # Launches on this slice's path: each raster kernel from the first
    # vertex run of its mode (K7: SoftRas), the VGG kernels from the hard
    # run, the float32 route's kernels from the f32 texture run.
    mode_of = {}
    for mode, (*_, kernel) in VERTEX_RUNS.items():
        mode_of.setdefault(kernel, mode)
    for k in kernels:
        if k.get("dtype") == "float32":
            k["launches"] = f32.get(k["name"], 0)
            continue
        k["launches"] = vertex[mode_of.get(k["name"], "hard")].get(
            k["name"], 0)
        k["launches_texture_target"] = texture.get(k["name"], 0)
        k["launches_first_approach"] = first.get(k["name"], 0)
    kernels += route_entries(kernels, texture, routes)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
