#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``st3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --steps    # only step times (see ``steps_only``)
    python3 chip_smoke.py --nnfm     # only the NNFM kernels (``nnfm_check``)
    python3 chip_smoke.py --k2       # only the bf16 K2 at the bf16 cells'
                                     # shapes (``k2_bf16_cell_check``)

Phases; any failure raises and the script exits non-zero:

1. Card: ``nvidia-smi`` name and power limit, torch/CUDA/nvcc versions, and
   the build of every hand-written kernel from ``st3d_torch/csrc``.
2. Kernel checks at the main path's shapes, each kernel against its plain
   PyTorch version on the same inputs (TF32 off for the plain versions):
   K1 ``raster_hard`` (4 fixed views at 512², ico-sphere level 4):
   pix_to_face exactly equal, zbuf within rtol 1e-6, and p2f and zbuf
   bit-equal to its every-face twin ``raster_hard_every_face`` (the
   earlier walk, launched by no route), timed beside it with the pairs its
   warps' face lists held (``tested``), the twin's and those needed;
   K1's soft mode ``raster_soft`` (the same faces, sigma 1 px):
   pix_to_face and nearest_face exactly equal, zbuf within rtol 1e-6;
   K7 ``raster_topk`` (the same faces, K=4 with a 3 px window as SoftRas
   runs it, and K+slack=5 with the window of blur_radius 1e-4): ids
   exactly equal; each of the two also bit-equal to its every-face twin
   (``raster_soft_every_face``, ``raster_topk_every_face``: the earlier
   walk, launched by no route) and timed beside it, with the (pixel, face)
   pairs its warps' face lists held (``tested``), the twin's and the pairs
   the function needs;
   K6 ``raster_stream``, forced, at 81,920 faces and 256² against its plain
   version (hard and soft: pix_to_face and nearest exactly equal, zbuf
   within rtol 1e-6), and at 327,680 faces x 512² x 4 against K1 (hard and
   soft: pix_to_face and zbuf bit-equal; on a vertex run's faces apart
   only where K6's face lies in a chunk whose band K1 does not test), every
   call also against the TPU kernel's walk ``raster_stream_every_chunk``
   (launched by no route: all outputs equal), with the (pixel, face) pairs
   K6's lists held, the chunks the twin walked and ``stream_counts``;
   K2 at every VGG conv shape at batch 4, forward and input gradient, in
   bf16 on the tensor-core kernel ``conv3x3_wgmma`` (max-abs error <= 1e-2
   * max|plain|) and in f32 on the 3xTF32 tensor-core kernel
   ``conv3x3_tf32x3`` (<= 1e-4 * max|plain|); each call must launch the
   kernel its route names; the float32 K2 also at the f32 cell's shapes
   (``k2_f32_cell_check``: conv2_1 .. conv5_1 at 768², batches 4 and 2,
   forward and dx, and C at conv1_2), each timed beside its 3xTF32 bound
   with its tiles, CTAs and waves; the bf16 K2 at the bf16 cells' shapes
   (``k2_bf16_cell_check``: the same convs at batches 12 and 6, styles3,
   and 4 and 2, bf16.texture, forward and dx, and C at conv1_2, against the
   plain versions), each timed beside its bf16 bound and ``F.conv2d`` in
   bf16 with its box, BN, tiles, CTAs and waves;
   ARF's NNFM kernels at the NNFM cell's shapes (``nnfm_check``): the
   certified matching (hi x hi filter, float64 re-score, fallback) and
   the 3xTF32 matching ``nnfm_match_tf32x3`` over every pair, of 4 and 2
   views' 36,864 rows against 36,864 style rows at 768 channels, on 8,192
   rows the columns of float64's argmax and values within 2e-6, timed
   (the certified one by kernel too, the filter beside its one-product
   bound) beside the 3xTF32 bound and the plain blockwise float32 matmul +
   argmax (TF32 off), which it must beat, with the pairs re-scored and the
   rows scored in full; the centring and the loss rows with their
   backward against their plain versions;
   K2 at the widths TMA cannot stride (``narrow_check``): 3 -> 64 and 64 ->
   3 at 512² x 4, 5 -> 12 and 12 -> 5 at 128² x 4, forward and dx, on
   ``conv3x3_narrow_wgmma`` (bf16) and ``conv3x3_narrow_tf32x3`` (f32) with
   K2's tolerances, bit-equal on exact data in both dtypes; at 512² each
   timed beside ``F.conv2d``;
   K3 at the four style-Gram shapes, in bf16 on ``gram_wgmma`` (relative
   Frobenius error <= 1e-3) and in f32 on the 3xTF32 ``gram_tf32x3``
   (<= 1e-5), and conv1_1's 27-wide PᵀP (4 x 512² x 27) in both dtypes on
   the narrow tensor-core kernel ``gram_narrow`` (bf16 <= 1e-3 of the
   plain version; f32 <= 1e-5 of a float64 Gram, and of the plain version
   within 1e-5 plus the plain float32 sum's own distance from float64),
   timed beside ``torch.bmm`` in the same dtype; each Gram bit-identical on
   a second call;
   stage 1 at 512² x 4 (conv1_1 3->64, conv1_2 64->64), bf16 and f32:
   A (``conv1_1_stats_wgmma`` on the tensor cores in bf16,
   ``conv1_1_stats_tf32x3`` by 3xTF32 in f32, its statistics bit-identical
   on a second call and printed against a float64 sum; timed beside
   ``F.conv2d`` bf16 3 -> 64, the nearest library call to its z half), B
   (``conv1_1_bwd_wgmma`` in bf16, ``conv1_1_bwd_tf32x3`` in f32; its fold
   of the statistics' cotangents held: S = 0, ds27 = 0 or the next image's S
   each move the plain dx by more than ten tolerances), each timed in both
   dtypes by CUDA events and by the kernels' time under
   ``torch.profiler``, C (``conv3x3_relu_pool_wgmma``,
   K2's mainloop with a pool epilogue, in bf16;
   ``conv3x3_relu_pool_tf32x3``, the 3xTF32 mainloop with the pool
   epilogue, in f32), D (``pool_route_wgmma`` on the tensor cores in bf16,
   ``pool_route_tf32x3`` by 3xTF32 in f32); each call on its route's
   kernel; C and D timed beside K2's forward or dx at the same shape, C
   also beside the three-call composition
   ``F.max_pool2d(F.relu(F.conv2d(...)), 2, return_indices=True)``:
   z, dx, pooled and dz max-abs error <= 1e-2 *
   max|plain| in bf16 and <= 1e-4 * max|plain| in f32; PᵀP and s27
   relative Frobenius error <= 1e-4 (sums of 2¹⁸ terms per image, taken in
   another order); idx equal wherever the plain top two of the window
   differ by more than the output tolerance;
   stage 1 v3 at the same shapes: E (``conv1_1_gram_wgmma`` on the tensor
   cores in bf16, ``conv1_1_gram_tf32x3`` by 3xTF32 in f32; z as A's, g64
   relative Frobenius error <= 1e-4, printed against a float64 Gram too,
   bit-identical on a second call) and F (``conv1_1_gram_bwd_wgmma`` in
   bf16, ``conv1_1_gram_bwd_tf32x3`` in f32; dx as B's, in f32 against the
   plain F masked by E's own z > 0, with the values where that mask and
   the plain y > 0 differ counted and each held to |y| <= 1e-5 max|y|;
   its fold of the Gram cotangent held: S = 0 or the next image's S each
   move the plain dx by more than ten tolerances), each call on its
   route's kernel, each timed in both dtypes by CUDA events and by the
   profiler's kernel time; K10c and K10d are C and D at the shapes above;
   K8, C and D at conv2_2's, conv3_4's and conv4_4's shapes (4 x 256² x 128,
   4 x 128² x 256, 4 x 64² x 512), bf16 and f32, with C's and D's
   tolerances, routes and comparisons, each timed in both dtypes;
   K9, G ``raster_2d``, at 512² x 4, ico-sphere level 4, against its plain
   version and its every-face twin ``raster_2d_every_face`` (the earlier
   kernel, launched by no route): p2f and zbuf bit-equal, timed beside the
   twin and K1 with the pairs its warps' lists held (``tested``), the
   twin's and those needed; at level 7 (327,680 faces) the same against the
   twin; at both levels against K1: zbuf bit-equal, ids different only at
   exact 1/z ties (both faces cover the pixel with bit-equal 1/z), counted;
   it fails unless G is faster than its twin at both.
   Times are CUDA-event means after warm-up (bf16); K1 and the narrow K3
   also print their device time under ``torch.profiler``. Each kernel's bound is
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
   TFLOP/s; the 3xTF32 E and F count three TF32 products too.
3. The second approach (``st3d_torch.second_approach.main``) at 512², 4
   views, batch 4, bf16, 20 epochs on a seeded synthetic scene, on the
   default VGG route: every loss finite, the last below the first,
   ``final.obj`` and ``final_render/`` written, all seven kernels launched
   (K2, K3, A, B, C and D only on the tensor cores, no ``gram_narrow`` on
   any route but the two below).
   Then 5 epochs each on PR 1's route (``ST3D_NO_STAGE1_V2=1
   ST3D_NO_PACKED1=1``: K1-K3 only) and on the K5 route
   (``ST3D_NO_STAGE1_V2=1``: C and D, not A and B), where conv1_1's
   27-wide PᵀP takes ``gram_narrow`` exactly once a step (PR 1's route
   also in float32), and 20 epochs each on
   the v3 route (``ST3D_STAGE1=v3``: E and F on the tensor cores,
   ``conv1_1_gram_wgmma`` and ``conv1_1_gram_bwd_wgmma``, not A and B)
   and the
   fused-pool route (``ST3D_FUSED_POOL=1``: the default's kernels, C and D
   four times as often, ``conv3x3_wgmma`` three times fewer for each C and
   each D).
   Then the texture step in float32, the CLIs' default dtype, 10 epochs on
   the default route: K2, K3, C and D only on their 3xTF32 kernels
   (``conv3x3_tf32x3``, ``gram_tf32x3`` four times a step,
   ``conv3x3_relu_pool_tf32x3`` once a step, ``pool_route_tf32x3``; A
   and B by 3xTF32, ``conv1_1_stats_tf32x3`` and ``conv1_1_bwd_tf32x3``);
   its median step. Then 10 epochs of it on the v3 route: E and F by 3xTF32
   (``conv1_1_gram_tf32x3`` once a step plus A's set-up launches,
   ``conv1_1_gram_bwd_tf32x3`` once a step) in place of A and B; the loss
   falling.
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
   step time of the last 5 epochs; the hard run four times more
   (``hard_twin_runs``): with every K1 call held bit for bit against its
   every-face twin on the same faces, then with PyTorch's deterministic
   algorithms asked for, with K1, with the twin in K1's place (its losses
   bit-equal to K1's wherever K1's run repeats bit for bit) and with K1
   again. Then K1 on the faces of the hard run's ``final.obj``,
   held, counted and timed as on the sphere.
   Then K6 on the faces of the 327,680-face
   run as its ``final.obj`` holds them (``raster_stream_run_check``): hard
   and soft bit-equal to K1's outputs and to the every-chunk walk, ids (and
   nearest) bit-equal to the plain version at 64² to 128², the counts and
   the times of both walks and K1. Then K1-soft on the soft run's
   ``final.obj`` and K7 (both cases) on the SoftRas run's
   (``raster_lists_run_check``), held, counted and timed as on the sphere.
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
   dtype's route, A and B on theirs (none on v3), E and F on theirs on v3
   only (by 3xTF32 in f32), and the f32 fused-pool run C and D four times
   as often as the f32 default run.
6. The multi-style engine (``st3d_torch.multi_style.main``) with 3 seeded
   styles at 512², 4 views (a VGG batch of 12), bf16, 10 epochs: every
   style's loss falling, the step's K2, K3 and A-D launches those of the
   single-style texture step (22, 4, 1, 1, 1, 1 a step, beside the same
   set-up launches) and K1 only for the visibility, the content render and
   the final renders; the median step and peak memory
   (``torch.cuda.max_memory_allocated``); then float32, 5 epochs, each
   style's texture within 2e-4 max-abs of a single-style
   ``second_approach`` run of it (the JAX package's batched-vs-sequential
   tolerance).
7. The batched fleet (``st3d_torch.fleet.main``): the level-4 sphere and a
   UV-less level-3 sphere (1,280 faces padded to 5,120, auto-UV) x 2
   styles (16 images a step), bf16, 10 epochs: every cell's loss falling,
   the visibility one K1 launch over 8 views, each mesh's p2f (ids below
   its face count) and zbuf from ``fleet_visibility`` bit-equal to the
   mesh's own unpadded launch; the median step and peak memory; then
   float32, 5 epochs, every cell within 2e-4 of ``--fleet_mode
   sequential``, every ``<mesh>/<style>/final.obj`` written by both.
8. Padding: the level-4 sphere padded by +301 faces, +37 vertices and +11
   UVs through K1, K1-soft, K6 (forced, hard and soft) and K7 (K = 4, 3
   px): every output bit-equal to the unpadded faces'.
9. Checkpoint and resume, under PyTorch's deterministic algorithms. The
   first approach (bf16, 3 + 6 steps, ``--checkpoint_every 4``): whole
   with ``--profile`` (its trace naming K2's kernel), and cut right after
   the mid-batch checkpoint, then resumed with ``--debug_nan``: the log
   resumes at step 4, bit-equal to the whole run where its first four
   steps repeat, else within rtol 1e-3. Then the bf16 texture target (the
   ops without a deterministic version printed): 3 epochs with
   ``--checkpoint_every 3`` resumed to 6, against 6 uninterrupted epochs
   run twice; the resumed log starts at epoch 3; bit-equal where the two
   uninterrupted runs repeat bit for bit, else within rtol 1e-3; and
   whether two runs repeat without the flag (printed, not held).
10. ``--debug_nan`` on the bf16 texture run (no alarm, the unguarded
   losses); ``--profile`` on the multi-style and fleet runs in bf16 and
   float32, each trace naming the hand-written K2 and K3 kernels, and
   the device ms per step of each from ``profile/device_ms.json``.
11. Data and tile parallelism (``parallel_phase``): a 1-rank NCCL group on
   cuda:0 (``all_reduce``, ``broadcast``, ``all_gather``); K1 on every
   band of 256 and 128 rows at 512² x 4 with the band's first row
   (``row0``) against its plain version and its whole frame's rows, K6
   forced on the same bands at 327,680 faces against K1 and its whole
   frame, and at 81,920 faces x 256² against its plain version; the
   pixels the JAX package's ``y -= r0`` band form flips at 1024² x 12
   views (printed). Then worlds of ranks sharing cuda:0 over gloo, each
   rank a process of this script (``--rank SPEC``): on 2 ranks the three
   collectives on CUDA tensors, the second approach with
   ``--data_parallel`` (bf16 20 epochs, f32 10: every rank's texture
   hash equal, losses within 1e-2 and 2e-4 relative of phase 3's runs,
   the step's VGG launches on rank 0), the first approach (30 + 20 steps,
   within 1e-3 of phase 4's) and two 1024² runs (2 epochs, deterministic
   algorithms), one with ``--tile_parallel``, whose 12 ``final_render``
   PNGs equal a world of 1's pixel for pixel; on 3 ranks multi-style (3
   styles) and the fleet (2 x 2 over a 1 x 3 grid of ranks, padded to 2 x
   3) in bf16 (cells held as in phases 6 and 7) and f32 (within 2e-4 of
   them). Each run prints its median step labelled by the ranks sharing
   the card and each rank's peak memory.
12. The wall seconds of each phase, the card's name and power limit, one
   JSON line with the kernels' results (each kernel also with its
   launches on the multi-style and fleet paths) (ptxas's registers and spills of
   the tensor-core kernels, K1, K1-soft, K7 and G are printed after the
   build),
   then the last line
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
# Every K2, K3, A, B, C and D launch takes the tensor-core kernels; so does
# conv1_1's 27-wide PᵀP Gram (``gram_narrow``), once a step, on the two
# routes with stage 1 off.
KERNELS = ("raster_hard", "conv3x3_wgmma", "gram_wgmma",
           "conv1_1_stats_wgmma", "conv1_1_bwd_wgmma",
           "conv3x3_relu_pool_wgmma", "pool_route_wgmma")
# The default route in float32: K2, K3, A, B, C and D on 3xTF32.
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
# E and F by dtype, both on the tensor cores: bf16 on wgmma, float32 by
# 3xTF32 (kernels/stage1v3.py::v3_route).
V3_KEYS = {"bfloat16": ("conv1_1_gram_wgmma", "conv1_1_gram_bwd_wgmma"),
           "float32": ("conv1_1_gram_tf32x3", "conv1_1_gram_bwd_tf32x3")}
# The v3 route in float32: E and F by 3xTF32 in place of A and B, the rest
# as the float32 default route.
F32_V3_KERNELS = (F32_KERNELS - {"conv1_1_stats_tf32x3", "conv1_1_bwd_tf32x3"}
                  | set(V3_KEYS["float32"]))
ROUTE_ENV = ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1",
             "ST3D_FUSED_POOL")
ROUTES = {
    "default": ({}, set(KERNELS)),
    "v3": ({"ST3D_STAGE1": "v3"},
           set(KERNELS) - {"conv1_1_stats_wgmma", "conv1_1_bwd_wgmma"}
           | set(V3_KEYS["bfloat16"])),
    "fused_pool": ({"ST3D_FUSED_POOL": "1"}, set(KERNELS)),
    "pr1": ({"ST3D_NO_STAGE1_V2": "1", "ST3D_NO_PACKED1": "1"},
            {"raster_hard", "conv3x3_wgmma", "gram_wgmma", "gram_narrow"}),
    "k5": ({"ST3D_NO_STAGE1_V2": "1"},
           {"raster_hard", "conv3x3_wgmma", "gram_wgmma", "gram_narrow",
            "conv3x3_relu_pool_wgmma", "pool_route_wgmma"}),
}
STAGE1_OFF = ("pr1", "k5")     # conv1_1's PᵀP: one gram_narrow launch a step
# PR 1's route in float32: K2 and K3 on 3xTF32, the PᵀP on gram_narrow.
PR1_F32_KERNELS = {"raster_hard", "conv3x3_tf32x3", "gram_tf32x3",
                   "gram_narrow"}
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
    for name in build.REPORT_SOURCES:
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


def _hard_held(kr, coeffs, bounds, what):
    """K1 (per-warp face lists) on faces at 512² against its every-face twin
    (p2f and zbuf bit-equal) and its plain version (ids bit-equal, zbuf
    within rtol 1e-6); its time and the twin's, and the pairs its lists
    held (``tested``) beside the twin's and the function's."""
    import torch

    cnt = torch.zeros(1, dtype=torch.int64, device=coeffs.device)
    before = dict(kr.LAUNCHES)
    got = kr.raster_hard(coeffs, bounds, SIZE, SIZE, cnt)
    twin = kr.raster_hard_every_face(coeffs, bounds, SIZE, SIZE)
    launched = {k: n - before[k] for k, n in kr.LAUNCHES.items()
                if n != before[k]}
    want = kr.raster_hard_plain(coeffs, bounds, SIZE, SIZE)
    torch.cuda.synchronize()
    same = torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
    mismatch = int((got[0] != want[0]).sum())
    hit = want[0] >= 0
    zrel = float(((got[1] - want[1]).abs() / want[1].abs())[hit].max())
    covered = float(hit.float().mean())
    ms = cuda_ms(lambda: kr.raster_hard(coeffs, bounds, SIZE, SIZE))
    twin_ms = cuda_ms(lambda: kr.raster_hard_every_face(coeffs, bounds, SIZE,
                                                        SIZE))
    dev_ms = profiled_ms(lambda: kr.raster_hard(coeffs, bounds, SIZE,
                                                SIZE))[0]
    twin_dev_ms = profiled_ms(lambda: kr.raster_hard_every_face(
        coeffs, bounds, SIZE, SIZE))[0]
    res = {"ms": ms, "every_face_ms": twin_ms, "device_ms": dev_ms,
           "every_face_device_ms": twin_dev_ms, "tested": int(cnt),
           "tested_every_face": tested_pairs(bounds, SIZE, 256, 0.0),
           "needed": needed_pairs(coeffs, SIZE, 0.0),
           "max_abs_err": float((got[1] - want[1]).abs().max()),
           "every_face_max_abs_err": float((twin[1] - want[1]).abs().max())}
    print(f"K1 raster_hard on {what}: coverage {covered:.4f}, pix_to_face "
          f"mismatches {mismatch}, zbuf max rel err {zrel:.3g} against the "
          f"plain version; p2f and zbuf bit-equal to the every-face twin "
          f"{same}; kernel {ms:.3f} ms ({dev_ms:.4f} device), every-face "
          f"twin {twin_ms:.3f} ms ({twin_dev_ms:.4f} device); "
          f"pairs tested {res['tested']} (every-face walk "
          f"{res['tested_every_face']}), {res['needed']} needed (bbox); "
          f"launches {json.dumps(launched)}")
    if mismatch:
        fail(f"K1 pix_to_face on {what} differs from its plain version at "
             f"{mismatch} px")
    if zrel > 1e-6:
        fail(f"K1 zbuf rel err on {what} {zrel} > 1e-6")
    if not same:
        fail(f"K1 on {what} differs from its every-face twin")
    if launched != {"raster_hard": 1, "raster_hard_every_face": 1}:
        fail(f"K1 on {what}: launched {launched}")
    if not 0 < res["tested"] < res["tested_every_face"]:
        fail(f"K1 on {what}: its lists held {res['tested']} pairs, the "
             f"every-face walk tests {res['tested_every_face']}")
    if covered < 0.05:
        fail(f"K1 test scene {what} covers only {covered} of the pixels")
    return res


def raster_check(dev):
    """K1 at the main path's shapes (the level-4 sphere at 512²), held by
    ``_hard_held``; rows for the kernel and for its every-face twin."""
    from st3d_torch.kernels import raster as kr

    fv, coeffs, bounds = sphere_faces(dev, ICO_LEVEL, SIZE)
    res = _hard_held(kr, coeffs, bounds,
                     f"the level-{ICO_LEVEL} sphere ({fv.shape[1]} faces)")
    plain_ms = cuda_ms(lambda: kr.raster_hard_plain(coeffs, bounds, SIZE,
                                                    SIZE), reps=3, warmup=1)
    print(f"K1 raster_hard: plain {plain_ms:.3f} ms")
    flops = res["needed"] * PAIR_OPS["hard"]
    nbytes = raster_bytes(coeffs, 12, bounds, 8, SIZE)
    common = {"route": "cuda", "source": "st3d_torch/csrc/raster_hard.cu",
              "replaces": "st3d/kernels/raster_pallas.py:134",
              "plain_ms": plain_ms}
    rec = with_bound(dict(common, name="raster_hard", **res), flops, nbytes,
                     F32_FLOPS)
    twin = with_bound(dict(common, name="raster_hard_every_face",
                           ms=res["every_face_ms"],
                           device_ms=res["every_face_device_ms"],
                           max_abs_err=res["every_face_max_abs_err"],
                           tested=res["tested_every_face"]),
                      flops, nbytes, F32_FLOPS)
    return [rec, twin]


def raster_hard_run_check(dev, obj, rec):
    """K1 on the faces of the hard vertex run, as its ``final.obj`` holds
    them, held as on the sphere; adds the results to K1's row."""
    from st3d_torch.kernels import raster as kr

    coeffs, bounds = run_faces(dev, obj, SIZE)
    rec["run"] = _hard_held(kr, coeffs, bounds, "the hard run's final.obj")


def _soft_held(kr, coeffs, bounds, what):
    """K1-soft (per-warp face lists) on faces at 512² against its every-face
    twin (all outputs bit-equal), its plain version (ids bit-equal, zbuf
    within rtol 1e-6) and K1 (hard outputs bit-equal); its time and the
    twin's, and the pairs its lists held (``tested``) beside the twin's and
    the function's."""
    import torch

    margin = kr.soft_cull_margin(1.0)
    tile = kr.cull_tile(SIZE, SIZE, True)
    cnt = torch.zeros(1, dtype=torch.int64, device=coeffs.device)
    before = dict(kr.LAUNCHES)
    got = kr.raster_soft(coeffs, bounds, SIZE, SIZE, margin, tile, cnt)
    twin = kr.raster_soft_every_face(coeffs, bounds, SIZE, SIZE, margin,
                                     tile)
    launched = {k: n - before[k] for k, n in kr.LAUNCHES.items()
                if n != before[k]}
    want = kr.raster_soft_plain(coeffs, bounds, SIZE, SIZE, margin, tile)
    hard = kr.raster_hard(coeffs, bounds, SIZE, SIZE)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, twin))
    bad = int((got[0] != want[0]).sum()) + int((got[2] != want[2]).sum())
    hit = want[0] >= 0
    zerr = float((got[1] - want[1]).abs().max())
    zrel = float(((got[1] - want[1]).abs() / want[1].abs())[hit].max())
    k1 = torch.equal(got[0], hard[0]) and torch.equal(got[1], hard[1])
    ms = cuda_ms(lambda: kr.raster_soft(coeffs, bounds, SIZE, SIZE, margin,
                                        tile))
    twin_ms = cuda_ms(lambda: kr.raster_soft_every_face(
        coeffs, bounds, SIZE, SIZE, margin, tile))
    res = {"ms": ms, "every_face_ms": twin_ms, "tested": int(cnt),
           "tested_every_face": tested_pairs(bounds, SIZE, tile, margin),
           "needed": needed_pairs(coeffs, SIZE, margin), "max_abs_err": zerr}
    print(f"K1 raster_soft on {what}: pix_to_face + nearest mismatches "
          f"{bad}, zbuf max rel err {zrel:.3g} against the plain version; "
          f"all outputs bit-equal to the every-face twin {same}; hard "
          f"outputs equal to K1's {k1}; kernel {ms:.3f} ms, every-face twin "
          f"{twin_ms:.3f} ms; pairs tested {res['tested']} (every-face walk "
          f"{res['tested_every_face']}), {res['needed']} needed (bbox + "
          f"{margin} px); launches {json.dumps(launched)}")
    if bad or zrel > 1e-6:
        fail(f"K1 soft on {what} differs from its plain version: {bad} ids, "
             f"zbuf rel {zrel}")
    if not same:
        fail(f"K1 soft on {what} differs from its every-face twin")
    if not k1:
        fail(f"K1 soft's pix_to_face/zbuf differ from K1's on {what}")
    if launched != {"raster_soft": 1, "raster_soft_every_face": 1}:
        fail(f"K1 soft on {what}: launched {launched}")
    if not 0 < res["tested"] < res["tested_every_face"]:
        fail(f"K1 soft on {what}: its lists held {res['tested']} pairs, the "
             f"every-face walk tests {res['tested_every_face']}")
    return res


def raster_soft_check(dev):
    """K1's soft mode at the main path's shapes (the level-4 sphere at 512²,
    sigma 1 px), held by ``_soft_held``."""
    from st3d_torch.kernels import raster as kr

    _, coeffs, bounds = sphere_faces(dev, ICO_LEVEL, SIZE)
    res = _soft_held(kr, coeffs, bounds, f"the level-{ICO_LEVEL} sphere")
    margin = kr.soft_cull_margin(1.0)
    tile = kr.cull_tile(SIZE, SIZE, True)
    plain_ms = cuda_ms(lambda: kr.raster_soft_plain(
        coeffs, bounds, SIZE, SIZE, margin, tile), reps=3, warmup=1)
    print(f"K1 raster_soft: plain {plain_ms:.3f} ms")
    return with_bound({"name": "raster_soft", "route": "cuda",
                       "source": "st3d_torch/csrc/raster_soft.cu",
                       "replaces": "st3d/kernels/raster_pallas.py:202",
                       "plain_ms": plain_ms, **res},
                      res["needed"] * PAIR_OPS["soft"],
                      raster_bytes(coeffs, 19, bounds, 12, SIZE), F32_FLOPS)


def topk_cases():
    """K7's two cases, (K, window): SoftRas K=4 in a 3 px window, and the
    hard blur path's K+slack=5 in blur_radius 1e-4's window."""
    from st3d_torch.render.topk import blur_window_px

    return {"softras": (4, 3.0), "blur": (5, blur_window_px(1e-4, SIZE))}


def _topk_held(kr, coeffs, bounds, k, window, what):
    """K7 (per-warp face lists) on faces at 512² against its every-face twin
    and its plain version (ids bit-equal to both); its time and the twin's,
    and the pairs its lists held beside the twin's and the function's."""
    import torch

    cnt = torch.zeros(1, dtype=torch.int64, device=coeffs.device)
    before = dict(kr.LAUNCHES)
    got = kr.raster_topk(coeffs, bounds, SIZE, SIZE, k, window, cnt)
    twin = kr.raster_topk_every_face(coeffs, bounds, SIZE, SIZE, k, window)
    launched = {n: c - before[n] for n, c in kr.LAUNCHES.items()
                if c != before[n]}
    want = kr.raster_topk_plain(coeffs, bounds, SIZE, SIZE, k, window)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    same = torch.equal(got, twin)
    ms = cuda_ms(lambda: kr.raster_topk(coeffs, bounds, SIZE, SIZE, k,
                                        window))
    twin_ms = cuda_ms(lambda: kr.raster_topk_every_face(
        coeffs, bounds, SIZE, SIZE, k, window))
    filled = [float((got[..., s] >= 0).float().mean()) for s in range(k)]
    res = {"k": k, "window": window, "ms": ms, "every_face_ms": twin_ms,
           "tested": int(cnt),
           "tested_every_face": tested_pairs(bounds, SIZE, 256, window + 2.0),
           "needed": needed_pairs(coeffs, SIZE, window),
           "eligible": eligible_pairs(coeffs, SIZE, window),
           "id_err": int((got - want).abs().max()), "id_mismatches": bad}
    print(f"K7 raster_topk on {what} K={k} window {window:.3f}: id "
          f"mismatches {bad} against the plain version, bit-equal to the "
          f"every-face twin {same}; filled share per slot "
          + " ".join(f"{f:.3f}" for f in filled)
          + f"; kernel {ms:.3f} ms, every-face twin {twin_ms:.3f} ms; pairs "
          f"tested {res['tested']} (every-face walk "
          f"{res['tested_every_face']}), {res['needed']} needed (bbox + "
          f"{window:.3f} px), {res['eligible']} of them eligible; launches "
          f"{json.dumps(launched)}")
    if bad:
        fail(f"K7 on {what} K={k}: {bad} ids differ from the plain version")
    if not same:
        fail(f"K7 on {what} K={k} differs from its every-face twin")
    if launched != {"raster_topk": 1, "raster_topk_every_face": 1}:
        fail(f"K7 on {what}: launched {launched}")
    if not 0 < res["tested"] < res["tested_every_face"]:
        fail(f"K7 on {what}: its lists held {res['tested']} pairs, the "
             f"every-face walk tests {res['tested_every_face']}")
    return res


def raster_topk_check(dev):
    """K7 at the main path's shapes, held by ``_topk_held``: K=4 with
    SoftRas's 3 px window, and K+slack=5 with the window of blur_radius
    1e-4 (the hard blur path)."""
    from st3d_torch.kernels import raster as kr

    _, coeffs, bounds = sphere_faces(dev, ICO_LEVEL, SIZE)
    cases = {what: _topk_held(kr, coeffs, bounds, k, window,
                              f"the level-{ICO_LEVEL} sphere, {what}")
             for what, (k, window) in topk_cases().items()}
    res = cases["softras"]
    k, window = res["k"], res["window"]
    plain_ms = cuda_ms(lambda: kr.raster_topk_plain(
        coeffs, bounds, SIZE, SIZE, k, window), reps=2, warmup=1)
    print(f"K7 raster_topk K={k}: plain {plain_ms:.3f} ms")
    # max_abs_err: the largest |id - plain id| over both cases.
    return with_bound({"name": "raster_topk", "route": "cuda",
                       "source": "st3d_torch/csrc/raster_topk.cu",
                       "replaces": "st3d/kernels/raster_pallas.py:693",
                       "max_abs_err": float(max(c["id_err"]
                                                for c in cases.values())),
                       "id_mismatches": sum(c["id_mismatches"]
                                            for c in cases.values()),
                       "ms": res["ms"], "plain_ms": plain_ms,
                       "every_face_ms": res["every_face_ms"],
                       "tested": res["tested"],
                       "tested_every_face": res["tested_every_face"],
                       "blur": cases["blur"]},
                      res["needed"] * PAIR_OPS["topk_test"]
                      + res["eligible"] * PAIR_OPS["topk_eligible"],
                      raster_bytes(coeffs, 19, bounds, 4 * k, SIZE),
                      F32_FLOPS)


def run_faces(dev, obj, size):
    """Coefficients and bounds of a vertex run's ``final.obj`` under the
    runs' fixed cameras at ``size``."""
    import torch
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.io.obj import load_obj
    from st3d_torch.kernels import raster as kr
    from st3d_torch.render.rasterize import face_verts_screen

    data = load_obj(obj, load_textures=False)
    verts = torch.tensor(data.verts, device=dev)
    faces = torch.tensor(data.faces, device=dev).long()
    cams = build_fixed_cameras(VIEWS, seed=0).to(dev)
    return kr.preprocess(face_verts_screen(verts, faces, cams, size))[:2]


def raster_lists_run_check(dev, soft_obj, softras_obj, soft_rec, topk_rec):
    """K1-soft on the faces of the soft vertex run and K7 (both cases) on
    those of the SoftRas run, as their ``final.obj`` holds them, held as on
    the sphere; adds each run's results to the kernels' rows."""
    from st3d_torch.kernels import raster as kr

    coeffs, bounds = run_faces(dev, soft_obj, SIZE)
    soft_rec["run"] = _soft_held(kr, coeffs, bounds,
                                 "the soft run's final.obj")
    coeffs, bounds = run_faces(dev, softras_obj, SIZE)
    topk_rec["run"] = {
        what: _topk_held(kr, coeffs, bounds, k, window,
                         f"the SoftRas run's final.obj, {what}")
        for what, (k, window) in topk_cases().items()}


def stream_counts(coeffs, bounds, ranges, size):
    """K6's work in hard mode on these faces, over the 256-pixel blocks (at
    512² each lies in one image row): the chunks walked (the ranges'
    lengths, every one of which K6 and the TPU kernel's walk test), the
    chunks whose row band meets the block's rows (the ones K1 tests), the
    faces of those chunks whose own y-extent meets the rows, the faces of
    the mesh that do, and the (pixel, face) pairs needed."""
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
    return {"walked": int(spans.sum()), "in_band": int(ov.sum()),
            "faces_in_band": int((block_rows * ov).sum()),
            "faces_in_rows": int(rows.sum()) * per_row,
            "pairs": needed_pairs(coeffs, size, 0.0)}


def _stream_pair(kr, coeffs, bounds, size, soft):
    """K6 and its every-chunk twin on the same inputs: fails unless all
    outputs are equal. Returns K6's outputs, the ranges, tile and margin,
    the (pixel, face) pairs K6's lists held and the chunks the twin
    walked."""
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


def _stream_vs_k1(kr, got, want, bounds, size, soft, tile, margin):
    """K6's outputs ``got`` against K1's (soft: K1-soft's) ``want`` on the
    same faces: fails unless they are equal at every pixel but those where
    K6's face (covering, or nearest) lies in a chunk whose band misses the
    pixel's cull band, so that K1 never tests it there, and where K6's
    covering face is no farther than K1's. Every chunk K1 tests is in K6's
    range, so K6 picks from a superset of K1's faces, in the same order:
    where its pick is a face K1 tests, the two picks are one. Returns the
    pixels where pix_to_face or zbuf differ, and where nearest does."""
    import torch

    apart = (got[0] != want[0]) | (got[1] != want[1])
    past = kr.outside_band(bounds, got[0], size, size, tile, margin)
    ok = (~apart | past) & (got[1] <= want[1])
    near = torch.zeros_like(apart)
    if soft:
        near = got[2] != want[2]
        ok &= ~near | kr.outside_band(bounds, got[2], size, size, tile,
                                      margin)
    if not bool(ok.all()):
        fail(f"K6 soft={soft} differs from K1 at {int((~ok).sum())} pixels "
             f"where K1 tests K6's face")
    return int(apart.sum()), int(near.sum())


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
              f"pairs tested {n_new}, chunks walked {n_old}")
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
              + near + f"; pairs tested {n_new}, chunks walked {n_old}")
        if not same:
            fail(f"K6 soft={soft} differs from K1 at 327,680 faces")
        if not soft:
            hard = (tile, ranges, n_new)
    tile, ranges, pairs = hard
    ms = cuda_ms(lambda: kr.raster_stream(coeffs, bounds, ranges, SIZE, SIZE,
                                          tile, False), reps=10)
    old_ms = cuda_ms(lambda: kr.raster_stream_every_chunk(
        coeffs, bounds, ranges, SIZE, SIZE, tile, False), reps=3, warmup=1)
    k1_ms = cuda_ms(lambda: kr.raster_hard(coeffs, bounds, SIZE, SIZE),
                    reps=3, warmup=1)
    cnt = stream_counts(coeffs, bounds, ranges, SIZE)
    cnt["tested"] = pairs
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
    ``stream_counts``; hard and soft equal to the every-chunk walk, and
    to K1's outputs (soft: K1-soft's) but where ``_stream_vs_k1`` allows;
    ids and nearest bit-equal to the plain version on the same faces at the
    largest of 128², 96² and 64² whose walk the plain version finishes in
    seconds; times. Updates ``rec`` (the K6 row) with these faces' time and
    bound."""
    import torch
    from st3d_torch.kernels import raster as kr

    coeffs, bounds = run_faces(dev, obj, SIZE)
    for soft in (False, True):
        got, ranges, tile, margin, n_new, n_old = _stream_pair(
            kr, coeffs, bounds, SIZE, soft)
        want = (kr.raster_soft(coeffs, bounds, SIZE, SIZE, margin, tile)
                if soft else kr.raster_hard(coeffs, bounds, SIZE, SIZE))
        torch.cuda.synchronize()
        apart, near = _stream_vs_k1(kr, got, want, bounds, SIZE, soft, tile,
                                    margin)
        print(f"K6 on the vertex run's faces soft={soft}: equal to the "
              f"every-chunk walk; apart from K1{'-soft' if soft else ''} in "
              f"pix_to_face or zbuf at {apart} pixels"
              + (f", in nearest at {near}" if soft else "")
              + f", each where K1 does not test K6's face; pairs tested "
              f"{n_new}, chunks walked {n_old}")
        if not soft:
            hard = (tile, ranges, n_new, apart)
    tile, ranges, pairs, apart = hard
    ms = cuda_ms(lambda: kr.raster_stream(coeffs, bounds, ranges, SIZE, SIZE,
                                          tile, False), reps=10)
    old_ms = cuda_ms(lambda: kr.raster_stream_every_chunk(
        coeffs, bounds, ranges, SIZE, SIZE, tile, False), reps=3, warmup=1)
    k1_ms = cuda_ms(lambda: kr.raster_hard(coeffs, bounds, SIZE, SIZE),
                    reps=3, warmup=1)
    ranges_ms = cuda_ms(lambda: kr.stream_ranges(bounds, SIZE, SIZE, tile,
                                                 0.0), reps=3, warmup=1)
    cnt = stream_counts(coeffs, bounds, ranges, SIZE)
    cnt["tested"] = pairs
    cnt["apart_from_k1"] = apart
    print(f"K6 raster_stream hard on the vertex run's faces: kernel "
          f"{ms:.3f} ms, every-chunk walk {old_ms:.3f} ms, K1 {k1_ms:.3f} "
          f"ms, stream_ranges {ranges_ms:.3f} ms; counts " + json.dumps(cnt))
    # The plain version tests every pair its ranges hold: the largest size
    # whose walk holds at most 2e9 pairs.
    for size in (128, 96, 64):
        c_s, b_s = run_faces(dev, obj, size)
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
              f"version {same}; pairs tested {n_new}, chunks walked {n_old}")
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


def tested_pairs_2d(kr, bounds, size):
    """(pixel, face) pairs G's every-face twin tests on this data: every
    face of every chunk ``cull_2d`` leaves, at every pixel of the tile."""
    return int(kr.cull_2d(bounds, size, size).sum()) * 256 * kr.FACE_CHUNK


def _2d_held(kr, coeffs, bounds, what, plain=True):
    """G (per-warp face lists on 2D tiles) on faces at 512² against its
    every-face twin and, if ``plain``, its plain version: p2f and zbuf
    bit-equal, one launch each; its pairs (``tested``) beside the twin's.
    Returns (tested, the twin's, zbuf max abs err of G and of the twin
    against the plain version, None without it)."""
    import torch

    cnt = torch.zeros(1, dtype=torch.int64, device=coeffs.device)
    before = dict(kr.LAUNCHES)
    got = kr.raster_2d(coeffs, bounds, SIZE, SIZE, cnt)
    twin = kr.raster_2d_every_face(coeffs, bounds, SIZE, SIZE)
    launched = {k: n - before[k] for k, n in kr.LAUNCHES.items()
                if n != before[k]}
    torch.cuda.synchronize()
    tested, every = int(cnt), tested_pairs_2d(kr, bounds, SIZE)
    refs = {"twin": twin}
    if plain:
        refs["plain version"] = kr.raster_2d_plain(coeffs, bounds, SIZE, SIZE)
    same = {k: torch.equal(got[0], r[0]) and torch.equal(got[1], r[1])
            for k, r in refs.items()}
    errs = [float((z - refs["plain version"][1]).abs().max()) if plain
            else None for z in (got[1], twin[1])]
    print(f"K9 raster_2d on {what}: p2f and zbuf bit-equal to "
          f"{json.dumps(same)}; pairs tested {tested} (every-face twin "
          f"{every}); launches {json.dumps(launched)}")
    if not all(same.values()):
        fail(f"K9 on {what} differs from {same}")
    if launched != {"raster_2d": 1, "raster_2d_every_face": 1}:
        fail(f"K9 on {what}: launched {launched}")
    if not 0 < tested < every:
        fail(f"K9 on {what}: its lists held {tested} pairs, the every-face "
             f"twin tests {every}")
    return tested, every, errs


def raster_2d_check(dev):
    """K9's G at 512² x 4 on the ico-sphere at level 4 and at level 7
    (327,680 faces), each against its every-face twin and (level 4) its
    plain version by ``_2d_held``, timed beside the twin and K1, and
    against K1 at both levels: zbuf bit-equal, ids apart only at exact
    ties. Rows for G and its twin; no path launches either."""
    import torch
    from st3d_torch.kernels import raster as kr

    fv, coeffs1, bounds1 = sphere_faces(dev, ICO_LEVEL, SIZE)
    coeffs, bounds, _ = kr.preprocess_2d(fv, SIZE)
    tested, every, errs = _2d_held(kr, coeffs, bounds,
                                   f"the level-{ICO_LEVEL} sphere")
    ms = cuda_ms(lambda: kr.raster_2d(coeffs, bounds, SIZE, SIZE))
    twin_ms = cuda_ms(lambda: kr.raster_2d_every_face(coeffs, bounds, SIZE,
                                                      SIZE))
    dev_ms = profiled_ms(lambda: kr.raster_2d(coeffs, bounds, SIZE,
                                              SIZE))[0]
    twin_dev_ms = profiled_ms(lambda: kr.raster_2d_every_face(
        coeffs, bounds, SIZE, SIZE))[0]
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
    # The plain version would take minutes on 1.8 M (tile, chunk) pairs.
    tested7, every7, _ = _2d_held(kr, c7, b7, f"{fv.shape[1]} faces",
                                  plain=False)
    ms7 = cuda_ms(lambda: kr.raster_2d(c7, b7, SIZE, SIZE), reps=3, warmup=1)
    twin_ms7 = cuda_ms(lambda: kr.raster_2d_every_face(c7, b7, SIZE, SIZE),
                       reps=3, warmup=1)
    k7 = kr.preprocess(fv)
    k1_ms7 = cuda_ms(lambda: kr.raster_hard(k7[0], k7[1], SIZE, SIZE),
                     reps=3, warmup=1)
    pairs = needed_pairs(coeffs, SIZE, 0.0)
    print(f"K9 raster_2d level {ICO_LEVEL}: kernel {ms:.4f} ms "
          f"({dev_ms:.4f} device), every-face twin {twin_ms:.4f} "
          f"({twin_dev_ms:.4f} device), K1 {k1_ms:.4f}, plain "
          f"{plain_ms:.3f} ms; pairs tested {tested} (twin {every}), "
          f"{pairs} needed (bbox); at {fv.shape[1]} faces {ms7:.3f} ms "
          f"(twin {twin_ms7:.3f}, K1 {k1_ms7:.3f}), pairs tested {tested7} "
          f"(twin {every7})")
    for what, new, old in (("level 4", ms, twin_ms),
                           (f"{fv.shape[1]} faces", ms7, twin_ms7)):
        if not new < old:
            fail(f"K9 at {what}: {new:.4f} ms, its every-face twin {old:.4f}")
    common = {"route": "cuda", "source": "st3d_torch/csrc/raster_2d.cu",
              "replaces": "st3d/kernels/raster_pallas.py:885",
              "plain_ms": plain_ms, "k1_ms": k1_ms,
              "k1_ms_327680_faces": k1_ms7, "needed": pairs,
              "path": "none: no entry point calls K9, in the JAX package or "
                      "the port"}
    flops = pairs * PAIR_OPS["hard"]
    nbytes = raster_bytes(coeffs, 12, bounds, 8, SIZE)
    rec = with_bound(dict(
        common, name="raster_2d", max_abs_err=errs[0], ms=ms,
        device_ms=dev_ms,
        every_face_ms=twin_ms, every_face_device_ms=twin_dev_ms,
        tested=tested, tested_every_face=every, ms_327680_faces=ms7,
        every_face_ms_327680_faces=twin_ms7, tested_327680_faces=tested7,
        tested_every_face_327680_faces=every7,
        tie_pixels_vs_k1={str(k): v for k, v in ties.items()}),
        flops, nbytes, F32_FLOPS)
    twin = with_bound(dict(
        common, name="raster_2d_every_face", max_abs_err=errs[1], ms=twin_ms,
        device_ms=twin_dev_ms, tested=every, ms_327680_faces=twin_ms7,
        tested_327680_faces=every7), flops, nbytes, F32_FLOPS)
    return [rec, twin]


def _launched(before):
    """K2/K3 launch counts that moved since ``before``."""
    from st3d_torch.kernels.conv import LAUNCHES

    return {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}


def _conv_operands(gen, dev, cin, cout, h, dtype, batch=VIEWS):
    """x, w (He-scaled), b and a cotangent at ``batch``, h x h."""
    import torch

    x = torch.randn((batch, h, h, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((cout,), generator=gen, device=dev)).to(dtype)
    ct = torch.randn((batch, h, h, cout), generator=gen, device=dev).to(dtype)
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


# The f32 cell (vgg19-768x6-f32.texture): 768², its 6 views in batches of 4
# and 2. K2 runs conv2_1 .. conv5_1 forward and their input gradients
# (conv1_2 goes through C, its gradient through D); (Cin, Cout, H).
F32_CELL_SIZE = 768
F32_CELL_BATCHES = (4, 2)
F32_CELL_K2_CONVS = [(cin, cout, h * F32_CELL_SIZE // SIZE)
                     for cin, cout, h in VGG_K2_CONVS[1:]]


def k2_f32_cell_check(dev):
    """The float32 K2 (3xTF32) at the f32 cell's shapes: each conv of
    ``F32_CELL_K2_CONVS`` at both batches, forward and dx, and C at conv1_2,
    against the plain versions (<= 1e-4 * max|plain|), timed (CUDA events)
    beside its 3xTF32 bound with its tiles (boxes of ``tf32x3_tile``, C's
    of ``pool_tile``), CTAs (min(tiles, SMs)) and waves; the forward also
    beside the plain version and ``F.conv2d`` in float32 with TF32 off (the
    library time). The totals are one epoch's, both batches: the record's
    ``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` are the forward
    calls', ``dx_ms`` and ``dx_bound_ms`` the input gradients', ``c_ms`` and
    ``c_bound_ms`` C's."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels.conv import (
        LAUNCHES, SMS, _transpose_conv, conv3x3_nhwc, conv3x3_nhwc_plain,
        conv3x3_relu_pool, conv3x3_relu_pool_plain, pool_tile, tf32x3_tile)

    def plan(bsz, h, cout, pool=False):
        bw, bh = pool_tile(h) if pool else tf32x3_tile(h, h)
        tiles = (bsz * -(-h // bw) * -(-h // bh)
                 * -(-cout // (64 if cout <= 64 else 128)))
        ctas = min(tiles, SMS)
        return f"tiles {tiles}, CTAs {ctas}, waves {tiles / ctas:.2f}"

    gen = torch.Generator(device=dev).manual_seed(22)
    tot = {"ms": 0.0, "dx": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0,
           "dx_bound": 0.0, "c": 0.0, "c_bound": 0.0, "err": 0.0}
    for bsz in F32_CELL_BATCHES:
        for cin, cout, h in F32_CELL_K2_CONVS:
            x, w, b, ct = _conv_operands(gen, dev, cin, cout, h,
                                         torch.float32, bsz)
            what = f"{cin:>3}->{cout:<3} {h:>3}² x {bsz}"
            err, text = _conv_fwd_dx(x, w, b, ct, True, 1e-4,
                                     "conv3x3_tf32x3", what)
            t_k = cuda_ms(lambda: conv3x3_nhwc(x, w, b, True), 5)
            t_d = cuda_ms(lambda: _transpose_conv(ct, w), 5)
            t_p = cuda_ms(lambda: conv3x3_nhwc_plain(x, w, b, True), 3, 1)
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            t_l = cuda_ms(lambda: F.conv2d(xl, wl, b, padding=1), 5)
            # The forward and the input gradient move the same bytes and
            # make the same products, so one bound holds for each.
            flops = 2 * 9 * cin * cout * h * h * bsz
            nbytes = 4 * (bsz * h * h * (cin + cout) + 9 * cin * cout + cout)
            t_b = bound(3 * flops, nbytes, TF32_FLOPS)[0]
            for k, v in (("ms", t_k), ("dx", t_d), ("plain", t_p),
                         ("lib", t_l), ("bound", t_b), ("dx_bound", t_b)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
            print(f"K2 f32 cell {what} {text}  fwd {t_k:.3f} ms "
                  f"({plan(bsz, h, cout)}), dx {t_d:.3f} ms "
                  f"({plan(bsz, h, cin)}), bound {t_b:.4f} ms each "
                  f"({t_b / t_k:.0%}, {t_b / t_d:.0%} of it), plain "
                  f"{t_p:.3f} ms, F.conv2d {t_l:.3f} ms")
        x, w, b, _ = _conv_operands(gen, dev, 64, 64, F32_CELL_SIZE,
                                    torch.float32, bsz)
        before = dict(LAUNCHES)
        p = conv3x3_relu_pool(x, w, b)[0]
        torch.cuda.synchronize()
        if _launched(before) != {"conv3x3_relu_pool_tf32x3": 1}:
            fail(f"C f32 cell: launched {_launched(before)}")
        p_ref = conv3x3_relu_pool_plain(x, w, b)[0]
        err = float((p - p_ref).abs().max())
        scale = float(p_ref.abs().max())
        if not err <= 1e-4 * scale:
            fail(f"C f32 cell x {bsz}: max err {err} > 1e-4 * {scale}")
        t_c = cuda_ms(lambda: conv3x3_relu_pool(x, w, b), 5)
        flops = 2 * 9 * 64 * 64 * F32_CELL_SIZE ** 2 * bsz
        px = bsz * F32_CELL_SIZE ** 2
        t_b = bound(3 * flops, 4 * px * 64 + 5 * px // 4 * 64
                    + 4 * (9 * 64 * 64 + 64), TF32_FLOPS)[0]
        tot["c"] += t_c
        tot["c_bound"] += t_b
        print(f"C f32 cell 64->64 {F32_CELL_SIZE}² x {bsz} err {err:.3g}/"
              f"{scale:.3g}  {t_c:.3f} ms "
              f"({plan(bsz, F32_CELL_SIZE, 64, True)}), bound {t_b:.4f} ms "
              f"({t_b / t_c:.0%} of it)")
    k2 = tot["ms"] + tot["dx"]
    k2_bound = tot["bound"] + tot["dx_bound"]
    print(f"K2 f32 cell, one epoch (22 calls a batch): fwd {tot['ms']:.3f} ms "
          f"(bound {tot['bound']:.3f}, plain {tot['plain']:.3f}, F.conv2d "
          f"{tot['lib']:.3f}) + dx {tot['dx']:.3f} ms (bound "
          f"{tot['dx_bound']:.3f}) = {k2:.3f} ms, bound {k2_bound:.3f} ms "
          f"({k2_bound / k2:.0%} of it); C {tot['c']:.3f} ms, bound "
          f"{tot['c_bound']:.3f} ms")
    return [{"name": "conv3x3_tf32x3 (f32 cell)", "route": "cuda",
             "source": "st3d_torch/csrc/conv3x3_tf32x3.cu",
             "replaces": "st3d/kernels/conv_pallas.py:128",
             "dtype": "float32", "max_abs_err": tot["err"],
             "ms": tot["ms"], "plain_ms": tot["plain"],
             "library_ms": tot["lib"], "bound_ms": tot["bound"],
             "bound_by": "operations", "dx_ms": tot["dx"],
             "dx_bound_ms": tot["dx_bound"], "c_ms": tot["c"],
             "c_bound_ms": tot["c_bound"]}]


# The bf16 cells at the same 768² and convs: styles3 runs VGG on 12 and 6
# images an epoch (3 styles x 4 and 2 views), bf16.texture on 4 and 2.
BF16_CELL_BATCHES = {"styles3": (12, 6), "texture": (4, 2)}


def k2_bf16_cell_check(dev):
    """The bf16 K2 (``csrc/conv3x3_wgmma.cu``) at the bf16 cells' shapes:
    each conv of ``F32_CELL_K2_CONVS`` at each batch of
    ``BF16_CELL_BATCHES``, forward and dx, and C at conv1_2, against the
    plain versions (<= 1e-2 * max|plain|; C's idx equal wherever the plain
    top two of the window differ by more), timed (CUDA events) beside its
    bf16 bound with its tiles (``k2_plan``'s box and BN; C's ``pool_tile``
    and BN 64), CTAs (min(tiles, SMs)) and waves; the forward also beside
    ``F.conv2d`` in bf16 (the library time). Per cell the totals are one
    epoch's: the record's ``ms``, ``library_ms`` and ``bound_ms`` are the
    forward calls', ``dx_ms`` and ``dx_bound_ms`` the input gradients',
    ``c_ms`` and ``c_bound_ms`` C's."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels.conv import (
        LAUNCHES, SMS, _transpose_conv, conv3x3_nhwc, conv3x3_nhwc_plain,
        conv3x3_relu_pool, conv3x3_relu_pool_plain, k2_plan, pool_tile)

    def plan(bsz, h, cout, pool=False):
        if pool:
            bw, bh = pool_tile(h)
            bn, tiles_m = 64, bsz * -(-h // bw) * -(-h // bh)
            box = f"{bw} x {bh}"
        else:
            bw, bn, pixels, _ = k2_plan(bsz, h, h, cout)
            tiles_m = pixels // 128
            box = f"{bw} x {128 // bw}"
        tiles = tiles_m * -(-cout // bn)
        ctas = min(tiles, SMS)
        return (f"box {box}, BN {bn}, tiles {tiles}, CTAs {ctas}, waves "
                f"{tiles / ctas:.2f}")

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(26)
    bf, size = torch.bfloat16, F32_CELL_SIZE
    recs = []
    for cell, batches in BF16_CELL_BATCHES.items():
        tot = {"ms": 0.0, "dx": 0.0, "lib": 0.0, "bound": 0.0, "c": 0.0,
               "c_bound": 0.0, "err": 0.0}
        for bsz in batches:
            for cin, cout, h in F32_CELL_K2_CONVS:
                x, w, b, ct = _conv_operands(gen, dev, cin, cout, h, bf, bsz)
                what = f"{cin:>3}->{cout:<3} {h:>3}² x {bsz:>2}"
                err, text = _conv_fwd_dx(x, w, b, ct, True, 1e-2,
                                         "conv3x3_wgmma", what)
                t_k = cuda_ms(lambda: conv3x3_nhwc(x, w, b, True), 5)
                t_d = cuda_ms(lambda: _transpose_conv(ct, w), 5)
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                t_l = cuda_ms(lambda: F.conv2d(xl, wl, b, padding=1), 5)
                # The forward and the input gradient move the same bytes and
                # make the same products, so one bound holds for each.
                flops = 2 * 9 * cin * cout * h * h * bsz
                nbytes = 2 * (bsz * h * h * (cin + cout) + 9 * cin * cout
                              + cout)
                t_b = bound(flops, nbytes, BF16_FLOPS)[0]
                for k, v in (("ms", t_k), ("dx", t_d), ("lib", t_l),
                             ("bound", t_b)):
                    tot[k] += v
                tot["err"] = max(tot["err"], err)
                print(f"K2 bf16 {cell} {what} {text}  fwd {t_k:.3f} ms "
                      f"({plan(bsz, h, cout)}), dx {t_d:.3f} ms "
                      f"({plan(bsz, h, cin)}), bound {t_b:.4f} ms each "
                      f"({t_b / t_k:.0%}, {t_b / t_d:.0%} of it), F.conv2d "
                      f"{t_l:.3f} ms")
                del x, w, b, ct
            x, w, b, _ = _conv_operands(gen, dev, 64, 64, size, bf, bsz)
            before = dict(LAUNCHES)
            p, idx = conv3x3_relu_pool(x, w, b)
            torch.cuda.synchronize()
            if _launched(before) != {"conv3x3_relu_pool_wgmma": 1}:
                fail(f"C bf16 {cell}: launched {_launched(before)}")
            p_ref, idx_ref = conv3x3_relu_pool_plain(x, w, b)
            err, scale = _max_err(p, p_ref, 1e-2, f"C bf16 {cell} x {bsz}")
            bad, _ = _idx_mismatches(idx, idx_ref, conv3x3_nhwc_plain(
                x, w, b, True), 1e-2 * scale)
            if bad:
                fail(f"C bf16 {cell} x {bsz}: {bad} idx mismatches where "
                     "separated")
            t_c = cuda_ms(lambda: conv3x3_relu_pool(x, w, b), 5)
            px = bsz * size ** 2
            t_b = bound(2 * 9 * 64 * 64 * px, 2 * px * 64 + 3 * px // 4 * 64
                        + 2 * (9 * 64 * 64 + 64), BF16_FLOPS)[0]
            tot["c"] += t_c
            tot["c_bound"] += t_b
            tot["err"] = max(tot["err"], err)
            print(f"C bf16 {cell} 64->64 {size}² x {bsz} err {err:.3g}/"
                  f"{scale:.3g}  {t_c:.3f} ms ({plan(bsz, size, 64, True)}), "
                  f"bound {t_b:.4f} ms ({t_b / t_c:.0%} of it)")
            del x, w, b, p, idx, p_ref, idx_ref
            torch.cuda.empty_cache()
        k2 = tot["ms"] + tot["dx"]
        k2_bound = 2 * tot["bound"]
        print(f"K2 bf16 {cell}, one epoch (22 calls a batch): fwd "
              f"{tot['ms']:.3f} ms (bound {tot['bound']:.3f}, F.conv2d "
              f"{tot['lib']:.3f}) + dx {tot['dx']:.3f} ms = {k2:.3f} ms, "
              f"bound {k2_bound:.3f} ms ({k2_bound / k2:.0%} of it); C "
              f"{tot['c']:.3f} ms, bound {tot['c_bound']:.3f} ms")
        recs.append({"name": f"conv3x3_wgmma (bf16 {cell} cell)",
                     "route": "cuda",
                     "source": "st3d_torch/csrc/conv3x3_wgmma.cu",
                     "replaces": "st3d/kernels/conv_pallas.py:128",
                     "dtype": "bfloat16", "max_abs_err": tot["err"],
                     "ms": tot["ms"], "library_ms": tot["lib"],
                     "bound_ms": tot["bound"], "bound_by": "operations",
                     "dx_ms": tot["dx"], "dx_bound_ms": tot["bound"],
                     "c_ms": tot["c"], "c_bound_ms": tot["c_bound"]})
    return recs


NNFM_POSITIONS = (F32_CELL_SIZE // 4) ** 2   # the conv3 block at 768²
NNFM_CHANNELS = 768


def nnfm_check(dev):
    """ARF's NNFM kernels (``csrc/nnfm_match_tf32x3.cu``) at the NNFM
    cell's shapes: the certified matching (``match``: the hi x hi filter,
    the float64 re-score and the fallback) and the 3xTF32 matching over
    every pair (``match_full``) of both batches (4 and 2 views of 36,864
    positions against the style's 36,864, 768 channels), each against
    float64 on its first 8,192 rows (the same columns, values within 2e-6),
    timed (CUDA events; the certified one also by kernel under the
    profiler, the filter beside its one-product bound) beside the 3xTF32
    bound and the plain blockwise float32 ``torch.matmul`` + ``argmax``
    with TF32 off, which it must beat, with the pairs re-scored and the
    rows scored in full; the centring, the loss rows and their backward
    against their plain versions. The totals are one epoch's."""
    import torch
    from st3d_torch.kernels import nnfm as kn

    plain_in_float32()
    p, c = NNFM_POSITIONS, NNFM_CHANNELS
    gen = torch.Generator(device=dev).manual_seed(25)

    def block(n):
        return torch.relu(torch.randn((n, p, c), generator=gen, device=dev)
                          + 0.3)

    style = kn.style_operand(kn.center_normalize(block(1)))
    tot = {"ms": 0.0, "full": 0.0, "plain": 0.0, "bound": 0.0, "rows": 0.0,
           "filter": 0.0, "rescore": 0.0, "fallback": 0.0}
    err = 0.0
    for bsz in F32_CELL_BATCHES:
        f = block(bsz)
        before = dict(kn.LAUNCHES)
        fh = kn.center_normalize(f)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        idx, val = kn.match(fh, style, stats)
        torch.cuda.synchronize()
        if {k: v - before[k] for k, v in kn.LAUNCHES.items()
                if v != before[k]} != {"nnfm_normalize": 1,
                                       "nnfm_match_certified": 1}:
            fail(f"NNFM x {bsz}: launched {kn.LAUNCHES} from {before}")
        ref_i, ref_v = kn.match_plain(fh[:8192].double(),
                                      style.hat.double(), 1024)
        full_i, full_v = kn.match_full(fh, style)
        for what, (gi, gv) in (("certified", (idx, val)),
                               ("full", (full_i, full_v))):
            flips = int((gi[:8192].long() != ref_i).sum())
            verr = float((gv[:8192].double() - ref_v).abs().max())
            if flips or not verr < 2e-6:
                fail(f"NNFM match ({what}) x {bsz}: {flips} of 8192 rows "
                     f"off float64's argmax, values {verr:.3g} off")
            err = max(err, verr)
        nerr = float((fh - kn.center_normalize_plain(f)).abs().max())
        t_k = cuda_ms(lambda: kn.match(fh, style), 3, 1)
        _, per = profiled_ms(lambda: kn.match(fh, style), 3)
        t_f = cuda_ms(lambda: kn.match_full(fh, style), 3, 1)
        t_p = cuda_ms(lambda: kn.match_plain(fh, style.hat), 1, 1)
        t_n = cuda_ms(lambda: kn.center_normalize(f), 3, 1)
        m = bsz * p
        flops = 2 * m * p * c
        t_b = bound(3 * flops, 4 * c * (m + 2 * p) + 8 * m, TF32_FLOPS)[0]
        t_b1 = bound(flops, 4 * c * (m + p), TF32_FLOPS)[0]
        part = {k: sum(v for n, v in per.items() if f"nnfm_{k}" in n)
                for k in ("filter", "rescore", "fallback")}
        rows = f.reshape(m, c)
        content = torch.rand((m, c), generator=gen, device=dev)
        leaf = rows.clone().requires_grad_(True)
        nn = idx.long()
        got = kn.loss_rows(leaf, style.hat, content, idx, 0.5 / m,
                           0.005 / (m * c))
        got.sum().backward()
        want_leaf = rows.double().requires_grad_(True)
        want = kn.loss_rows_plain(want_leaf, style.hat.double(),
                                  content.double(), nn, 0.5 / m,
                                  0.005 / (m * c))
        want.sum().backward()
        lerr = float((got.double() - want).abs().max() / want.abs().max())
        gerr = float((leaf.grad.double() - want_leaf.grad).abs().max()
                     / want_leaf.grad.abs().max())
        if not (lerr < 1e-5 and gerr < 1e-5 and nerr < 1e-6):
            fail(f"NNFM rows x {bsz}: loss {lerr:.3g}, grad {gerr:.3g}, "
                 f"normalise {nerr:.3g} off their plain versions")

        def loss_step():
            a = rows.detach().requires_grad_(True)
            kn.loss_rows(a, style.hat, content, idx, 0.5 / m,
                         0.005 / (m * c)).sum().backward()

        t_r = cuda_ms(loss_step, 3, 1)
        for k, v in (("ms", t_k), ("full", t_f), ("plain", t_p),
                     ("bound", t_b), ("rows", t_n + t_r), *part.items()):
            tot[k] += v
        cand, full = (int(v) for v in stats.tolist())
        print(f"NNFM x {bsz} ({m} x {p} x {c}): match {t_k:.3f} ms (filter "
              f"{part['filter']:.3f}, {t_b1 / part['filter']:.1%} of its "
              f"one-product bound {t_b1:.3f}; re-score "
              f"{part['rescore']:.3f}; fallback {part['fallback']:.3f}); "
              f"{cand / m:.2f} pairs re-scored a row, {full} rows in full; "
              f"3xTF32 over every pair {t_f:.3f} ms (bound {t_b:.3f}); "
              f"plain float32 {t_p:.3f} ms; centring {t_n:.3f} ms, loss "
              f"rows fwd + bwd {t_r:.3f} ms; value err {err:.3g}, loss "
              f"{lerr:.3g}, grad {gerr:.3g}")
    if not tot["ms"] < tot["plain"]:
        fail(f"NNFM match {tot['ms']:.3f} ms an epoch, not under the plain "
             f"float32 route's {tot['plain']:.3f}")
    print(f"NNFM, one epoch: match {tot['ms']:.3f} ms (filter "
          f"{tot['filter']:.3f}, re-score {tot['rescore']:.3f}, fallback "
          f"{tot['fallback']:.3f}); 3xTF32 over every pair {tot['full']:.3f} "
          f"(bound {tot['bound']:.3f}); plain float32 {tot['plain']:.3f}; "
          f"centring and loss rows {tot['rows']:.3f} ms")
    return [{"name": "nnfm_match_certified (NNFM cell)", "route": "cuda",
             "source": "st3d_torch/csrc/nnfm_match_tf32x3.cu",
             "replaces": None, "dtype": "float32", "max_abs_err": err,
             "ms": tot["ms"], "plain_ms": tot["plain"], "library_ms": None,
             "bound_ms": tot["bound"] / 3, "bound_by": "operations",
             "full_ms": tot["full"], "rows_ms": tot["rows"]}]


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
    under the profiler) beside ``F.conv2d`` on the same inputs (float32
    with TF32 off).
    The bound is the bytes (x, y and the weights once) over 3.35 TB/s, or
    the products on the tensor cores (float32: three TF32 passes)."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels.conv import conv3x3_nhwc, conv3x3_nhwc_plain

    gen = torch.Generator(device=dev).manual_seed(5)
    recs = []
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
                  f"{t_k:.4f} ms ({dev_k:.4f} device), F.conv2d "
                  f"{t_l:.4f} ms ({t_k / t_l:.2f}x), plain {t_p:.3f} ms, "
                  f"bound {t_b:.4f} ms ({by})")
            part = {"ms": t_k, "device_ms": dev_k, "plain_ms": t_p,
                    "bound_ms": t_b, "bound_by": by, "library_ms": t_l}
            if cin == 3:
                rec.update(part)
            else:
                rec.update({"dx_" + k: v for k, v in part.items()})
        recs.append(rec)
    return recs


def gram_check(dev):
    """K3 at the four style-Gram shapes of the main path: bf16 on the
    tensor-core kernel, float32 on the 3xTF32 one (each bit-identical on a
    second call); then conv1_1's 27-wide PᵀP (``narrow_gram_check``). Times
    of the four Grams: bf16 against ``torch.bmm`` in bf16 (its output rounded
    to bf16, where K3 keeps float32), float32 against ``torch.bmm`` in
    float32 with TF32 off."""
    import torch
    from st3d_torch.kernels.conv import LAUNCHES, gram_nhwc, gram_nhwc_plain

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = {torch.bfloat16: "gram_wgmma", torch.float32: "gram_tf32x3"}
    # (passes over the products, rate) of each kernel's bound.
    rates = {"gram_wgmma": (1, BF16_FLOPS), "gram_tf32x3": (3, TF32_FLOPS)}
    tot = {k: {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0,
               "bound": 0.0} for k in rates}
    shapes = [(h * h, c, dtype) for h, c in GRAM_SHAPES for dtype in keys]

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
        if key in tot:
            tot[key]["err"] = max(tot[key]["err"],
                                  float((g_k - g_p).abs().max()))
        return g_k, text

    for pixels, c, dtype in shapes:
        tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
        key = keys[dtype]
        y = torch.relu(torch.randn((VIEWS, pixels, c), generator=gen,
                                   device=dev)).to(dtype)
        g_p = gram_nhwc_plain(y)
        line = held(key, gram_nhwc, y, g_p, tol)[1]
        flops = 2 * VIEWS * pixels * c * c
        nbytes = y.element_size() * VIEWS * pixels * c + 4 * VIEWS * c * c
        t_p = cuda_ms(lambda: gram_nhwc_plain(y))
        t_l = cuda_ms(lambda: torch.bmm(y.transpose(1, 2), y))
        print(line)
        t_k = cuda_ms(lambda: gram_nhwc(y))
        passes, rate = rates[key]
        t_b = bound(passes * flops, nbytes, rate)[0]
        for f, v in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                     ("bound", t_b)):
            tot[key][f] += v
        print(f"K3 {key} ({VIEWS},{pixels},{c}) {str(dtype)[6:]}  kernel "
              f"{t_k:.3f} ms ({flops / t_k / 1e9:.1f} TFLOP/s) plain "
              f"{t_p:.3f} ms bmm {t_l:.3f} ms bound {t_b:.4f} ms")
    recs = []
    for key, dtype in (("gram_wgmma", "bfloat16"), ("gram_tf32x3", "float32")):
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
        recs.append(rec)
    return recs + narrow_gram_check(dev, gen, held)


def narrow_gram_check(dev, gen, held):
    """conv1_1's 27-wide PᵀP at 4 x 512² x 27 in both dtypes on the narrow
    tensor-core kernel ``gram_narrow``, held by ``held`` (one launch, a
    second call bit-identical) against the plain version: bf16 within 1e-3;
    float32 within 1e-5 of a float64 Gram, and of the plain version within
    1e-5 plus the plain float32 sum's own distance from float64 (a sum over
    2^18 pixels). It is timed beside one ``torch.bmm`` in the same dtype.
    The bound is the byte bound: at ~27 operations a byte the tensor
    cores' time (bf16, or three TF32 passes) is far below it."""
    import torch
    from st3d_torch.kernels.conv import gram_nhwc, gram_nhwc_plain

    c, pixels = 27, SIZE * SIZE
    rates = {torch.bfloat16: (1, BF16_FLOPS), torch.float32: (3, TF32_FLOPS)}
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        y = torch.relu(torch.randn((VIEWS, pixels, c), generator=gen,
                                   device=dev)).to(dtype)
        g_p = gram_nhwc_plain(y)
        g64 = torch.matmul(y.double().transpose(1, 2), y.double())

        def rel(g):
            return float(torch.linalg.norm(g.double() - g64)
                         / torch.linalg.norm(g64))

        tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
        slack = 0.0 if dtype == torch.bfloat16 else rel(g_p)
        g_k, line = held("gram_narrow", gram_nhwc, y, g_p, tol + slack)
        e64 = {"kernel": rel(g_k), "plain": rel(g_p)}
        if dtype == torch.float32 and e64["kernel"] > tol:
            fail(f"K3 gram_narrow f32 27-wide: rel fro err {e64['kernel']} "
                 f"from float64 > {tol}")
        t_k = cuda_ms(lambda: gram_nhwc(y))
        d_k, d_split = profiled_ms(lambda: gram_nhwc(y))
        t_p = cuda_ms(lambda: gram_nhwc_plain(y))
        t_l = cuda_ms(lambda: torch.bmm(y.transpose(1, 2), y))
        flops = 2 * VIEWS * pixels * c * c
        nbytes = y.element_size() * VIEWS * pixels * c + 4 * VIEWS * c * c
        passes, rate = rates[dtype]
        rec = with_bound({
            "name": "gram_narrow", "route": "cuda",
            "source": "st3d_torch/csrc/gram_narrow.cu",
            "replaces": "st3d/kernels/conv_pallas.py:548", "dtype": name,
            "shape": [VIEWS, pixels, c],
            "max_abs_err": float((g_k - g_p).abs().max()), "ms": t_k,
            "plain_ms": t_p, "device_ms": d_k,
            "device_ms_by_kernel": d_split,
            "rel_fro_err_float64": e64["kernel"],
            "plain_rel_fro_err_float64": e64["plain"]},
            passes * flops, nbytes, rate, t_l)
        print(line)
        print(f"K3 gram_narrow ({VIEWS},{pixels},{c}) {name}: rel fro err "
              f"from float64: kernel {e64['kernel']:.3g}, plain "
              f"{e64['plain']:.3g}; kernel {t_k:.4f} ms ({d_k:.4f} device: "
              + ", ".join(f"{'second pass' if 'reduce' in n else 'pass 1'} "
                          f"{v:.4f}" for n, v in d_split.items())
              + f"), plain {t_p:.3f} ms, bmm {t_l:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
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
    """Prints the tensor-core C's time beside, on the same inputs, K2's
    forward (conv + bias + ReLU, no pool) and a three-call composition of
    torch ops (``F.max_pool2d(F.relu(
    F.conv2d(...)), 2, return_indices=True)``: not one library call of the
    same function, its index counts in the whole plane); returns them."""
    import torch
    import torch.nn.functional as F
    from st3d_torch.kernels import conv as kconv

    k2 = cuda_ms(lambda: kconv.conv3x3_nhwc(x, w, b, True), 5)
    xl = x.permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    comp = cuda_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xl, wl, b, padding=1)),
                                        2, return_indices=True), 5)
    torch.cuda.synchronize()
    print(f"C {what}: {key} {c_ms:.3f} ms, K2's forward at the same shape "
          f"{k2:.3f} ms, the composition max_pool2d(relu(conv2d)) "
          f"{comp:.3f} ms")
    return {"k2_fwd_ms": k2, "composition_ms": comp}


def d_versus(ct, pooled, idx, w, d_ms, key, what):
    """Prints the tensor-core D's time beside K2's dx (the transpose conv
    alone, on the routed cotangent at full resolution) at the same shape;
    returns it."""
    import torch
    from st3d_torch.kernels import conv as kconv

    routed = kconv.route_pool_cotangent(ct, pooled, idx)
    dx = cuda_ms(lambda: kconv._transpose_conv(routed, w), 5)
    torch.cuda.synchronize()
    print(f"D {what}: {key} {d_ms:.3f} ms, K2's dx at the same shape "
          f"{dx:.3f} ms")
    return {"k2_dx_ms": dx}


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


def profiled_ms(fn, reps=10, attempts=3):
    """Device time of one call of ``fn``: the time of its CUDA kernels
    under ``torch.profiler`` over ``reps`` calls after a warm-up, so the
    host's issue is left out. Returns (ms, {kernel: ms per call}). A
    profile that holds no device event at all, not even PyTorch's own
    kernels, is taken again (printed), up to ``attempts`` profiles: one
    such profile, of a call whose kernels had run, was seen on an H100 in
    one of two runs of the same script."""
    import torch
    from st3d_torch.profile_step import kernel_ms

    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = kernel_ms(prof.events(), reps)
        if per:
            return sum(per.values()), per
        print(f"torch.profiler saw no device time in profile {attempt} of "
              f"{attempts}")
    fail(f"torch.profiler saw no device time in {attempts} profiles")


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


def ab_versus(x, w1, b1, res):
    """Prints A's and B's times (events, profiler, bound); in bf16 beside
    F.conv2d 3 -> 64 + bias, the nearest library call to A's z half (no
    statistics, no ReLU)."""
    import torch.nn.functional as F

    name = str(x.dtype)[6:]
    a, b = A_KEYS[name], B_KEYS[name]
    if name == "bfloat16":
        xl = x.permute(0, 3, 1, 2)
        wl = w1.permute(3, 2, 0, 1).contiguous()
        res[a]["conv2d_z_half_ms"] = cuda_ms(
            lambda: F.conv2d(xl, wl, b1, padding=1), 5)
    work = stage1_work()
    for key, what in ((a, "A"), (b, "B")):
        r = res[key]
        print(f"{what} {name}: {key} {r['ms']:.3f} ms (device "
              f"{r['device_ms']:.4f}, bound {bound(*work[key])[0]:.4f})"
              + (f", F.conv2d bf16 3 -> 64 {r['conv2d_z_half_ms']:.3f} ms"
                 if "conv2d_z_half_ms" in r else ""))


def stage1_work():
    """(operations, bytes, rate) of each stage-1 kernel at 4 x 512²: A
    conv1_1 (27 -> 64) plus the 27 x 27 patch statistics; B the same two
    products backwards; C and D conv1_2 (64 -> 64, 9 taps) forward and
    input gradient. bf16 at the bf16 tensor rate; float32 the three TF32
    products of the 3xTF32 A, B, C and D at the TF32 rate, moving twice
    the bytes."""
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
        "conv3x3_relu_pool_wgmma": (conv12, 2 * px * 64 + 3 * (px // 4) * 64,
                                    BF16_FLOPS),
        "pool_route_wgmma": (conv12, 5 * (px // 4) * 64 + 2 * px * 64,
                             BF16_FLOPS),
        "conv3x3_relu_pool_tf32x3": (3 * conv12,
                                     4 * px * 64 + 5 * (px // 4) * 64,
                                     TF32_FLOPS),
        "pool_route_tf32x3": (3 * conv12, 9 * (px // 4) * 64 + 4 * px * 64,
                              TF32_FLOPS),
    }


def stage1_check(dev):
    """Kernels A-D at the stage-1 shapes of the main path (4 x 512² x 3 ->
    64 -> 64, pool to 256²), each against its plain version, each call on
    its route's kernel: A, B, C and D on the tensor cores in bf16 and by
    3xTF32 in float32. A's statistics
    bit-identical on a second call. A and B timed on both dtypes by CUDA
    events and by the profiler's kernel time."""
    import torch
    from st3d_torch.kernels import conv as kconv
    from st3d_torch.kernels import stage1 as ks1

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (VIEWS, SIZE, SIZE)
    names = KERNELS[3:] + (A_KEYS["float32"], B_KEYS["float32"],
                           C_KEYS["float32"], D_KEYS["float32"])
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
            # Timed on each dtype's route; A and B also by the profiler's
            # kernel time, since an event loop over a call this short times
            # its issue.
            r["ms"] = cuda_ms(calls[n][0], 5)
            r["plain_ms"] = cuda_ms(calls[n][1], 3, 1)
            line += (f"  kernel {r['ms']:.3f} ms plain "
                     f"{r['plain_ms']:.3f} ms")
            if n in (a_key, b_key):
                r["device_ms"], per = profiled_ms(calls[n][0])
                line += f" device {r['device_ms']:.4f} ms " + json.dumps(
                    {k[:48]: round(v, 4) for k, v in per.items()})
            print(line)
        ab_versus(x, w1, b1, res)
        what = f"conv1_2 4 x 512² x 64 -> 64 {name}"
        res[d_key].update(d_versus(ct, pooled_p, idx_p, w2, res[d_key]["ms"],
                                   d_key, what))
        res[c_key].update(c_versus(z_p, w2, b2, res[c_key]["ms"], c_key,
                                   what))
    meta = {
        "conv1_1_stats_wgmma": ("st3d_torch/csrc/conv1_1_stats_wgmma.cu",
                                "st3d/kernels/stage1_pallas.py:446"),
        "conv1_1_bwd_wgmma": ("st3d_torch/csrc/conv1_1_bwd_wgmma.cu",
                              "st3d/kernels/stage1_pallas.py:583"),
        "conv1_1_stats_tf32x3": ("st3d_torch/csrc/conv1_1_stats_tf32x3.cu",
                                 "st3d/kernels/stage1_pallas.py:446"),
        "conv1_1_bwd_tf32x3": ("st3d_torch/csrc/conv1_1_bwd_tf32x3.cu",
                               "st3d/kernels/stage1_pallas.py:583"),
        "conv3x3_relu_pool_wgmma": ("st3d_torch/csrc/conv3x3_wgmma.cu",
                                    "st3d/kernels/stage1_pallas.py:485, "
                                    "st3d/kernels/conv_pallas.py:760"),
        "conv3x3_relu_pool_tf32x3": ("st3d_torch/csrc/conv3x3_tf32x3.cu",
                                     "st3d/kernels/stage1_pallas.py:485, "
                                     "st3d/kernels/conv_pallas.py:760"),
        "pool_route_wgmma": ("st3d_torch/csrc/pool_route_wgmma.cu",
                             "st3d/kernels/stage1_pallas.py:539, "
                             "st3d/kernels/conv_pallas.py:785"),
        "pool_route_tf32x3": ("st3d_torch/csrc/pool_route_tf32x3.cu",
                              "st3d/kernels/stage1_pallas.py:539, "
                              "st3d/kernels/conv_pallas.py:785"),
    }
    work = stage1_work()
    f32 = (A_KEYS["float32"], B_KEYS["float32"], C_KEYS["float32"],
           D_KEYS["float32"])
    return [with_bound({"name": n, "route": "cuda", "source": meta[n][0],
                        "replaces": meta[n][1],
                        "dtype": "float32" if n in f32 else "bfloat16",
                        **res[n]}, *work[n]) for n in names]


def _v3_launched(before):
    """E/F launch counts that moved since ``before``."""
    from st3d_torch.kernels.stage1v3 import LAUNCHES

    return {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}


def _g64_err(g64, g_p, yr, what):
    """g64 against the plain version: relative Frobenius <= 1e-4; also
    printed against a float64 Gram of the plain version's y_r, which
    shows whether the kernel or the plain float32 sum (2¹⁸ terms an entry)
    is the further off."""
    import torch

    yr = yr.double().reshape(g64.shape[0], -1, 64)
    exact = yr.transpose(1, 2) @ yr
    rel = float(torch.linalg.norm(g64 - g_p) / torch.linalg.norm(g_p))
    rel64 = float(torch.linalg.norm(g64.double() - exact)
                  / torch.linalg.norm(exact))
    plain64 = float(torch.linalg.norm(g_p.double() - exact)
                    / torch.linalg.norm(exact))
    print(f"{what} g64 rel fro err {rel:.3g} (against float64: kernel "
          f"{rel64:.3g}, plain {plain64:.3g})")
    if rel > 1e-4:
        fail(f"{what} g64: rel fro err {rel} > 1e-4")
    return rel


def stage1v3_work():
    """(operations, bytes, rate) of E and F at 4 x 512², the function's
    work whatever the kernel recomputes: E conv1_1 (27 -> 64) and the 64 x
    64 Gram, reading x, writing z and g64; F the recompute of y, y_r·S and
    the transpose conv (64 -> 27), reading x, dz and S, writing dx. bf16
    at the bf16 tensor rate; float32 with four-byte values, where y_r = y
    and d is not rounded, so F's y·S and d·Wᵀ fold into (dz·mask)·Wᵀ + y·M
    with M = S·Wᵀ (64 x 27): the 3xTF32 kernels' three TF32 products of
    each 27-wide product and two of E's Gram (HH + LH + LHᵀ) at the TF32
    rate."""
    px = VIEWS * SIZE * SIZE
    e_ops, f_ops = 2 * px * 64 * (27 + 64), 2 * px * 64 * (27 + 64 + 27)
    f_fold = 2 * px * 64 * (27 + 27 + 27)
    e_tf32 = 3 * 2 * px * 64 * 27 + 2 * 2 * px * 64 * 64
    grams = 4 * VIEWS * 64 * 64
    e_px, f_px = px * (3 + 64), px * (3 + 64 + 3)
    return {
        V3_KEYS["bfloat16"][0]: (e_ops, 2 * e_px + grams, BF16_FLOPS),
        V3_KEYS["bfloat16"][1]: (f_ops, 2 * f_px + grams, BF16_FLOPS),
        V3_KEYS["float32"][0]: (e_tf32, 4 * e_px + grams, TF32_FLOPS),
        V3_KEYS["float32"][1]: (3 * f_fold, 4 * f_px + grams, TF32_FLOPS),
    }


def _mask_flips(z, y, what):
    """Pixels (values) where the kernel's forward mask z > 0 and the plain
    float32 y's y > 0 differ; each must lie within 1e-5 max|y| of 0 (the
    two y differ by float32 rounding). Printed; returns (count, the largest
    |y| among them over max|y|)."""
    flips = (z > 0) != (y > 0)
    n = int(flips.sum())
    worst = (float(y[flips].abs().max() / y.abs().max()) if n else 0.0)
    print(f"{what}: {n} mask flips between E's z > 0 and the plain y > 0, "
          f"the largest at |y| = {worst:.3g} max|y|")
    if worst > 1e-5:
        fail(f"{what}: a mask flip at |y| = {worst} max|y| > 1e-5")
    return n, worst


def stage1v3_check(dev):
    """Kernels E and F at the stage-1 shapes of the main path (4 x 512² x 3
    -> 64), each call on its route's tensor-core kernel and against its
    plain version: bf16 on ``wgmma`` (``conv1_1_gram_wgmma``,
    ``conv1_1_gram_bwd_wgmma``), float32 by 3xTF32 (``conv1_1_gram_tf32x3``,
    ``conv1_1_gram_bwd_tf32x3``); g64 bit-identical on a second call. The
    float32 F is held against the plain F masked by E's own z > 0: it
    recomputes y by E's instructions, and a y within float32 rounding of 0
    may fall on the other side of the plain version's matmul; those pixels
    are counted, and each must have |y| <= 1e-5 max|y|. Each timed by CUDA
    events and by the profiler's kernel time, beside its bound."""
    import torch
    from st3d_torch.kernels import stage1v3 as ks3
    from st3d_torch.kernels.stage1 import patches27

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(4)
    shape = (VIEWS, SIZE, SIZE)
    names = V3_KEYS["bfloat16"] + V3_KEYS["float32"]
    res = {n: {"max_abs_err": 0.0} for n in names}
    work = stage1v3_work()
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        name = str(dtype)[6:]
        e_key, f_key = V3_KEYS[name]
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

        before = dict(ks3.LAUNCHES)
        z, g64 = ks3.conv1_1_gram(x, w, b)
        torch.cuda.synchronize()
        if _v3_launched(before) != {e_key: 1}:
            fail(f"E {name}: launched {_v3_launched(before)}, want {e_key}")
        z_p, g_p = ks3.conv1_1_gram_plain(x, w, b)
        y = patches27(x) @ w.reshape(27, 64).float() + b.float()
        yr = y.to(dtype)
        errs = {e_key: _max_err(z, z_p, tol, f"E z {name}")}
        res[e_key]["g64_rel_fro_err"] = _g64_err(g64, g_p, yr,
                                                 f"E {e_key} {name}")
        if not torch.equal(ks3.conv1_1_gram(x, w, b)[1], g64):
            fail(f"E {e_key} {name}: g64 differs on a second call")
        before = dict(ks3.LAUNCHES)
        dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
        torch.cuda.synchronize()
        if _v3_launched(before) != {f_key: 1}:
            fail(f"F {name}: launched {_v3_launched(before)}, want {f_key}")
        dx_p = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
        if dtype == torch.float32:
            n, worst = _mask_flips(z, y, f"F {f_key} {name}")
            res[f_key].update(mask_flips=n, mask_flip_max_y_share=worst)
            own = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym, mask=z > 0)
            errs[f_key] = _max_err(dx, own, tol,
                                   f"F dx {name} (plain F, E's mask)")
            res[f_key]["max_abs_err_plain_mask"] = float(
                (dx - dx_p).abs().max())
            print(f"F {f_key} {name}: max err against the plain F with "
                  f"E's mask {errs[f_key][0]:.3g}, with its own mask "
                  f"{res[f_key]['max_abs_err_plain_mask']:.3g} (scale "
                  f"{errs[f_key][1]:.3g})")
        else:
            errs[f_key] = _max_err(dx, dx_p, tol, f"F dx {name}")
        moves = {}
        for what, other in (("sym = 0", torch.zeros_like(sym)),
                            ("S of the next image", sym.roll(1, 0))):
            moved = float((ks3.conv1_1_gram_bwd_plain(x, dz, w, b, other)
                           .float() - dx_p.float()).abs().max())
            moves[what] = moved / (tol * errs[f_key][1])
            if not moved > 10 * tol * errs[f_key][1]:
                fail(f"F dx {name}: {what} moves the plain dx by only "
                     f"{moved}, so the check cannot hold the Gram fold")
        print(f"F {f_key} {name}: the plain dx moves by "
              + ", ".join(f"{v:.1f} tolerances at {k}"
                          for k, v in moves.items()))
        calls = {
            e_key: (lambda: ks3.conv1_1_gram(x, w, b),
                    lambda: ks3.conv1_1_gram_plain(x, w, b)),
            f_key: (lambda: ks3.conv1_1_gram_bwd(x, dz, w, b, sym),
                    lambda: ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)),
        }
        for n, (err, scale) in errs.items():
            r = res[n]
            r["max_abs_err"] = err
            r["ms"] = cuda_ms(calls[n][0], 5)
            r["plain_ms"] = cuda_ms(calls[n][1], 3, 1)
            r["device_ms"], per = profiled_ms(calls[n][0])
            print(f"{n} {name} max err {err:.3g}/{scale:.3g}  kernel "
                  f"{r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms device "
                  f"{r['device_ms']:.4f} ms " + json.dumps(
                      {k[:48]: round(v, 4) for k, v in per.items()}))
        for n in calls:
            r = res[n]
            print(f"{n} {name}: {r['ms']:.3f} ms (device "
                  f"{r['device_ms']:.4f}, bound {bound(*work[n])[0]:.4f})")
    f32 = V3_KEYS["float32"]
    return [with_bound({"name": n, "route": "cuda",
                        "source": f"st3d_torch/csrc/{n}.cu",
                        "replaces": ("st3d/kernels/stage1v3_pallas.py:366"
                                     if "bwd" in n else
                                     "st3d/kernels/stage1v3_pallas.py:256"),
                        "dtype": "float32" if n in f32 else "bfloat16",
                        **res[n]}, *work[n]) for n in names]


def k8_check(dev):
    """Kernels C and D at K8's shapes (conv2_2, conv3_4, conv4_4 at 512²),
    each against its plain version, bf16 and f32 (both on the tensor cores,
    by 3xTF32 in f32); times summed over the three convs, each beside K2
    at the same shape."""
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
              f"({other[0]} {other[1]:.3f} ms"
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
    """Launch counts on the opt-in routes: the bf16 E and F get theirs from
    the bf16 v3 run (the float32 ones theirs from the float32 v3 run, in
    ``main``); K10c/K10d (C and D at stage 1's shapes, as
    measured there) and K8 (C and D at its own shapes) are added as entries
    of their own."""
    by_name = {k["name"]: k for k in kernels}
    for n in V3_KEYS["bfloat16"]:
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
    if route in STAGE1_OFF and launches["gram_narrow"] != epochs:
        fail(f"route {route}: gram_narrow (conv1_1's PᵀP) launched "
             f"{launches['gram_narrow']} times, want one a step ({epochs})")
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
    route: K2 (forward and dx), K3, C and D on 3xTF32 (``drive`` fails on
    any launch outside ``F32_KERNELS``); C once and K3 four times a step.
    The targets' set-up adds two C launches (VGG on the content and the
    style images) and five Grams (the style image's five taps, conv1_1's
    64-wide one included)."""
    launches = second_approach_path(tmp, obj, style, "default", F32_EPOCHS,
                                    "float32", want=F32_KERNELS)
    want = {C_KEYS["float32"]: F32_EPOCHS + 2,
            "gram_tf32x3": 4 * F32_EPOCHS + 5}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"f32 texture: launched {got}, want {want} ({F32_EPOCHS} "
             f"steps)")
    return launches


def f32_v3_texture_path(tmp, obj, style, a_setups):
    """The texture step in float32 on the v3 route (``ST3D_STAGE1=v3``): E
    and F by 3xTF32 in place of A and B, the rest as on the float32 default
    route (``drive`` fails on any launch outside ``F32_V3_KERNELS``); F once
    a step, E once a step plus the set-up launches A takes on the default
    route (``a_setups``: the content and style targets)."""
    launches = second_approach_path(tmp, obj, style, "v3", F32_EPOCHS,
                                    "float32", want=F32_V3_KERNELS)
    e, f = V3_KEYS["float32"]
    want = {e: F32_EPOCHS + a_setups, f: F32_EPOCHS}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"f32 v3 texture: launched {got}, want {want} ({F32_EPOCHS} "
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


def vertex_path(tmp, scenes, mode, card, kernel=None, tag="", also=()):
    """A vertex-optimisation run of the second approach in one raster mode
    (``VERTEX_RUNS``): finite falling losses, moved vertices, and the mode's
    raster kernel (``kernel`` where a twin stands in for it) once per step
    (plus the content and final renders, and the hard-K saturation
    checks); ``also``: kernels this run may launch besides the route's.
    Its outputs go to ``<target>_<mode><tag>``. Returns the launches and
    the losses."""
    from st3d_torch.second_approach import main as second_approach

    target, extra, level, kernel_of_mode = VERTEX_RUNS[mode]
    obj, style = scenes[level]
    out = os.path.join(tmp, f"{target}_{mode}{tag}")
    kernel = kernel or kernel_of_mode
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
                         "--output_path", out] + extra), raster=kernel,
                     want=(set(ROUTES["default"][1]) | set(also)) if also
                     else None)
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
    return launches, losses


def hard_twin_runs(tmp, scenes, card):
    """The hard vertex run four times more: with each K1 call also run
    through its every-face twin on the same faces (p2f and zbuf compared
    bit for bit, every call); then, with PyTorch's deterministic
    algorithms asked for (``warn_only``: the ops that have none warn, and
    are printed), with K1, with the twin in K1's place and with K1 again.
    Every call must agree. The twin's losses must equal K1's wherever the
    repeated K1 run shows that the run repeats bit for bit on this card;
    where it does not, the losses say nothing about K1, and the per-call
    check is the one that holds it."""
    import warnings

    import torch
    from st3d_torch.kernels import raster as kr

    real = kr.raster_hard
    calls = []

    def held(coeffs, bounds, h, w, tested=None, row0=0):
        got = real(coeffs, bounds, h, w, tested, row0)
        twin = kr.raster_hard_every_face(coeffs, bounds, h, w)
        calls.append(row0 == 0 and torch.equal(got[0], twin[0])
                     and torch.equal(got[1], twin[1]))
        return got

    def twin(coeffs, bounds, h, w, tested=None, row0=0):
        if row0:
            fail("K1's twin takes no row offset")
        return kr.raster_hard_every_face(coeffs, bounds, h, w)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            kr.raster_hard = held
            vertex_path(tmp, scenes, "hard", card, tag="_held",
                        also={"raster_hard_every_face"})
            kr.raster_hard = real
            torch.use_deterministic_algorithms(True, warn_only=True)
            _, losses = vertex_path(tmp, scenes, "hard", card, tag="_det")
            kr.raster_hard = twin
            _, twin_losses = vertex_path(tmp, scenes, "hard", card,
                                         kernel="raster_hard_every_face",
                                         tag="_twin")
            kr.raster_hard = real
            _, again = vertex_path(tmp, scenes, "hard", card, tag="_again")
        finally:
            kr.raster_hard = real
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    repeats = again == losses
    same = twin_losses == losses
    print(f"both target hard, K1 against its every-face twin on each of "
          f"the run's {len(calls)} raster calls: p2f and zbuf bit-equal "
          f"{all(calls)}; with deterministic algorithms asked for, losses "
          f"with the twin in K1's place bit-equal to K1's {same}, K1's run "
          f"repeated bit-equal {repeats}; ops without a deterministic "
          f"version: {nondet}")
    if len(calls) != BOTH_EPOCHS + 2 or not all(calls):
        fail(f"K1 and its twin differ on the hard run's faces: {calls}")
    if repeats and not same:
        fail(f"the hard run's losses differ with K1's twin: {losses} "
             f"against {twin_losses}")
    return {"calls_bit_equal": sum(calls), "losses_bit_equal": same,
            "run_repeats_bit_for_bit": repeats,
            "nondeterministic_ops": nondet}


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
                before_v3 = dict(launch_counts()[3])
                fn(common + extra + ["--compute_dtype", dtype, "--device",
                                     device, "--output_path", out])
                runs[device] = read_log(out)
                if device == "cuda":
                    ran = {k for k, n in launch_counts()[1].items()
                           if n > before[k]}
                    k2 = ran & {"conv3x3_wgmma", "conv3x3_tf32x3"}
                    c = ran & set(C_KEYS.values())
                    d = ran & set(D_KEYS.values())
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
                    ef = {k for k, n in launch_counts()[3].items()
                          if n > before_v3[k]}
                    want_ef = set(V3_KEYS[dtype]) if route == "v3" else set()
                    if ef != want_ef:
                        fail(f"64² {entry}: E and F ran on {ef}, want "
                             f"{want_ef}")
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


# ---------------------------------------------------------------------------
# Checkpoints, --debug_nan, --profile, pad_mesh, multi-style and the fleet
# ---------------------------------------------------------------------------

MS_STYLES = 3                    # multi-style: a VGG batch of 12
MS_EPOCHS = 10
FLEET_LEVELS = (ICO_LEVEL, 3)    # textured 5,120 faces; UV-less 1,280
FLEET_STYLES = 2                 # 2 meshes x 2 styles: 16 images a step
CELL_F32_EPOCHS = 5
CELL_TOL = 2e-4                  # tests/test_fleetbatch.py: batched vs sequential
RESUME_EPOCHS = (3, 6)
PAD = (37, 301, 11)              # extra vertices, faces, UVs
# The texture step's VGG launches on the default route in bf16, per step.
STEP_LAUNCHES = {"conv3x3_wgmma": 22, "gram_wgmma": 4,
                 "conv1_1_stats_wgmma": 1, "conv1_1_bwd_wgmma": 1,
                 "conv3x3_relu_pool_wgmma": 1, "pool_route_wgmma": 1}


# The bf16 VGG batches of the new paths: the sequential fleet's per-mesh
# multi-style run (2 styles x 4 views), the multi-style run (3 x 4) and the
# batched fleet (2 meshes x 2 styles x 4).
CELL_BATCHES = (FLEET_STYLES * VIEWS, MS_STYLES * VIEWS,
                len(FLEET_LEVELS) * FLEET_STYLES * VIEWS)
# bf16 runs of a batched path against the runs of one cell each: each
# cell's first and last loss within 1e-2 relative (the bf16 kernel
# tolerance), and its texture's distance from the single run's within
# 5e-2 of how far the single run moved it.
BF16_LOSS_RTOL = 1e-2
BF16_MOVE_TOL = 5e-2


def cell_batch_check(dev):
    """The bf16 VGG kernels of the step at the VGG batches of the new paths
    (``CELL_BATCHES``, images of 512²), each wrapper on the card against
    its plain version at the batch-4 checks' tolerances (``conv_check``,
    ``gram_check``, ``stage1_check``), one launch of its key per call: K2's
    forward and dx at every VGG conv, K3 at the four style-Gram shapes, A's
    z and statistics, B's dx, C's pooled output and indices, D's dz.
    Returns {key: {batch: max abs err}}."""
    import torch
    from st3d_torch.kernels import conv as kconv
    from st3d_torch.kernels import stage1 as ks1

    plain_in_float32()
    gen = torch.Generator(device=dev).manual_seed(3)
    bf, tol = torch.bfloat16, 1e-2
    errs = {k: {} for k in KERNELS[1:]}

    def once(counts, fn, key, what):
        before = dict(counts)
        out = fn()
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in counts.items()
                 if n != before[k]}
        if moved != {key: 1}:
            fail(f"{what}: launched {moved}, want {{{key}: 1}}")
        return out

    def keep(key, n, err):
        errs[key][str(n)] = max(errs[key].get(str(n), 0.0), err)

    for n in CELL_BATCHES:
        for cin, cout, h in VGG_K2_CONVS:
            x, w, b, ct = _conv_operands(gen, dev, cin, cout, h, bf, n)
            what = f"{cin}->{cout} {h}² bfloat16 batch {n}"
            keep("conv3x3_wgmma", n, _conv_fwd_dx(
                x, w, b, ct, cin == cout and h != 32, tol, "conv3x3_wgmma",
                what)[0])
        for h, c in GRAM_SHAPES:
            y = torch.relu(torch.randn((n, h * h, c), generator=gen,
                                       device=dev)).to(bf)
            g_k = once(kconv.LAUNCHES, lambda: kconv.gram_nhwc(y),
                       "gram_wgmma", f"K3 ({n},{h * h},{c})")
            g_p = kconv.gram_nhwc_plain(y)
            rel = float(torch.linalg.norm(g_k - g_p) / torch.linalg.norm(g_p))
            if rel > 1e-3:
                fail(f"K3 gram_wgmma ({n},{h * h},{c}): rel fro err {rel} > "
                     "1e-3")
            keep("gram_wgmma", n, float((g_k - g_p).abs().max()))
        shape = (n, SIZE, SIZE)
        x = torch.rand(shape + (3,), generator=gen, device=dev).to(bf)
        w1 = (torch.randn((3, 3, 3, 64), generator=gen, device=dev)
              * (2.0 / 27) ** 0.5).to(bf)
        b1 = (0.1 * torch.randn((64,), generator=gen, device=dev)).to(bf)
        w2 = (torch.randn((3, 3, 64, 64), generator=gen, device=dev)
              * (2.0 / 576) ** 0.5).to(bf)
        b2 = (0.1 * torch.randn((64,), generator=gen, device=dev)).to(bf)
        dz = torch.randn(shape + (64,), generator=gen, device=dev).to(bf)
        dg = 0.1 * torch.randn((n, 27, 27), generator=gen, device=dev)
        sym = dg + dg.transpose(1, 2)
        ds = torch.randn((n, 27), generator=gen, device=dev)
        ct = torch.randn((n, SIZE // 2, SIZE // 2, 64), generator=gen,
                         device=dev).to(bf)
        a, b_, c_, d = (A_KEYS["bfloat16"], B_KEYS["bfloat16"],
                        C_KEYS["bfloat16"], D_KEYS["bfloat16"])
        z, ptp, s27 = once(ks1.LAUNCHES,
                           lambda: ks1.conv1_1_stats(x, w1, b1), a,
                           f"A batch {n}")
        z_p, ptp_p, s27_p = ks1.conv1_1_stats_plain(x, w1, b1)
        keep(a, n, _max_err(z, z_p, tol, f"A z batch {n}")[0])
        _stats_err(ptp, s27, ptp_p, s27_p, f"A {a} batch {n}", x)
        dx = once(ks1.LAUNCHES,
                  lambda: ks1.conv1_1_bwd(x, dz, z_p, w1, sym, ds), b_,
                  f"B batch {n}")
        keep(b_, n, _max_err(dx, ks1.conv1_1_bwd_plain(
            x, dz, z_p, w1, sym, ds), tol, f"B dx batch {n}")[0])
        pooled, idx = once(kconv.LAUNCHES,
                           lambda: kconv.conv3x3_relu_pool(z_p, w2, b2), c_,
                           f"C batch {n}")
        pooled_p, idx_p = kconv.conv3x3_relu_pool_plain(z_p, w2, b2)
        err, scale = _max_err(pooled, pooled_p, tol, f"C pooled batch {n}")
        keep(c_, n, err)
        bad, _ = _idx_mismatches(idx, idx_p, kconv.conv3x3_nhwc_plain(
            z_p, w2, b2, True), tol * scale)
        if bad:
            fail(f"C idx batch {n}: {bad} mismatches where separated")
        dz2 = once(kconv.LAUNCHES, lambda: kconv.pool_route_conv3x3_bwd(
            ct, pooled_p, idx_p, w2), d, f"D batch {n}")
        keep(d, n, _max_err(dz2, kconv.pool_route_conv3x3_bwd_plain(
            ct, pooled_p, idx_p, w2), tol, f"D dz batch {n}")[0])
        del x, z, z_p, dz, dx, dz2, pooled, pooled_p, idx, idx_p, ct
        torch.cuda.empty_cache()
        print(f"bf16 VGG kernels at batch {n} x {SIZE}², each within its "
              "tolerance of its plain version, one launch a call; max abs "
              "err " + json.dumps({k: v[str(n)] for k, v in errs.items()}))
    return errs


def moved_gap(a, b, init):
    """||a - b|| / ||b - init|| of two textures: the distance between two
    runs' textures as a share of how far the reference run ``b`` moved its
    texture from ``init``."""
    import torch

    a, b, init = (t.detach().float().cpu() for t in (a, b, init))
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b - init))


def bf16_cells_agree(what, cells, refs):
    """Each cell's (first, last) bf16 loss and moved-texture gap against
    its reference run's: ``cells`` {cell: ((first, last), texture)},
    ``refs`` {cell: ((first, last), texture, initial texture)}. Prints and
    holds them to ``BF16_LOSS_RTOL`` and ``BF16_MOVE_TOL``; returns the
    worst of each."""
    worst = {"loss_rel": 0.0, "moved_gap": 0.0}
    for cell, (losses, tex) in cells.items():
        ref_losses, ref_tex, init = refs[cell]
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses, ref_losses))
        gap = moved_gap(tex, ref_tex, init)
        print(f"{what} bf16 cell {cell}: first, last loss {losses} against "
              f"{ref_losses} (worst rel {rel:.3g}), texture gap {gap:.3g} "
              "of the reference run's move")
        if not (rel <= BF16_LOSS_RTOL and gap <= BF16_MOVE_TOL):
            fail(f"{what} bf16 cell {cell}: loss rel {rel} (tolerance "
                 f"{BF16_LOSS_RTOL}) or texture gap {gap} (tolerance "
                 f"{BF16_MOVE_TOL}) from its reference run")
        worst = {"loss_rel": max(worst["loss_rel"], rel),
                 "moved_gap": max(worst["moved_gap"], gap)}
    return worst


def style_pngs(root, n):
    """``style.png`` (``write_scene``'s) and n - 1 more seeded styles."""
    import numpy as np
    from st3d_torch.io.image import write_png

    paths = [os.path.join(root, "style.png")]
    for k in range(1, n):
        paths.append(os.path.join(root, f"style_{k}.png"))
        write_png(paths[-1], (np.random.RandomState(10 + k).rand(
            SIZE, SIZE, 3) * 255).astype(np.uint8))
    return paths


def bare_sphere(root, level):
    """A UV-less ico-sphere OBJ (no MTL, no texture): auto-UV'd on load."""
    from st3d_torch.io.obj import save_obj

    mesh = sphere(level)
    path = os.path.join(root, f"bare{level}", "bare.obj")
    save_obj(path, verts=mesh.verts.numpy(), faces=mesh.faces.numpy())
    return path


def cell_argv(epochs, dtype, out, *extra):
    return ["--size", str(SIZE), "--n_views", str(VIEWS), "--batch_size",
            str(VIEWS), "--compute_dtype", dtype, "--epochs", str(epochs),
            "--randomize_views", "False", "--device", "cuda",
            "--output_path", out] + list(extra)


def with_peak(run):
    """(run's result, peak device memory in MiB over the run)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2 ** 20


def cells_fell(out, key, epochs, what):
    """Each cell's loss (``metrics.jsonl`` ``key``) over the epochs: finite,
    the last below the first."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(l)[key] for l in f]
    if len(rows) != epochs:
        fail(f"{what}: {len(rows)} epochs logged, want {epochs}")
    for cell in rows[0]:
        vals = [r[cell] for r in rows]
        if not all(map(math.isfinite, vals)) or not vals[-1] < vals[0]:
            fail(f"{what}: cell {cell} losses {vals}")
    return {c: (rows[0][c], rows[-1][c]) for c in rows[0]}


def max_texture_gap(a, b):
    return max(float((a[k].texture - b[k].texture).abs().max()) for k in a)


def multistyle_phase(tmp, obj, styles, texture):
    """The multi-style engine, S = 3 (a VGG batch of 12): bf16, 10 epochs,
    each style's loss falling and the step's VGG launches those of the
    single-style texture step (``STEP_LAUNCHES``, with the same set-up
    launches), K1 only for the visibility, the content render and the
    final renders, and each style's losses and texture held against a bf16
    single-style ``second_approach`` run of it (``bf16_cells_agree``);
    then float32, 5 epochs, each style's texture within 2e-4
    of a single-style ``second_approach`` run of it."""
    from st3d_torch.engine.config import parse_second_approach
    from st3d_torch.engine.pipelines import load_scene
    from st3d_torch.multi_style import main as multi_style
    from st3d_torch.second_approach import main as second_approach

    spec = ",".join(styles)
    out = os.path.join(tmp, "multistyle_bf16")
    (got, launches), peak = with_peak(lambda: drive_result(
        "multi-style", "default", lambda: multi_style(cell_argv(
            MS_EPOCHS, "bfloat16", out, "--obj_path", obj, "--style_paths",
            spec))))
    falls = cells_fell(out, "per_style", MS_EPOCHS, "multi-style bf16")
    for k, per in STEP_LAUNCHES.items():
        setup = texture[k] - EPOCHS * per
        if setup < 0 or launches[k] != setup + MS_EPOCHS * per:
            fail(f"multi-style: {k} launched {launches[k]}, want "
                 f"{setup} + {MS_EPOCHS} x {per} (the texture step's)")
    if launches["raster_hard"] != 2 + len(styles):
        fail(f"multi-style: K1 launched {launches['raster_hard']} times, "
             f"want {2 + len(styles)} (visibility, content, final renders)")
    step_ms, n = median_step_ms(out, MS_EPOCHS)
    rec = {"bf16_step_ms": step_ms, "bf16_peak_mib": peak,
           "losses": falls}
    print(f"multi-style {len(styles)} styles x {VIEWS} views {SIZE}² bf16: "
          f"median step {step_ms:.2f} ms over the last {n}, peak "
          f"{peak:.0f} MiB, per-style loss first -> last "
          + json.dumps(falls) + ", launches " + json.dumps(launches))
    init = load_scene(parse_second_approach(cell_argv(
        1, "bfloat16", out, "--obj_path", obj))).texture
    refs = {}
    for path, name in zip(styles, got):
        one = os.path.join(tmp, f"single_bf16_{name}")
        mesh = second_approach(cell_argv(
            MS_EPOCHS, "bfloat16", one, "--obj_path", obj, "--style_path",
            path, "--save_intermediate", "False"))
        losses = read_log(one)
        refs[name] = ((losses[0], losses[-1]), mesh.texture, init)
    rec["bf16_vs_single"] = bf16_cells_agree(
        "multi-style", {k: (falls[k], got[k].texture) for k in got}, refs)
    # The runs the parallel phase holds its multi-style runs against.
    cells = {"ms_bf16": (out, {k: m.texture for k, m in got.items()},
                         {k: init for k in got})}

    out = os.path.join(tmp, "multistyle_f32")
    f32 = {}
    (got, f32["launches"]), peak = with_peak(lambda: drive_result(
        "multi-style f32", "default", lambda: multi_style(cell_argv(
            CELL_F32_EPOCHS, "float32", out, "--obj_path", obj,
            "--style_paths", spec)), want=F32_KERNELS))
    single = {}
    for path, name in zip(styles, got):
        single[name] = second_approach(cell_argv(
            CELL_F32_EPOCHS, "float32", os.path.join(tmp, f"single_{name}"),
            "--obj_path", obj, "--style_path", path, "--save_intermediate",
            "False"))
    gap = max_texture_gap(got, single)
    step_ms, n = median_step_ms(out, CELL_F32_EPOCHS)
    rec.update(f32_step_ms=step_ms, f32_peak_mib=peak, f32_gap=gap)
    print(f"multi-style f32, {CELL_F32_EPOCHS} epochs: median step "
          f"{step_ms:.2f} ms over the last {n}, peak {peak:.0f} MiB; max "
          f"|texture - its single-style run| {gap:.3g} (tolerance "
          f"{CELL_TOL})")
    if not gap <= CELL_TOL:
        fail(f"multi-style f32 textures {gap} from the single-style runs")
    cells["ms_f32"] = (out, {k: m.texture for k, m in got.items()}, None)
    return launches, f32["launches"], rec, cells


def drive_result(path, route, run, raster="raster_hard", want=None):
    """``drive``, keeping ``run()``'s result: (result, launches)."""
    box = []
    launches = drive(path, route, lambda: box.append(run()), raster, want)
    return box[0], launches


def fleet_phase(tmp, scenes, styles, dev):
    """The batched fleet, the textured level-4 sphere and a UV-less level-3
    one (1,280 faces padded to 5,120, auto-UV) x 2 styles (16 images a
    step): bf16, 10 epochs, every cell's loss falling, the visibility one
    K1 launch over 8 views (then K1 once per mesh for the content renders
    and once per cell for the final renders), each mesh's p2f (ids below
    its face count) and zbuf of ``fleet_visibility`` bit-equal to the
    mesh's own unpadded launch, and each cell's losses and texture held
    against a bf16 ``--fleet_mode sequential`` run (``bf16_cells_agree``);
    then float32, 5 epochs, every cell within
    2e-4 of ``--fleet_mode sequential``, and every
    ``<mesh>/<style>/final.obj`` written by both."""
    import torch
    from st3d_torch.core.uv import pad_mesh
    from st3d_torch.engine.config import parse_second_approach
    from st3d_torch.engine.fleetbatch import (_load_fleet_meshes,
                                              fleet_visibility)
    from st3d_torch.engine.pipelines import build_cameras
    from st3d_torch.fleet import main as fleet
    from st3d_torch.kernels import raster as kr
    from st3d_torch.render.rasterize import (RasterizationSettings,
                                             face_verts_screen,
                                             rasterize_batch)

    objs = [scenes[FLEET_LEVELS[0]][0], bare_sphere(tmp, FLEET_LEVELS[1])]
    spec = ["--obj_paths", ",".join(objs), "--style_paths",
            ",".join(styles)]
    m, s = len(objs), len(styles)
    out = os.path.join(tmp, "fleet_bf16")
    calls, real = [], kr.raster_hard

    def counted(coeffs, *a, **kw):
        calls.append(coeffs.shape[0])
        return real(coeffs, *a, **kw)

    kr.raster_hard = counted
    try:
        (got, launches), peak = with_peak(lambda: drive_result(
            "fleet", "default", lambda: fleet(cell_argv(
                MS_EPOCHS, "bfloat16", out, *spec))))
    finally:
        kr.raster_hard = real
    falls = cells_fell(out, "per_cell", MS_EPOCHS, "fleet bf16")
    want = [m * VIEWS] + [VIEWS] * m + [12] * (m * s)
    if calls != want or launches["raster_hard"] != len(want):
        fail(f"fleet: K1 calls covered {calls} views, want {want}")
    step_ms, n = median_step_ms(out, MS_EPOCHS)
    rec = {"bf16_step_ms": step_ms, "bf16_peak_mib": peak, "losses": falls}
    print(f"fleet {m} meshes x {s} styles x {VIEWS} views {SIZE}² bf16: "
          f"median step {step_ms:.2f} ms over the last {n}, peak "
          f"{peak:.0f} MiB, K1 calls over {calls} views, per-cell loss "
          "first -> last " + json.dumps(falls) + ", launches "
          + json.dumps(launches))

    cfg = parse_second_approach(cell_argv(1, "bfloat16", out))
    meshes = [x.to(dev) for x in _load_fleet_meshes(cfg, objs)]
    seq_out = os.path.join(tmp, "fleet_seq_bf16")
    seq = fleet(cell_argv(MS_EPOCHS, "bfloat16", seq_out, *spec,
                          "--fleet_mode", "sequential"))
    cells, refs = {}, {}
    for mesh, init in zip(got, meshes):
        seq_falls = cells_fell(os.path.join(seq_out, mesh), "per_style",
                               MS_EPOCHS, f"fleet sequential bf16 {mesh}")
        for style in got[mesh]:
            cell = f"{mesh}/{style}"
            cells[cell] = (falls[cell], got[mesh][style].texture)
            refs[cell] = (seq_falls[style], seq[mesh][style].texture,
                          init.texture)
    rec["bf16_vs_sequential"] = bf16_cells_agree("fleet", cells, refs)
    # The runs the parallel phase holds its fleet runs against.
    par_cells = {"fl_bf16": (out, {k: t for k, (_, t) in cells.items()},
                             {k: r[2] for k, r in refs.items()})}
    padded = [pad_mesh(x, max(y.verts.shape[0] for y in meshes),
                       max(y.faces.shape[0] for y in meshes),
                       num_uvs=max(y.verts_uvs.shape[0] for y in meshes))
              for x in meshes]
    cams = build_cameras(cfg)[0:VIEWS].to(dev)
    settings = RasterizationSettings(image_size=SIZE)
    n0 = kr.LAUNCHES["raster_hard"]
    vis = fleet_visibility(meshes, padded, cams, settings)
    torch.cuda.synchronize()
    if kr.LAUNCHES["raster_hard"] != n0 + 1:
        fail("fleet_visibility took more than one K1 launch")
    for g, x in enumerate(meshes):
        own = rasterize_batch(face_verts_screen(x.verts, x.faces, cams,
                                                SIZE), settings)
        if not (torch.equal(vis["p2f"][g], own.pix_to_face)
                and torch.equal(vis["zbuf"][g], own.zbuf)
                and int(vis["p2f"][g].max()) < x.faces.shape[0]):
            fail(f"fleet visibility of mesh {g} differs from its own launch")
    print(f"fleet visibility: one K1 launch over {m * VIEWS} views "
          f"({[x.faces.shape[0] for x in meshes]} faces padded to "
          f"{padded[0].faces.shape[0]}); each mesh's p2f and zbuf bit-equal "
          "to its own unpadded launch")

    out = os.path.join(tmp, "fleet_f32")
    (got, f32), peak = with_peak(lambda: drive_result(
        "fleet f32", "default", lambda: fleet(cell_argv(
            CELL_F32_EPOCHS, "float32", out, *spec)), want=F32_KERNELS))
    seq_out = os.path.join(tmp, "fleet_seq_f32")
    seq = fleet(cell_argv(CELL_F32_EPOCHS, "float32", seq_out, *spec,
                          "--fleet_mode", "sequential"))
    gap = max(max_texture_gap(got[k], seq[k]) for k in got)
    for root in (out, seq_out):
        for mesh in got:
            for style in got[mesh]:
                if not os.path.isfile(os.path.join(root, mesh, style,
                                                   "final.obj")):
                    fail(f"{root}/{mesh}/{style}/final.obj missing")
    step_ms, n = median_step_ms(out, CELL_F32_EPOCHS)
    rec.update(f32_step_ms=step_ms, f32_peak_mib=peak, f32_gap=gap)
    print(f"fleet f32, {CELL_F32_EPOCHS} epochs: median step {step_ms:.2f} "
          f"ms over the last {n}, peak {peak:.0f} MiB; max |batched - "
          f"sequential texture| {gap:.3g} (tolerance {CELL_TOL}); every "
          "<mesh>/<style>/final.obj written")
    if not gap <= CELL_TOL:
        fail(f"fleet f32: batched textures {gap} from sequential")
    par_cells["fl_f32"] = (out, {f"{mesh}/{style}": got[mesh][style].texture
                                 for mesh in got for style in got[mesh]},
                           None)
    return launches, f32, rec, objs, par_cells


def padding_check(dev):
    """The level-4 sphere padded by +301 faces, +37 vertices and +11 UVs
    through K1, K1-soft, K6 (forced, hard and soft) and K7 (K = 4, 3 px):
    every output bit-equal to the unpadded faces'."""
    import torch
    from st3d_torch.core.cameras import (build_fixed_cameras,
                                         transform_points_screen)
    from st3d_torch.core.uv import pad_mesh
    from st3d_torch.kernels import raster as kr

    mesh = sphere(ICO_LEVEL).to(dev)
    padded = pad_mesh(mesh, mesh.verts.shape[0] + PAD[0],
                      mesh.faces.shape[0] + PAD[1],
                      num_uvs=mesh.verts_uvs.shape[0] + PAD[2])
    scr = transform_points_screen(build_fixed_cameras(VIEWS, seed=0).to(dev),
                                  mesh.verts, (SIZE, SIZE))
    faces = {"unpadded": scr[:, mesh.faces], "padded": scr[:, padded.faces]}
    runs = {
        "raster_hard": lambda f: kr.rasterize_batched(f, SIZE, stream=False),
        "raster_soft": lambda f: kr.rasterize_batched_soft(f, SIZE,
                                                           stream=False),
        "raster_stream hard": lambda f: kr.rasterize_batched(f, SIZE,
                                                             stream=True),
        "raster_stream soft": lambda f: kr.rasterize_batched_soft(
            f, SIZE, stream=True),
        "raster_topk": lambda f: (kr.rasterize_topk_batched(f, SIZE, 4,
                                                            3.0),)}
    for name, run in runs.items():
        key = name.split()[0]
        n0 = kr.LAUNCHES[key]
        a, b = (run(faces[k]) for k in ("unpadded", "padded"))
        torch.cuda.synchronize()
        if kr.LAUNCHES[key] != n0 + 2:
            fail(f"padding: {name} did not launch its kernel")
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"padding: {name} outputs differ on padded faces")
    print(f"padding (+{PAD[1]} faces, +{PAD[0]} vertices, +{PAD[2]} UVs on "
          f"{mesh.faces.shape[0]} faces, {SIZE}² x {VIEWS}): K1, K1-soft, K6 "
          "hard and soft, K7 (K=4, 3 px) bit-equal to the unpadded faces")


def resume_check(tmp, obj, style):
    """Checkpoint and resume on the bf16 texture target, with PyTorch's
    deterministic algorithms asked for (``warn_only``: the ops that have
    none are printed): 3 epochs with ``--checkpoint_every 3``, resumed to
    6, and 6 uninterrupted epochs twice; before that, for ROADMAP H2, 6
    epochs twice without the flag, printing whether they repeat. The resumed log starts at epoch 3.
    Where the two uninterrupted runs repeat bit for bit, the resumed run's
    epochs 3-5 and final texture equal them bit for bit; where they do not
    (ROADMAP H2), within rtol 1e-3."""
    import warnings

    import torch
    from st3d_torch.second_approach import main as second_approach

    cut, end = RESUME_EPOCHS

    def run(name, epochs, *extra):
        out = os.path.join(tmp, f"resume_{name}")
        final = second_approach(second_approach_argv(
            obj, style, epochs, "bfloat16", out) + list(extra))
        return out, final

    free = [run(k, end) for k in ("free_a", "free_b")]
    free_repeats = (read_log(free[0][0]) == read_log(free[1][0])
                    and torch.equal(free[0][1].texture, free[1][1].texture))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out, _ = run("cut", cut, "--checkpoint_every", str(cut))
            _, resumed = run("cut", end, "--checkpoint_every", str(cut),
                             "--resume", "True")
            a_out, a = run("a", end)
            b_out, b = run("b", end)
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    with open(os.path.join(out, "log.txt")) as f:
        first = f.read().splitlines()[1]
    if not first.startswith(f"Epoch {cut},"):
        fail(f"resumed log starts {first!r}")
    got, la, lb = read_log(out), read_log(a_out), read_log(b_out)
    repeats = la == lb and torch.equal(a.texture, b.texture)
    bit_equal = got == la[cut:] and torch.equal(resumed.texture, a.texture)
    rel = max(abs(x - y) / abs(y) for x, y in zip(got, la[cut:]))
    print(f"resume bf16 texture {SIZE}² x {VIEWS}: without deterministic "
          f"algorithms two runs repeat bit for bit {free_repeats}; {cut} "
          f"epochs, resumed to {end}; uninterrupted runs repeat bit for bit "
          f"{repeats}; resumed "
          f"epochs {cut}-{end - 1} and texture bit-equal {bit_equal}, max "
          f"rel loss diff {rel:.3g}; ops without a deterministic version: "
          f"{nondet}")
    if len(got) != end - cut or (repeats and not bit_equal) or rel > 1e-3:
        fail(f"resumed losses {got} against {la[cut:]}")
    return {"runs_repeat_without_the_flag": free_repeats,
            "runs_repeat": repeats, "resumed_bit_equal": bit_equal,
            "max_rel": rel, "nondeterministic_ops": nondet}


def first_resume_check(tmp, obj, style):
    """The first approach (bf16 texture, 3 style-transfer and 6 MSE steps,
    ``--checkpoint_every 4``) under deterministic algorithms: once whole
    with ``--profile`` (its trace must name K2's kernel), once cut right
    after the mid-batch checkpoint at step 4 and resumed with
    ``--debug_nan``: the resumed log starts at step 4, and its steps and
    final texture equal the whole run's bit for bit where the two runs'
    shared steps 0-3 do, else within rtol 1e-3."""
    import warnings

    import torch
    from st3d_torch.engine import pipelines
    from st3d_torch.first_approach import main as first_approach

    def run(name, *extra):
        out = os.path.join(tmp, f"first_resume_{name}")
        final = first_approach([
            "--obj_path", obj, "--style_path", style, "--size", str(SIZE),
            "--n_views", str(VIEWS), "--batch_size", str(VIEWS),
            "--compute_dtype", "bfloat16", "--n_style_transfer_steps", "3",
            "--n_mse_steps", "6", "--checkpoint_every", "4",
            "--randomize_views", "False", "--device", "cuda",
            "--output_path", out] + list(extra))
        return out, final

    real = pipelines.save_checkpoint

    class Cut(Exception):
        """The run stopped right after its mid-batch checkpoint."""

    def cut_mid_batch(path, step, *a, extras=None, **kw):
        real(path, step, *a, extras=extras, **kw)
        if extras is not None:
            raise Cut

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            whole_out, whole = run("whole", "--profile", "True")
            pipelines.save_checkpoint = cut_mid_batch
            try:
                run("cut")
                fail("the cut first-approach run did not stop")
            except Cut:
                pass
            finally:
                pipelines.save_checkpoint = real
            cut_log = read_log(os.path.join(tmp, "first_resume_cut"))
            out, resumed = run("cut", "--resume", "True", "--debug_nan",
                               "True")
        finally:
            torch.use_deterministic_algorithms(False)
    kernels, _ = trace_kernels(whole_out)
    if not any("conv3x3_wgmma" in k for k in kernels):
        fail("first approach --profile: no conv3x3_wgmma kernel in the trace")
    with open(os.path.join(out, "log.txt")) as f:
        first = f.read().splitlines()[1]
    whole_log, got = read_log(whole_out), read_log(out)
    repeats = cut_log == whole_log[:4]
    bit_equal = (got == whole_log[4:]
                 and torch.equal(resumed.texture, whole.texture))
    rel = max(abs(x - y) / abs(y) for x, y in zip(got, whole_log[4:]))
    print(f"first approach resume bf16 {SIZE}² x {VIEWS}: cut after the "
          f"mid-batch checkpoint at step 4 of 6, resumed with --debug_nan "
          f"(no alarm): steps 0-3 repeat bit for bit {repeats}; steps 4-5 "
          f"and texture bit-equal {bit_equal}, max rel loss diff {rel:.3g}; "
          f"--profile trace names {len(kernels)} kernels, conv3x3_wgmma "
          "among them")
    if (not first.startswith("Batch 0, Step 4,") or len(got) != 2
            or (repeats and not bit_equal) or rel > 1e-3):
        fail(f"first approach resume: log {first!r}, losses {got} against "
             f"{whole_log[4:]}")
    return {"runs_repeat": repeats, "resumed_bit_equal": bit_equal,
            "max_rel": rel}


def trace_kernels(out):
    """The card's kernels named in ``out/profile/trace.json``, and the
    device ms of each kernel over the traced loop (``device_ms.json``)."""
    with open(os.path.join(out, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(out, "profile", "device_ms.json")) as f:
        device = json.load(f)
    return {e["name"] for e in events if e.get("cat") == "kernel"}, device


def debug_profile_phase(tmp, obj, styles, objs):
    """``--debug_nan`` on the bf16 texture run finishes with no false
    alarm and the unguarded run's losses; ``--profile`` on the multi-style
    and fleet runs (bf16 and float32, 5 epochs) writes a trace naming the
    hand-written kernels (``conv3x3_wgmma``/``conv3x3_tf32x3``,
    ``gram_wgmma``/``gram_tf32x3``), and its device ms per step."""
    from st3d_torch.fleet import main as fleet
    from st3d_torch.multi_style import main as multi_style
    from st3d_torch.second_approach import main as second_approach

    outs = [os.path.join(tmp, f"debug_{k}") for k in ("on", "off")]
    for out, flag in zip(outs, ("True", "False")):
        second_approach(second_approach_argv(obj, styles[0], 5, "bfloat16",
                                             out) + ["--debug_nan", flag])
    guarded, plain = (read_log(out) for out in outs)
    print(f"--debug_nan bf16 texture, 5 epochs: no alarm, losses {guarded} "
          f"(unguarded {plain})")
    if len(guarded) != 5 or not all(map(math.isfinite, guarded)):
        fail(f"--debug_nan run losses {guarded}")
    device = {}
    for what, run, flags in (
            ("multistyle", multi_style, ["--obj_path", obj, "--style_paths",
                                         ",".join(styles)]),
            ("fleet", fleet, ["--obj_paths", ",".join(objs),
                              "--style_paths",
                              ",".join(styles[:FLEET_STYLES])])):
        for dtype, names in (("bfloat16", ("conv3x3_wgmma", "gram_wgmma")),
                             ("float32", ("conv3x3_tf32x3", "gram_tf32x3"))):
            out = os.path.join(tmp, f"profile_{what}_{dtype}")
            run(cell_argv(CELL_F32_EPOCHS, dtype, out, "--profile", "True",
                          *flags))
            kernels, ms = trace_kernels(out)
            missing = [n for n in names
                       if not any(n in k for k in kernels)]
            if missing:
                fail(f"--profile {what} {dtype}: no {missing} kernel in the "
                     f"trace ({len(kernels)} kernel names)")
            device[f"{what} {dtype}"] = sum(ms.values()) / CELL_F32_EPOCHS
            top = sorted(ms.items(), key=lambda kv: -kv[1])[:6]
            print(f"--profile {what} {dtype}: trace of {len(kernels)} kernel "
                  f"names, {names} among them; device "
                  f"{device[f'{what} {dtype}']:.2f} ms a step; largest "
                  "(ms a step): " + "; ".join(
                      f"{n[:60]} {t / CELL_F32_EPOCHS:.3f}" for n, t in top))
    return device


# ---------------------------------------------------------------------------
# Data and tile parallelism (st3d_torch/parallel) on one card
# ---------------------------------------------------------------------------

PAR_TIMEOUT = 300                # seconds a world of ranks may take
TILE_SIZE = 1024
TILE_EPOCHS = 2
BAND_ROWS = (256, 128)           # K1's and K6's row bands at 512²
PAR_LOSS_RTOL = {"bfloat16": 1e-2, "float32": 2e-4}
FA_PAR_RTOL = 1e-3               # small_parity's float32 tolerance


def nccl_check():
    """A 1-rank NCCL group on cuda:0, the only NCCL group one card allows:
    ``all_reduce`` SUM, ``broadcast`` and a row ``all_gather`` give the
    expected tensors."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            store, "nccl"), rank=0, world_size=1)
        try:
            x = torch.arange(12, dtype=torch.float32, device=dev).reshape(3, 4)
            y = x.clone()
            dist.all_reduce(y, op=dist.ReduceOp.SUM)
            b = x.clone()
            dist.broadcast(b, 0)
            parts = [torch.empty_like(x[:1])]
            dist.all_gather(parts, x[1:2].contiguous())
            torch.cuda.synchronize()
            ok = (torch.equal(y, x) and torch.equal(b, x)
                  and torch.equal(parts[0], x[1:2]))
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    print(f"parallel: a 1-rank {backend} group on cuda:0: all_reduce, "
          f"broadcast and all_gather as expected {ok}")
    if not ok:
        fail("NCCL's collectives on one rank gave other tensors")


def band_check(dev):
    """K1 on row bands, as the tiled render calls it (``row0``, the band's
    first image row; the planes are the whole frame's): at 512² x 4 on the
    level-4 sphere, every band of h = 256 and h = 128 rows against its
    plain version on the same inputs (ids equal, zbuf within rtol 1e-6)
    and against those rows of K1's whole frame (bit-equal); K6 forced at
    327,680 faces on the same bands against K1 on them and those rows of
    its own whole frame (bit-equal), and at 81,920 faces x 256² on bands of
    128 and 64 rows against its plain version. Returns the largest zbuf
    error against the plain versions."""
    import torch
    from st3d_torch.kernels import raster as kr

    def held(got, want, what):
        bad = int((got[0] != want[0]).sum())
        hit = want[0] >= 0
        zrel = (float(((got[1] - want[1]).abs() / want[1].abs())[hit].max())
                if bool(hit.any()) else 0.0)
        if bad or zrel > 1e-6:
            fail(f"{what}: {bad} ids differ, zbuf rel err {zrel}")
        return float((got[1] - want[1]).abs().max()), float(
            hit.float().mean())

    def same(got, whole, r0, rows, size, what):
        lo, hi = r0 * size, (r0 + rows) * size
        if not (torch.equal(got[0], whole[0][:, lo:hi])
                and torch.equal(got[1], whole[1][:, lo:hi])):
            fail(f"{what} differs from those rows of the whole frame")

    err, lines = 0.0, []
    _, coeffs, bounds = sphere_faces(dev, ICO_LEVEL, SIZE)
    _, c7, b7 = sphere_faces(dev, STREAM_LEVEL, SIZE)
    whole = kr.raster_hard(coeffs, bounds, SIZE, SIZE)
    tile = kr.cull_tile(SIZE, SIZE, False)
    whole7 = kr.raster_stream(c7, b7, kr.stream_ranges(b7, SIZE, SIZE, tile,
                                                       0.0), SIZE, SIZE,
                              tile, False)
    for rows in BAND_ROWS:
        for r0 in range(0, SIZE, rows):
            what = f"K1 on rows {r0}-{r0 + rows}"
            got = kr.raster_hard(coeffs, bounds, rows, SIZE, row0=r0)
            want = kr.raster_hard_plain(coeffs, bounds, rows, SIZE, r0)
            torch.cuda.synchronize()
            e, cov = held(got, want, what)
            same(got, whole, r0, rows, SIZE, what)
            err = max(err, e)
            lines.append(f"{r0}+{rows} cov {cov:.3f}")
            what = f"K6 on rows {r0}-{r0 + rows} at 327,680 faces"
            tile = kr.cull_tile(rows, SIZE, False)
            ranges = kr.stream_ranges(b7, rows, SIZE, tile, 0.0, r0)
            k6 = kr.raster_stream(c7, b7, ranges, rows, SIZE, tile, False,
                                  row0=r0)
            k1 = kr.raster_hard(c7, b7, rows, SIZE, row0=r0)
            torch.cuda.synchronize()
            if not (torch.equal(k6[0], k1[0]) and torch.equal(k6[1], k1[1])):
                fail(f"{what} differs from K1 on them")
            same(k6, whole7, r0, rows, SIZE, what)
    size = 256
    _, c6, b6 = sphere_faces(dev, 6, size)
    for rows in (128, 64):
        for r0 in range(0, size, rows):
            tile = kr.cull_tile(rows, size, False)
            ranges = kr.stream_ranges(b6, rows, size, tile, 0.0, r0)
            got = kr.raster_stream(c6, b6, ranges, rows, size, tile, False,
                                   row0=r0)
            want = kr.raster_stream_plain(c6, ranges, rows, size, tile,
                                          False, r0)
            torch.cuda.synchronize()
            err = max(err, held(got, want, f"K6 on rows {r0}-{r0 + rows} "
                                "at 81,920 faces")[0])
    print(f"parallel: K1 on every band of {BAND_ROWS} rows at {SIZE}² x "
          f"{VIEWS} (row0 the band's first row) held to its plain version "
          f"(ids equal, zbuf rtol 1e-6) and bit-equal to those rows of its "
          f"whole frame; K6 forced on the same bands at 327,680 faces "
          f"bit-equal to K1 on them and to its whole frame's rows; K6 on "
          f"bands of 128 and 64 rows at 81,920 faces x 256² held to its "
          f"plain version; max zbuf abs err {err:.3g}; coverage "
          + ", ".join(lines))
    return err


def shift_flips(dev):
    """The JAX package's band form (subtract r0 from the projected y and
    rasterize an H/2-row image) against the port's (the whole frame's
    planes, K1 told the band's first row) on the final render's 12 fixed
    views at ``TILE_SIZE``² over 2 bands, the level-4 sphere: the pixels
    whose face differs, and the faces they flip between. Printed, not
    held: the port's form is the one the smoke holds to the whole frame."""
    import torch
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.kernels import raster as kr
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = sphere(ICO_LEVEL).to(dev)
    cams = build_fixed_cameras(12, seed=0).to(dev)
    fv = face_verts_screen(mesh.verts, mesh.faces, cams, TILE_SIZE)
    rows = TILE_SIZE // 2
    flips, pairs = 0, set()
    for r0 in (0, rows):
        ours = kr.rasterize_batched(fv, TILE_SIZE, rows, row0=r0)[0]
        shifted = fv - fv.new_tensor([0.0, float(r0), 0.0])
        jax_form = kr.rasterize_batched(shifted, TILE_SIZE, rows)[0]
        diff = ours != jax_form
        flips += int(diff.sum())
        pairs |= set(zip(ours[diff].tolist(), jax_form[diff].tolist()))
    print(f"parallel: the y -= r0 band form at {TILE_SIZE}² x 12 views, 2 "
          f"bands: {flips} pixels take another face than the whole frame's "
          f"(face pairs, whole frame's first: {sorted(pairs)[:12]})")
    return {"pixels": flips, "face_pairs": sorted(pairs)[:12]}


def world_run(tmp, name, n, jobs):
    """Run ``jobs`` in a world of ``n`` ranks sharing cuda:0, each rank a
    process of this script (``--rank``) meeting the others through a file
    store; returns each rank's results and rank 0's output. Every process
    is waited for, and killed past ``PAR_TIMEOUT``."""
    root = os.path.join(tmp, name)
    os.makedirs(root, exist_ok=True)
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({"store": os.path.join(root, "store"), "jobs": jobs}, f)
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   CUBLAS_WORKSPACE_CONFIG=":4096:8")
        logs.append(open(os.path.join(root, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", spec],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + PAR_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    texts = []
    for r in range(n):
        with open(os.path.join(root, f"rank{r}.log")) as f:
            texts.append(f.read())
    if any(p.returncode != 0 for p in procs):
        for r, text in enumerate(texts):
            print(f"--- {name} rank {r} (exit {procs[r].returncode}) ---\n"
                  + text[-3000:])
        fail(f"world {name} of {n} ranks failed")
    results = []
    for r in range(n):
        with open(os.path.join(root, f"result{r}.json")) as f:
            results.append(json.load(f))
    return results, texts[0]


def _texture_digests(result):
    """sha256 of every texture a CLI returned (a mesh, or a dict of them,
    nested per mesh in the fleet), and the textures as float32 arrays."""
    import hashlib

    flat = {}
    if isinstance(result, dict):
        for k, v in result.items():
            for s, m in (v.items() if isinstance(v, dict) else [(None, v)]):
                flat[k if s is None else f"{k}/{s}"] = m.texture
    else:
        flat["texture"] = result.texture
    arrays = {k: t.detach().float().cpu().numpy() for k, t in flat.items()}
    return {k: hashlib.sha256(a.tobytes()).hexdigest()[:16]
            for k, a in arrays.items()}, arrays


def rank_worker(spec_path):
    """One rank of ``world_run``: joins the world on cuda:0, runs each job
    and writes its results (per CLI job: the launches counted from 0, the
    peak device memory, the textures' sha256 and the wall seconds; rank 0
    also saves the textures)."""
    import importlib
    import warnings

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from st3d_torch.parallel.sharding import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in ROUTE_ENV:
        os.environ.pop(k, None)
    with open(spec_path) as f:
        spec = json.load(f)
    results = []
    with distributed("cuda", init_method="file://" + spec["store"]) as world:
        for job in spec["jobs"]:
            if job["kind"] == "collectives":
                results.append(collectives_check(world))
                continue
            main_fn = importlib.import_module(
                f"st3d_torch.{job['entry']}").main
            for counts in launch_counts():
                for k in counts:
                    counts[k] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.use_deterministic_algorithms(job.get("deterministic",
                                                           False),
                                                   warn_only=True)
                try:
                    out = main_fn(job["argv"])
                finally:
                    torch.use_deterministic_algorithms(False)
            torch.cuda.synchronize()
            digests, arrays = _texture_digests(out)
            if world.main and job.get("save"):
                np.savez(job["save"], **arrays)
            results.append({
                "wall_s": time.perf_counter() - t0,
                "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "sha256": digests, "device": str(world.device),
                "backend": world.backend,
                "launches": {k: n for counts in launch_counts()
                             for k, n in counts.items() if n}})
    with open(os.path.join(os.path.dirname(spec_path),
                           f"result{world.rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


def collectives_check(world):
    """The three collectives the port uses, on CUDA tensors over this
    world's backend: ``all_reduce`` SUM, ``broadcast`` from rank 0 and
    ``all_gather`` of rows, each against the tensor it must give."""
    import torch
    from st3d_torch.parallel.sharding import all_sum, gather_cat, replicate

    dev, r, n = world.device, world.rank, world.size
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + r
    want_sum = sum(torch.arange(6, dtype=torch.float32,
                                device=dev).reshape(2, 3) + k
                   for k in range(n))
    b = x.clone()
    replicate([b], world)
    rows = gather_cat(x[:1].contiguous(), world)
    want_rows = torch.cat([x[:1] - r + k for k in range(n)])
    return {"all_reduce": bool(torch.equal(all_sum(x, world), want_sum)),
            "broadcast": bool(torch.equal(b, x - r)),
            "all_gather": bool(torch.equal(rows, want_rows))}


def _par_cli(entry, argv, save=None, deterministic=False):
    return {"kind": "cli", "entry": entry, "argv": argv, "save": save,
            "deterministic": deterministic}


def _same_on_every_rank(results, i, what):
    digests = [r[i]["sha256"] for r in results]
    if any(d != digests[0] for d in digests):
        fail(f"{what}: the ranks' textures differ: {digests}")
    return digests[0]


def _losses_close(got, want, rtol, what):
    if len(got) != len(want):
        fail(f"{what}: {len(got)} losses, want {len(want)}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if not rel <= rtol:
        fail(f"{what}: losses {got} against {want}, rel {rel} > {rtol}")
    return rel


def _pngs(path):
    from st3d_torch.io.image import read_png

    return {f: read_png(os.path.join(path, f)) for f in sorted(
        os.listdir(path))}


def parallel_phase(tmp, obj, style, styles, fleet_objs, refs):
    """Data and tile parallelism on one card (``st3d_torch/parallel``):
    NCCL on one rank, K1 and K6 on row bands, then worlds of ranks sharing
    cuda:0 over gloo (``world_run``): the second approach (texture, bf16
    for ``EPOCHS`` and float32 for ``F32_EPOCHS``, ``--data_parallel``)
    and the first approach (texture, 30 + 20 steps) on 2 ranks, each
    rank's texture hash equal and the losses within ``PAR_LOSS_RTOL`` (the
    first approach ``FA_PAR_RTOL``) of the single-process runs ``refs``
    names; multi-style (3 styles) and the fleet (2 x 2: a 1 x 3 grid of
    ranks over cells padded to 2 x 3) on 3 ranks in bf16 and float32,
    against the single-process runs' cells at their tolerances
    (``bf16_cells_agree``, ``CELL_TOL``); and two runs of 2 ranks at 1024²
    (``TILE_EPOCHS``, deterministic algorithms), one with
    ``--tile_parallel``, whose ``final_render/`` PNGs equal each other's
    and a world of 1's pixel for pixel. Prints the backend, each run's
    median step labelled by the ranks sharing the card, and each rank's
    peak memory; returns the record."""
    import numpy as np
    import torch

    nccl_check()
    dev = torch.device("cuda", 0)
    rec = {"band_max_abs_err": band_check(dev),
           "y_shift_flips": shift_flips(dev)}
    dp = ["--data_parallel", "True"]

    def sa(dtype, epochs):
        out = os.path.join(tmp, f"par_second_{dtype}")
        return out, second_approach_argv(obj, style, epochs, dtype, out) + dp

    sa_bf16, sa_f32 = sa("bfloat16", EPOCHS), sa("float32", F32_EPOCHS)
    fa_out = os.path.join(tmp, "par_first")
    fa_argv = ["--obj_path", obj, "--style_path", style, "--size", str(SIZE),
               "--n_views", str(VIEWS), "--batch_size", str(VIEWS),
               "--compute_dtype", "bfloat16", "--n_style_transfer_steps",
               str(ST_STEPS), "--n_mse_steps", str(MSE_STEPS),
               "--randomize_views", "False", "--device", "cuda",
               "--output_path", fa_out] + dp
    tile_argv = {k: second_approach_argv(
        obj, style, TILE_EPOCHS, "bfloat16", os.path.join(tmp, f"tile_{k}"))
        + ["--size", str(TILE_SIZE)] for k in ("one", "plain", "tiled")}
    tile_argv["tiled"] += ["--tile_parallel", "True"]
    t0 = time.perf_counter()
    two, log0 = world_run(tmp, "world2", 2, [
        {"kind": "collectives"},
        _par_cli("second_approach", sa_bf16[1]),
        _par_cli("second_approach", sa_f32[1]),
        _par_cli("first_approach", fa_argv),
        _par_cli("second_approach", tile_argv["plain"], deterministic=True),
        _par_cli("second_approach", tile_argv["tiled"], deterministic=True)])
    print(f"parallel: the world of 2 ranks took "
          f"{time.perf_counter() - t0:.1f} s")
    backend = [l for l in log0.splitlines() if "backend" in l]
    print("parallel: " + (backend[0] if backend else "no backend line"))
    if not backend or "backend gloo" not in backend[0]:
        fail("the world of 2 ranks on one card did not print its gloo "
             "backend")
    bad = [r[0] for r in two if not all(r[0].values())]
    print(f"parallel: gloo on cuda:0, 2 ranks: " + json.dumps(two[0][0]))
    if bad:
        fail(f"gloo collectives on CUDA tensors gave other tensors: {bad}")
    one, _ = world_run(tmp, "world1", 1, [
        _par_cli("second_approach", tile_argv["one"], deterministic=True)])

    runs = {}

    def report(what, results, i, out, ranks):
        """Print and keep a run's median step (epochs' ``step_s``; the
        first approach logs none), peak memory and wall seconds per rank,
        and its texture hash, failing unless every rank's is the same."""
        sha = _same_on_every_rank(results, i, what)
        peaks = [round(r[i]["peak_mib"], 1) for r in results]
        walls = [round(r[i]["wall_s"], 2) for r in results]
        runs[what] = {"ranks": ranks, "peak_mib_per_rank": peaks,
                      "sha256": sha, "wall_s": walls}
        step = ""
        if out is not None:
            step_ms, n = median_step_ms(out, 10)
            runs[what]["median_step_ms"] = step_ms
            step = f"median step {step_ms:.2f} ms over the last {n}, "
        print(f"parallel: {what} ({ranks} ranks sharing one card): {step}"
              f"run {walls} s, peak MiB per rank {peaks}, texture sha256 "
              f"per rank equal {sha}, rank 0 launches "
              + json.dumps(results[0][i]["launches"]))
        return results[0][i]["launches"]

    for i, (dtype, (out, _), epochs) in enumerate(
            (("bfloat16", sa_bf16, EPOCHS), ("float32", sa_f32,
                                             F32_EPOCHS)), start=1):
        launches = report(f"second approach {dtype} --data_parallel", two,
                          i, out, 2)
        rel = _losses_close(read_log(out), read_log(refs[dtype]),
                            PAR_LOSS_RTOL[dtype],
                            f"second approach {dtype} on 2 ranks")
        runs[f"second approach {dtype} --data_parallel"]["loss_rel"] = rel
        per = STEP_LAUNCHES if dtype == "bfloat16" else {
            "conv3x3_tf32x3": 22, "gram_tf32x3": 4}
        for k, n in per.items():
            if launches.get(k, 0) < n * epochs:
                fail(f"second approach {dtype} on 2 ranks: rank 0 launched "
                     f"{k} {launches.get(k, 0)} times, want {n} a step")
        check_outputs(out)
    report("first approach --data_parallel", two, 3, None, 2)
    rel = _losses_close(read_log(fa_out), read_log(refs["first"]),
                        FA_PAR_RTOL, "first approach on 2 ranks")
    runs["first approach --data_parallel"]["loss_rel"] = rel
    check_outputs(fa_out)

    pngs = {k: _pngs(os.path.join(tmp, f"tile_{k}", "final_render"))
            for k in tile_argv}
    for k in ("plain", "tiled"):
        diff = {f: int((pngs[k][f] != pngs["one"][f]).any(axis=-1).sum())
                for f in pngs["one"]}
        if len(pngs[k]) != 12 or any(diff.values()):
            fail(f"tile_parallel at {TILE_SIZE}²: {k} world-2 final_render "
                 f"differs from the world of 1 at {diff} pixels")
    if one[0][0]["sha256"] != two[0][4]["sha256"]:
        fail("the world-2 run at 1024² trained another texture than the "
             "world of 1 under deterministic algorithms")
    k1 = [r[5]["launches"].get("raster_hard", 0) for r in two]
    for what, results, i, k in (("1024² world of 1", one, 0, "one"),
                                ("1024² 2 ranks", two, 4, "plain"),
                                ("1024² 2 ranks --tile_parallel", two, 5,
                                 "tiled")):
        report(what, results, i, os.path.join(tmp, f"tile_{k}"),
               len(results))
    print(f"parallel: --tile_parallel at {TILE_SIZE}² x {VIEWS} views, "
          f"{TILE_EPOCHS} epochs, deterministic algorithms: 12 final_render "
          "PNGs equal pixel for pixel across the world of 1, 2 ranks and 2 "
          f"ranks tiled; K1 launches per rank in the tiled run {k1}")
    if min(k1) < 1:
        fail("a rank of the tiled run launched no K1")

    ms_out = {d: os.path.join(tmp, f"par_ms_{d}") for d in ("bf16", "f32")}
    fl_out = {d: os.path.join(tmp, f"par_fleet_{d}") for d in ("bf16", "f32")}
    ms_flags = ["--obj_path", obj, "--style_paths", ",".join(styles)] + dp
    fl_flags = ["--obj_paths", ",".join(fleet_objs), "--style_paths",
                ",".join(styles[:FLEET_STYLES])] + dp
    saves = {k: os.path.join(tmp, f"par_{k}.npz")
             for k in ("ms_bf16", "ms_f32", "fl_bf16", "fl_f32")}
    three, _ = world_run(tmp, "world3", 3, [
        _par_cli("multi_style", cell_argv(MS_EPOCHS, "bfloat16",
                                          ms_out["bf16"], *ms_flags),
                 saves["ms_bf16"]),
        _par_cli("multi_style", cell_argv(CELL_F32_EPOCHS, "float32",
                                          ms_out["f32"], *ms_flags),
                 saves["ms_f32"]),
        _par_cli("fleet", cell_argv(MS_EPOCHS, "bfloat16", fl_out["bf16"],
                                    *fl_flags), saves["fl_bf16"]),
        _par_cli("fleet", cell_argv(CELL_F32_EPOCHS, "float32",
                                    fl_out["f32"], *fl_flags),
                 saves["fl_f32"])])
    for i, (what, out, key, save, ref) in enumerate((
            ("multi-style bf16", ms_out["bf16"], "per_style",
             saves["ms_bf16"], refs["ms_bf16"]),
            ("multi-style f32", ms_out["f32"], "per_style", saves["ms_f32"],
             refs["ms_f32"]),
            ("fleet bf16", fl_out["bf16"], "per_cell", saves["fl_bf16"],
             refs["fl_bf16"]),
            ("fleet f32", fl_out["f32"], "per_cell", saves["fl_f32"],
             refs["fl_f32"]))):
        report(f"{what} --data_parallel", three, i, out, 3)
        epochs = CELL_F32_EPOCHS if "f32" in what else MS_EPOCHS
        falls = cells_fell(out, key, epochs, f"{what} on 3 ranks")
        with np.load(save) as z:
            got = {k: torch.from_numpy(z[k]) for k in z.files}
        ref_out, ref_tex, init = ref
        if "f32" in what:
            gap = max(float((got[k] - ref_tex[k].float().cpu()).abs().max())
                      for k in got)
            print(f"parallel: {what} on 3 ranks: max |texture - the single "
                  f"process's| {gap:.3g} (tolerance {CELL_TOL})")
            if not gap <= CELL_TOL:
                fail(f"{what} on 3 ranks: textures {gap} from one process")
            runs[f"{what} --data_parallel"]["max_abs_gap"] = gap
        else:
            ref_falls = cells_fell(ref_out, key, epochs, f"{what} reference")
            runs[f"{what} --data_parallel"]["vs_one_process"] = \
                bf16_cells_agree(
                    f"{what} on 3 ranks",
                    {k: (falls[k], got[k]) for k in got},
                    {k: (ref_falls[k], ref_tex[k], init[k]) for k in got})
    rec["runs"] = runs
    return rec


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    worker = len(argv) == 2 and argv[0] == "--rank"
    if argv not in ([], ["--steps"], ["--nnfm"], ["--k2"]) and not worker:
        print("usage: chip_smoke.py [--steps | --nnfm | --k2]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if worker:
        return rank_worker(argv[1])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import st3d_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in ROUTE_ENV:
        os.environ.pop(k, None)
    if argv == ["--nnfm"]:
        print(smi())
        nnfm_check(dev)
        return 0
    if argv == ["--k2"]:
        print(smi())
        k2_bf16_cell_check(dev)
        return 0
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
    kernels = raster_check(dev) + conv_check(dev) + k2_f32_cell_check(dev)
    kernels += k2_bf16_cell_check(dev)
    kernels += nnfm_check(dev)
    kernels += narrow_check(dev)
    kernels += gram_check(dev)
    kernels += stage1_check(dev)
    lap("K1-K3, A-D checks")
    kernels += [raster_soft_check(dev), raster_stream_check(dev),
                raster_topk_check(dev)]
    lap("K1-soft, K6, K7 checks")
    kernels += stage1v3_check(dev) + k8_check(dev) + raster_2d_check(dev)
    lap("E, F, K8, K9 checks")
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {level: write_scene(tmp, SIZE, seed=0, level=level)
                  for level in (ICO_LEVEL, STREAM_LEVEL)}
        obj, style = scenes[ICO_LEVEL]
        lap("scenes")
        texture = second_approach_path(tmp, obj, style, "default", EPOCHS)
        stage1_off = {route: second_approach_path(tmp, obj, style, route,
                                                  ROUTE_EPOCHS)
                      for route in STAGE1_OFF}
        stage1_off["pr1 f32"] = second_approach_path(
            tmp, obj, style, "pr1", ROUTE_EPOCHS, "float32",
            want=PR1_F32_KERNELS)
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
        f32_v3 = f32_v3_texture_path(
            tmp, obj, style, f32[A_KEYS["float32"]] - F32_EPOCHS)
        lap("f32 texture target")
        vertex = {}
        for mode, (target, *_) in VERTEX_RUNS.items():
            vertex[mode] = vertex_path(tmp, scenes, mode, card)[0]
            lap(f"{target} {mode}")
        by_name = {k["name"]: k for k in kernels}
        by_name["raster_hard"]["hard_run_twin"] = hard_twin_runs(
            tmp, scenes, card)
        lap("both hard, K1's twin")
        raster_hard_run_check(dev, os.path.join(tmp, "both_hard",
                                                "final.obj"),
                              by_name["raster_hard"])
        lap("K1 on the run's faces")
        raster_stream_run_check(
            dev, os.path.join(tmp, "both_stream", "final.obj"),
            by_name["raster_stream"])
        lap("K6 on the run's faces")
        raster_lists_run_check(
            dev, os.path.join(tmp, "both_soft", "final.obj"),
            os.path.join(tmp, "both_softras", "final.obj"),
            by_name["raster_soft"], by_name["raster_topk"])
        lap("K1-soft, K7 on the runs' faces")
        first = first_approach_path(tmp, obj, style)
        first_approach_path(tmp, obj, style, "both",
                            (FA_BOTH_STEPS, FA_BOTH_STEPS))
        hot_loop_a_ms(dev)
        hot_loop_a_ms(dev, "v3")
        lap("first approach")
        small_parity(tmp)
        lap("64² parity")
        batch_errs = cell_batch_check(dev)
        lap("bf16 VGG kernels at the cell batches")
        styles = style_pngs(tmp, MS_STYLES)
        ms_bf16, ms_f32, ms_rec, cells = multistyle_phase(tmp, obj, styles,
                                                          texture)
        lap("multi-style")
        fl_bf16, fl_f32, fl_rec, fleet_objs, fl_cells = fleet_phase(
            tmp, scenes, styles[:FLEET_STYLES], dev)
        cells.update(fl_cells)
        lap("fleet")
        padding_check(dev)
        lap("padding")
        resume = resume_check(tmp, obj, style)
        resume["first_approach"] = first_resume_check(tmp, obj, style)
        lap("resume")
        device_ms = debug_profile_phase(tmp, obj, styles, fleet_objs)
        lap("debug_nan, profile")
        parallel = parallel_phase(tmp, obj, style, styles, fleet_objs, dict(
            cells, bfloat16=os.path.join(tmp, "second_default_bfloat16"),
            float32=os.path.join(tmp, "second_default_float32"),
            first=os.path.join(tmp, "first_texture")))
        lap("parallel")
    print("phase seconds " + json.dumps(seconds))
    print("multi-style and fleet " + json.dumps({
        "multistyle": ms_rec, "fleet": fl_rec, "resume": resume,
        "device_ms_per_step": device_ms}))
    print("parallel " + json.dumps(parallel))
    # Launches on this slice's path: each raster kernel from the first
    # vertex run of its mode (K7: SoftRas), the VGG kernels from the hard
    # run, the float32 route's kernels from the f32 texture run, the
    # float32 E and F from the f32 v3 texture run.
    mode_of = {}
    for mode, (*_, kernel) in VERTEX_RUNS.items():
        mode_of.setdefault(kernel, mode)
    for k in kernels:
        if k["name"] in V3_KEYS["float32"]:
            k["launches"] = f32_v3.get(k["name"], 0)
            continue
        if k.get("dtype") == "float32":
            k["launches"] = f32.get(k["name"], 0)
            continue
        k["launches"] = vertex[mode_of.get(k["name"], "hard")].get(
            k["name"], 0)
        k["launches_texture_target"] = texture.get(k["name"], 0)
        k["launches_first_approach"] = first.get(k["name"], 0)
    # conv1_1's PᵀP runs only where stage 1 is off: gram_narrow's launches
    # are PR 1's route's (bf16, and float32 for the float32 row).
    for k in kernels:
        if k["name"] == "gram_narrow":
            run = "pr1 f32" if k["dtype"] == "float32" else "pr1"
            k["launches"] = stage1_off[run]["gram_narrow"]
            k["launches_route"] = f"{run}, {ROUTE_EPOCHS} steps"
            k["launches_k5"] = stage1_off["k5"]["gram_narrow"]
    kernels += route_entries(kernels, texture, routes)
    # Launches on the multi-style and fleet paths (bf16 runs; the float32
    # kernels from the float32 runs).
    for k in kernels:
        key, f32_row = k["name"].split(" (")[0], k.get("dtype") == "float32"
        k["launches_multistyle"] = (ms_f32 if f32_row else ms_bf16).get(key,
                                                                        0)
        k["launches_fleet"] = (fl_f32 if f32_row else fl_bf16).get(key, 0)
        if k["name"] in batch_errs and not f32_row:
            k["max_abs_err_cell_batches"] = batch_errs[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
