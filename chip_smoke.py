#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``st3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. Card: ``nvidia-smi`` name and power limit, torch/CUDA/nvcc versions, and
   the build of every hand-written kernel from ``st3d_torch/csrc``.
2. Kernel checks at the main path's shapes, each kernel against its plain
   PyTorch version on the same inputs (TF32 off for the plain versions):
   K1 ``raster_hard`` (4 fixed views at 512², ico-sphere level 4):
   pix_to_face exactly equal, zbuf within rtol 1e-6;
   K2 ``conv3x3_nhwc`` (every VGG conv shape at batch 4, bf16 and f32,
   forward and input gradient): bf16 max-abs error <= 1e-2 * max|plain|,
   f32 max-abs error <= 1e-4 * max|plain|;
   K3 ``gram_nhwc`` (the four style-Gram shapes): relative Frobenius error
   <= 1e-3 from bf16 and <= 1e-5 from f32;
   stage 1 at 512² x 4 (conv1_1 3->64, conv1_2 64->64), bf16 and f32:
   A ``conv1_1_stats``, B ``conv1_1_bwd``, C ``conv3x3_relu_pool``, D
   ``pool_route_conv3x3_bwd``: z, dx, pooled and dz max-abs error <= 1e-2 *
   max|plain| in bf16 and <= 1e-4 * max|plain| in f32; PᵀP and s27
   relative Frobenius error <= 1e-4 (sums of 2¹⁸ terms per image, taken in
   another order); idx equal wherever the plain top two of the window
   differ by more than the output tolerance.
   Times are CUDA-event means after warm-up (bf16).
3. The second approach (``st3d_torch.second_approach.main``) at 512², 4
   views, batch 4, bf16, 20 epochs on a seeded synthetic scene, on the
   default VGG route: every loss finite, the last below the first,
   ``final.obj`` and ``final_render/`` written, all seven kernels launched.
   Then 5 epochs each on PR 1's route (``ST3D_NO_STAGE1_V2=1
   ST3D_NO_PACKED1=1``: K1-K3 only) and on the K5 route
   (``ST3D_NO_STAGE1_V2=1``: C and D, not A and B).
4. The first approach (``st3d_torch.first_approach.main``) at 512², 4 views,
   batch 4, bf16, 30 style-transfer and 20 MSE steps: finite losses, the MSE
   loss falling, four ``2d_style_transfer/`` views, 12 ``final_render/``
   views and ``final.obj``, all seven kernels launched; then the ms per
   hot-loop-A step (``style_transfer`` at the same shape, after warm-up).
5. Both entry points at 64² f32 on the GPU against the same runs on the CPU
   (plain versions): losses within rtol 1e-3.
6. One JSON line with the kernels' results, then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""

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
# The VGG routes: the switches each sets, and the kernels it must launch.
KERNELS = ("raster_hard", "conv3x3_nhwc", "gram_nhwc", "conv1_1_stats",
           "conv1_1_bwd", "conv3x3_relu_pool", "pool_route_conv3x3_bwd")
ROUTES = {
    "default": ({}, set(KERNELS)),
    "pr1": ({"ST3D_NO_STAGE1_V2": "1", "ST3D_NO_PACKED1": "1"},
            {"raster_hard", "conv3x3_nhwc", "gram_nhwc"}),
    "k5": ({"ST3D_NO_STAGE1_V2": "1"},
           {"raster_hard", "conv3x3_nhwc", "gram_nhwc", "conv3x3_relu_pool",
            "pool_route_conv3x3_bwd"}),
}
# (Cin, Cout, H) of the convs K2 runs at 512² (conv1_2 .. conv5_1).
VGG_K2_CONVS = [
    (64, 64, 512), (64, 128, 256), (128, 128, 256), (128, 256, 128),
    (256, 256, 128), (256, 256, 128), (256, 256, 128), (256, 512, 64),
    (512, 512, 64), (512, 512, 64), (512, 512, 64), (512, 512, 32),
]
GRAM_SHAPES = [(256, 128), (128, 256), (64, 512), (32, 512)]   # (H, C)


def fail(msg):
    raise RuntimeError(msg)


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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.2f}s "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}))


def raster_check(dev):
    import torch
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.kernels.raster import (
        preprocess, raster_hard, raster_hard_plain)
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = ico_sphere(level=ICO_LEVEL).to(dev)
    cams = build_fixed_cameras(VIEWS, seed=0).to(dev)
    fv = face_verts_screen(mesh.verts, mesh.faces, cams, SIZE)
    coeffs, bounds, _ = preprocess(fv)
    p2f_k, z_k = raster_hard(coeffs, bounds, SIZE, SIZE)
    p2f_p, z_p = raster_hard_plain(coeffs, bounds, SIZE, SIZE)
    torch.cuda.synchronize()
    mismatch = int((p2f_k != p2f_p).sum())
    hit = p2f_p >= 0
    zerr = float((z_k - z_p).abs().max())
    zrel = float(((z_k - z_p).abs() / z_p.abs())[hit].max())
    covered = float(hit.float().mean())
    print(f"K1 raster_hard: {mesh.num_faces} faces, coverage {covered:.4f}, "
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
    return {"name": "raster_hard", "route": "cuda",
            "source": "st3d_torch/csrc/raster_hard.cu",
            "replaces": "st3d/kernels/raster_pallas.py:134",
            "max_abs_err": zerr, "ms": ms, "plain_ms": plain_ms}


def conv_check(dev):
    import torch
    from st3d_torch.kernels.conv import (
        _transpose_conv, conv3x3_nhwc, conv3x3_nhwc_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_abs, ms_total, plain_total = 0.0, 0.0, 0.0
    seen = {}
    for cin, cout, h in VGG_K2_CONVS:
        for dtype in (torch.bfloat16, torch.float32):
            key = (cin, cout, h, dtype)
            if key not in seen:
                x = torch.randn((VIEWS, h, h, cin), generator=gen,
                                device=dev).to(dtype)
                w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
                     * (2.0 / (9 * cin)) ** 0.5).to(dtype)
                b = (0.1 * torch.randn((cout,), generator=gen,
                                       device=dev)).to(dtype)
                ct = torch.randn((VIEWS, h, h, cout), generator=gen,
                                 device=dev).to(dtype)
                relu = cin == cout and h != 32
                errs = []
                y_k = conv3x3_nhwc(x, w, b, relu)
                y_p = conv3x3_nhwc_plain(x, w, b, relu)
                wt = torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2)
                zb = torch.zeros(cin, dtype=dtype, device=dev)
                d_k = _transpose_conv(ct, w)
                d_p = conv3x3_nhwc_plain(ct, wt, zb)
                tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
                for what, a, ref in (("fwd", y_k, y_p), ("dx", d_k, d_p)):
                    err = float((a.float() - ref.float()).abs().max())
                    scale = float(ref.float().abs().max())
                    errs.append(f"{what} {err:.3g}/{scale:.3g}")
                    worst_abs = max(worst_abs, err)
                    if not err <= tol * scale:
                        fail(f"K2 {what} {key}: max err {err} > {tol} * "
                             f"{scale}")
                seen[key] = True
                if dtype == torch.bfloat16:
                    t_k = cuda_ms(lambda: conv3x3_nhwc(x, w, b, relu), 5)
                    t_p = cuda_ms(lambda: conv3x3_nhwc_plain(x, w, b, relu),
                                  3, 1)
                    seen[(cin, cout, h, "ms")] = (t_k, t_p)
                    print(f"K2 {cin:>3}->{cout:<3} {h:>3}² bf16 "
                          f"{' '.join(errs)}  kernel {t_k:.3f} ms plain "
                          f"{t_p:.3f} ms")
                else:
                    print(f"K2 {cin:>3}->{cout:<3} {h:>3}² f32  "
                          f"{' '.join(errs)}")
            if dtype == torch.bfloat16:
                t_k, t_p = seen[(cin, cout, h, "ms")]
                ms_total += t_k
                plain_total += t_p
    print(f"K2 one bf16 VGG forward (12 convs): kernel {ms_total:.3f} ms, "
          f"plain {plain_total:.3f} ms")
    return {"name": "conv3x3_nhwc", "route": "cuda",
            "source": "st3d_torch/csrc/conv3x3_nhwc.cu",
            "replaces": "st3d/kernels/conv_pallas.py:128",
            "max_abs_err": worst_abs, "ms": ms_total, "plain_ms": plain_total}


def gram_check(dev):
    import torch
    from st3d_torch.kernels.conv import gram_nhwc, gram_nhwc_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    worst_abs, ms_total, plain_total = 0.0, 0.0, 0.0
    for h, c in GRAM_SHAPES:
        for dtype, tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
            y = torch.relu(torch.randn((VIEWS, h, h, c), generator=gen,
                                       device=dev)).to(dtype)
            g_k = gram_nhwc(y)
            g_p = gram_nhwc_plain(y)
            rel = float(torch.linalg.norm(g_k - g_p) / torch.linalg.norm(g_p))
            worst_abs = max(worst_abs, float((g_k - g_p).abs().max()))
            line = f"K3 ({VIEWS},{h}²,{c}) {str(dtype)[6:]} rel fro err {rel:.3g}"
            if rel > tol:
                fail(f"{line} > {tol}")
            if dtype == torch.bfloat16:
                t_k = cuda_ms(lambda: gram_nhwc(y))
                t_p = cuda_ms(lambda: gram_nhwc_plain(y))
                ms_total += t_k
                plain_total += t_p
                line += f"  kernel {t_k:.3f} ms plain {t_p:.3f} ms"
            print(line)
    return {"name": "gram_nhwc", "route": "cuda",
            "source": "st3d_torch/csrc/gram_nhwc.cu",
            "replaces": "st3d/kernels/conv_pallas.py:548",
            "max_abs_err": worst_abs, "ms": ms_total, "plain_ms": plain_total}


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


def stage1_check(dev):
    """Kernels A-D at the stage-1 shapes of the main path (4 x 512² x 3 ->
    64 -> 64, pool to 256²), each against its plain version."""
    import torch
    from st3d_torch.kernels import conv as kconv
    from st3d_torch.kernels import stage1 as ks1

    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (VIEWS, SIZE, SIZE)
    res = {n: {"max_abs_err": 0.0} for n in KERNELS[3:]}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        name = str(dtype)[6:]
        x = torch.rand(shape + (3,), generator=gen, device=dev).to(dtype)
        w1 = (torch.randn((3, 3, 3, 64), generator=gen, device=dev)
              * (2.0 / 27) ** 0.5).to(dtype)
        b1 = (0.1 * torch.randn((64,), generator=gen, device=dev)).to(dtype)
        w2 = (torch.randn((3, 3, 64, 64), generator=gen, device=dev)
              * (2.0 / 576) ** 0.5).to(dtype)
        b2 = (0.1 * torch.randn((64,), generator=gen, device=dev)).to(dtype)
        dz = torch.randn(shape + (64,), generator=gen, device=dev).to(dtype)
        dg = 1e-3 * torch.randn((VIEWS, 27, 27), generator=gen, device=dev)
        sym = dg + dg.transpose(1, 2)
        ds = 1e-3 * torch.randn((VIEWS, 27), generator=gen, device=dev)
        ct = torch.randn((VIEWS, SIZE // 2, SIZE // 2, 64), generator=gen,
                         device=dev).to(dtype)

        # A: z and the patch statistics.
        z, ptp, s27 = ks1.conv1_1_stats(x, w1, b1)
        z_p, ptp_p, s27_p = ks1.conv1_1_stats_plain(x, w1, b1)
        errs = {"conv1_1_stats": _max_err(z, z_p, tol, f"A z {name}")}
        for what, got, ref in (("PtP", ptp, ptp_p), ("s27", s27, s27_p)):
            rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
            print(f"A conv1_1_stats {name} {what} rel fro err {rel:.3g}")
            if rel > 1e-4:
                fail(f"A {what} {name}: rel fro err {rel} > 1e-4")
        # B: dx from the plain forward's z.
        dx = ks1.conv1_1_bwd(x, dz, z_p, w1, sym, ds)
        dx_p = ks1.conv1_1_bwd_plain(x, dz, z_p, w1, sym, ds)
        errs["conv1_1_bwd"] = _max_err(dx, dx_p, tol, f"B dx {name}")
        # C: pooled and idx from the plain forward's z.
        pooled, idx = kconv.conv3x3_relu_pool(z_p, w2, b2)
        pooled_p, idx_p = kconv.conv3x3_relu_pool_plain(z_p, w2, b2)
        errs["conv3x3_relu_pool"] = _max_err(pooled, pooled_p, tol,
                                             f"C pooled {name}")
        bad, sep = _idx_mismatches(
            idx, idx_p, kconv.conv3x3_nhwc_plain(z_p, w2, b2, True),
            tol * errs["conv3x3_relu_pool"][1])
        print(f"C conv3x3_relu_pool {name} idx mismatches {bad} where "
              f"separated ({sep:.3f} of the cells), elsewhere "
              f"{int((idx != idx_p).sum())}")
        if bad:
            fail(f"C idx {name}: {bad} mismatches where separated")
        # D: dz from the plain forward's pooled and idx.
        dz2 = kconv.pool_route_conv3x3_bwd(ct, pooled_p, idx_p, w2)
        dz2_p = kconv.pool_route_conv3x3_bwd_plain(ct, pooled_p, idx_p, w2)
        errs["pool_route_conv3x3_bwd"] = _max_err(dz2, dz2_p, tol,
                                                  f"D dz {name}")
        torch.cuda.synchronize()

        calls = {
            "conv1_1_stats": (lambda: ks1.conv1_1_stats(x, w1, b1),
                              lambda: ks1.conv1_1_stats_plain(x, w1, b1)),
            "conv1_1_bwd": (
                lambda: ks1.conv1_1_bwd(x, dz, z_p, w1, sym, ds),
                lambda: ks1.conv1_1_bwd_plain(x, dz, z_p, w1, sym, ds)),
            "conv3x3_relu_pool": (
                lambda: kconv.conv3x3_relu_pool(z_p, w2, b2),
                lambda: kconv.conv3x3_relu_pool_plain(z_p, w2, b2)),
            "pool_route_conv3x3_bwd": (
                lambda: kconv.pool_route_conv3x3_bwd(ct, pooled_p, idx_p, w2),
                lambda: kconv.pool_route_conv3x3_bwd_plain(ct, pooled_p,
                                                           idx_p, w2)),
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
    meta = {
        "conv1_1_stats": ("st3d_torch/csrc/conv1_1_stats.cu",
                          "st3d/kernels/stage1_pallas.py:446"),
        "conv1_1_bwd": ("st3d_torch/csrc/conv1_1_bwd.cu",
                        "st3d/kernels/stage1_pallas.py:583"),
        "conv3x3_relu_pool": ("st3d_torch/csrc/conv3x3_relu_pool.cu",
                              "st3d/kernels/stage1_pallas.py:485, "
                              "st3d/kernels/conv_pallas.py:760"),
        "pool_route_conv3x3_bwd": ("st3d_torch/csrc/pool_route_conv3x3_bwd.cu",
                                   "st3d/kernels/stage1_pallas.py:539, "
                                   "st3d/kernels/conv_pallas.py:785"),
    }
    return [{"name": n, "route": "cuda", "source": meta[n][0],
             "replaces": meta[n][1], **res[n]} for n in KERNELS[3:]]


def write_scene(root, size, seed):
    """Synthetic scene written with the port's own writers: an ico-sphere
    with spherical UVs and a seeded texture, plus a seeded style PNG."""
    import numpy as np
    import torch
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.core.uv import generate_uvs
    from st3d_torch.io.image import write_png
    from st3d_torch.io.obj import save_mesh

    rng = np.random.RandomState(seed)
    mesh = generate_uvs(ico_sphere(level=ICO_LEVEL), mode="sphere",
                        texture_size=size)
    tex = rng.rand(size, size, 3).astype(np.float32)
    save_mesh(mesh.replace(texture=torch.from_numpy(tex)),
              os.path.join(root, "scene", "mesh.obj"))
    style = (rng.rand(size, size, 3) * 255).astype(np.uint8)
    write_png(os.path.join(root, "style.png"), style)
    return os.path.join(root, "scene", "mesh.obj"), os.path.join(root,
                                                                 "style.png")


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

    return (kraster.LAUNCHES, kconv.LAUNCHES, ks1.LAUNCHES)


def drive(path, route, run):
    """Run ``run()`` on a VGG route with every launch count set to 0 just
    before; fail unless exactly the route's kernels launched. Returns the
    counts read just after."""
    env, want = ROUTES[route]
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


def check_outputs(out):
    if not os.path.isfile(os.path.join(out, "final.obj")):
        fail(f"{out}: final.obj missing")
    n_views = len(os.listdir(os.path.join(out, "final_render")))
    if n_views != 12:
        fail(f"{out}: final_render holds {n_views} views, want 12")


def second_approach_path(tmp, obj, style, route, epochs):
    from st3d_torch.second_approach import main as second_approach

    out = os.path.join(tmp, f"second_{route}")
    t0 = time.perf_counter()
    launches = drive("second approach", route, lambda: second_approach([
        "--obj_path", obj, "--style_path", style, "--size", str(SIZE),
        "--n_views", str(VIEWS), "--batch_size", str(VIEWS),
        "--compute_dtype", "bfloat16", "--epochs", str(epochs),
        "--save_intermediate", "False", "--randomize_views", "False",
        "--device", "cuda", "--output_path", out]))
    wall = time.perf_counter() - t0
    losses = read_log(out)
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        fail(f"second approach losses not {epochs} finite values: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"second approach loss did not fall: {losses[0]} -> "
             f"{losses[-1]}")
    check_outputs(out)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [json.loads(l)["step_s"] for l in f]
    last = steps[1:][-10:]
    step_ms = 1e3 * statistics.median(last)
    print(f"second approach {SIZE}² x {VIEWS} views bf16, route {route}: "
          f"loss {losses[0]:.6g} -> {losses[-1]:.6g} over {epochs} epochs, "
          f"median step {step_ms:.2f} ms over the last {len(last)}, run "
          f"{wall:.1f}s, launches " + json.dumps(launches))
    return launches


def first_approach_path(tmp, obj, style):
    from st3d_torch.first_approach import main as first_approach

    out = os.path.join(tmp, "first")
    t0 = time.perf_counter()
    launches = drive("first approach", "default", lambda: first_approach([
        "--obj_path", obj, "--style_path", style, "--size", str(SIZE),
        "--n_views", str(VIEWS), "--batch_size", str(VIEWS),
        "--compute_dtype", "bfloat16", "--n_style_transfer_steps",
        str(ST_STEPS), "--n_mse_steps", str(MSE_STEPS),
        "--randomize_views", "False", "--device", "cuda",
        "--output_path", out]))
    wall = time.perf_counter() - t0
    losses = read_log(out)
    if len(losses) != MSE_STEPS or not all(map(math.isfinite, losses)):
        fail(f"first approach losses not {MSE_STEPS} finite values: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"first approach MSE loss did not fall: {losses[0]} -> "
             f"{losses[-1]}")
    st = sorted(os.listdir(os.path.join(out, "2d_style_transfer")))
    if st != [f"view_{i}.png" for i in range(VIEWS)]:
        fail(f"2d_style_transfer holds {st}")
    check_outputs(out)
    print(f"first approach {SIZE}² x {VIEWS} views bf16, {ST_STEPS} style-"
          f"transfer + {MSE_STEPS} MSE steps: MSE loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, run {wall:.1f}s, launches "
          + json.dumps(launches))
    return launches


def hot_loop_a_ms(dev):
    """ms per hot-loop-A step at 512² x 4 bf16: two synchronised runs of
    ``style_transfer`` (after a warm-up), their difference over the
    difference in steps, so the targets' set-up cancels."""
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
                       dtype=torch.bfloat16)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(3)
    short, long = run(5), run(25)
    ms = 1e3 * (long - short) / 20
    print(f"hot loop A {SIZE}² x {VIEWS} bf16: {ms:.2f} ms per step "
          f"(25 steps {long:.3f}s, 5 steps {short:.3f}s)")
    return ms


def small_parity(tmp):
    """Both entry points at 64² f32 on the GPU against the same runs on the
    CPU."""
    from st3d_torch.first_approach import main as first_approach
    from st3d_torch.second_approach import main as second_approach

    obj, style = write_scene(os.path.join(tmp, "small"), 64, seed=1)
    common = ["--obj_path", obj, "--style_path", style, "--size", "64",
              "--n_views", "2", "--batch_size", "2", "--compute_dtype",
              "float32", "--randomize_views", "False"]
    entries = {
        "second": (second_approach, ["--epochs", "3", "--save_intermediate",
                                     "False"]),
        "first": (first_approach, ["--n_style_transfer_steps", "5",
                                   "--n_mse_steps", "5"]),
    }
    for entry, (fn, extra) in entries.items():
        runs = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"small_{entry}_{device}")
            fn(common + extra + ["--device", device, "--output_path", out])
            runs[device] = read_log(out)
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(runs["cuda"], runs["cpu"]))
        print(f"64² f32 {entry} approach GPU vs CPU losses: {runs['cuda']} "
              f"vs {runs['cpu']}, max rel diff {rel:.3g}")
        if len(runs["cuda"]) != len(runs["cpu"]) or rel > 1e-3:
            fail(f"{entry} approach: GPU and CPU losses differ by {rel}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import st3d_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1"):
        os.environ.pop(k, None)
    card_phase()
    kernels = [raster_check(dev), conv_check(dev), gram_check(dev)]
    kernels += stage1_check(dev)
    with tempfile.TemporaryDirectory() as tmp:
        obj, style = write_scene(tmp, SIZE, seed=0)
        launches = second_approach_path(tmp, obj, style, "default", EPOCHS)
        for route in ("pr1", "k5"):
            second_approach_path(tmp, obj, style, route, ROUTE_EPOCHS)
        first = first_approach_path(tmp, obj, style)
        hot_loop_a_ms(dev)
        small_parity(tmp)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_first_approach"] = first[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
