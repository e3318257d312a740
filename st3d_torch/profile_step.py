"""Where the time of a second-approach step goes, on one NVIDIA GPU.

    python -m st3d_torch.profile_step [--size 512] [--views 4] [--steps 5]
        [--modes texture,texture_f32,hard,soft,softras,stream] [--out DIR]

Writes the synthetic scene ``chip_smoke.py`` drives (an ico-sphere with
spherical UVs, a seeded texture and a seeded style image; level 4, and
level 7 with 327,680 faces for the streaming mode), then runs
``run_second_approach`` once per mode at the given size, ``views`` views in
one batch, bf16: the texture target (visibility hoisted; also in
float32, the CLIs' default dtype, as ``texture_f32``) and the both target
re-rasterised every step in hard mode (K1), soft mode (K1's soft mode),
SoftRas with 4 faces per pixel (K7) and hard mode on the level-7 sphere
(K6). After 3 warm-up steps, ``steps`` steps run under
``torch.profiler`` (CUPTI). For each mode it prints the median step time
(host clock between synchronised step ends), the device time per step
summed over kernels, the idle share (1 - device / step time), the device
time per step by kernel group, and the top kernels; then one JSON line per
mode. Raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

# Mode -> (extra second-approach flags, ico-sphere level); the flags
# override the bf16 default of ``profile_mode``.
MODES: Dict[str, Tuple[List[str], int]] = {
    "texture": (["--optimization_target", "texture"], 4),
    "texture_f32": (["--optimization_target", "texture", "--compute_dtype",
                     "float32"], 4),
    "hard": (["--optimization_target", "both"], 4),
    "soft": (["--optimization_target", "both", "--soft_raster", "true"], 4),
    "softras": (["--optimization_target", "both", "--soft_raster", "true",
                 "--faces_per_pixel", "4"], 4),
    "stream": (["--optimization_target", "both"], 7),
}
WARMUP_STEPS = 3
# Kernel groups, first match wins (lower-cased kernel names).
GROUPS = (
    ("raster kernels", ("raster_",)),
    ("VGG kernels", ("conv3x3", "gram_", "conv1_1", "pool_route")),
    ("index/gather/scatter", ("index", "scatter", "gather", "put_")),
    ("sort", ("sort", "radix")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas")),
)


def write_sphere_scene(root: str, size: int, seed: int, level: int,
                       sphere=None) -> Tuple[str, str]:
    """An ico-sphere at ``level`` (``sphere`` if given, already built) with
    spherical UVs and a seeded ``size``² texture
    (``<root>/scene<level>/mesh.obj``), and a seeded style PNG
    (``<root>/style.png``); returns both paths."""
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.core.uv import generate_uvs
    from st3d_torch.io.image import write_png
    from st3d_torch.io.obj import save_mesh

    rng = np.random.RandomState(seed)
    if sphere is None:
        sphere = ico_sphere(level=level)
    mesh = generate_uvs(sphere, mode="sphere", texture_size=size)
    tex = rng.rand(size, size, 3).astype(np.float32)
    obj = os.path.join(root, f"scene{level}", "mesh.obj")
    save_mesh(mesh.replace(texture=torch.from_numpy(tex)), obj)
    style = os.path.join(root, "style.png")
    write_png(style, (rng.rand(size, size, 3) * 255).astype(np.uint8))
    return obj, style


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def kernel_ms(events, reps: int) -> Dict[str, float]:
    """Milliseconds per rep of each device-side event of a profiler trace
    (kernels, copies, sets) over ``reps`` reps, by name. The host ranges
    around them, and their GPU-side annotations (``ProfilerStep#k``,
    ``Optimizer.step#...``), carry the same time again and are left out."""
    per: Dict[str, float] = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and "#" not in e.name):
            per[e.name] = (per.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / reps)
    return per


def profile_mode(mode: str, obj: str, style: str, size: int, views: int,
                 steps: int, out: str) -> dict:
    """Run the mode and profile ``steps`` steps after the warm-up."""
    from st3d_torch.engine.config import parse_second_approach
    from st3d_torch.engine.pipelines import run_second_approach

    extra, _ = MODES[mode]
    cfg = parse_second_approach([
        "--obj_path", obj, "--style_path", style, "--size", str(size),
        "--n_views", str(views), "--batch_size", str(views),
        "--compute_dtype", "bfloat16", "--epochs", str(WARMUP_STEPS + steps),
        "--save_intermediate", "False", "--randomize_views", "False",
        "--device", "cuda", "--output_path", os.path.join(out, mode)]
        + extra)
    ends: List[float] = []
    traces = []
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(
            activities=[act.CPU, act.CUDA],
            schedule=torch.profiler.schedule(wait=WARMUP_STEPS - 1,
                                             warmup=1, active=steps),
            on_trace_ready=lambda p: traces.append(p.events())) as prof:

        def after_step(optimizer, args, kwargs):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            prof.step()

        # Every optimizer step of the run ends a profiler step; the hook is
        # global, so it is removed as soon as the run ends.
        hook = register_optimizer_step_post_hook(after_step)
        try:
            run_second_approach(cfg)
        finally:
            hook.remove()
    walls = np.diff(ends[WARMUP_STEPS - 1:WARMUP_STEPS + steps])
    per_kernel = kernel_ms(traces[-1] if traces else [], steps)
    groups: Dict[str, float] = {}
    for name, ms in per_kernel.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    device_ms = sum(per_kernel.values())
    step_ms = 1e3 * statistics.median(walls)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"mode": mode, "size": size, "views": views, "steps": steps,
            "dtype": cfg.compute_dtype,
            "step_ms": step_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / step_ms,
            "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top": [[name[:90], ms] for name, ms in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    modes = args.modes.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        scenes = {}
        results = []
        for mode in modes:
            level = MODES[mode][1]
            if level not in scenes:
                scenes[level] = write_sphere_scene(out, args.size, 0, level)
            r = profile_mode(mode, *scenes[level], args.size, args.views,
                             args.steps, out)
            results.append(r)
            print(f"{mode}: {card}, {args.size}² x {args.views} "
                  f"{r['dtype']}, step "
                  f"{r['step_ms']:.2f} ms (median of {args.steps}), device "
                  f"{r['device_ms']:.2f} ms, idle {r['idle_share']:.3f}")
            for g, ms in r["groups"].items():
                print(f"  {g:<22} {ms:8.3f} ms")
            for name, ms in r["top"]:
                print(f"    {ms:8.3f} ms  {name}")
    for r in results:
        print(json.dumps({"card": card, **r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
