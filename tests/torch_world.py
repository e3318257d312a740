"""Worlds of gloo ranks on the CPU for the port's parallel tests.

``launch(n, jobs, root)`` starts ``n`` processes of this file, one per
rank, with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set as ``torchrun``
sets them. They meet through a ``FileStore`` under ``root`` (no port, so
concurrent test workers never collide), run ``jobs`` in order inside one
process group, one torch thread each, and write each job's result to
``root/result{rank}.json``. No rank imports JAX. A world that outlives
``timeout`` seconds is killed and fails the test.

Jobs (dicts):
  * ``{"kind": "cli", "entry": "second_approach", "argv": [...],
    "save": path}``: the entry point's ``main(argv)``; with ``save``, each
    rank writes the textures it returns to ``{path}.rank{r}.npz``;
  * ``{"kind": "tiled", "size": s, "out": path}``: ``render_rgba_tiled``
    at s² of ``sphere_mesh()`` seen by ``tiled_cameras()`` and its texture and
    vertex gradients, saved by every rank to ``{path}.rank{r}.npz``, and
    ``save_render`` with ``tile_parallel`` into ``{path}_png``;
  * ``{"kind": "mesh", "n": n}``: ``make_device_mesh(world, n)``;
  * any job with ``"raises": "ValueError"`` records the error's message
    (and fails unless it raised).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(n: int, jobs, root, timeout: float = 300.0):
    """Run ``jobs`` in a world of ``n`` ranks; returns each rank's results
    (a list, rank order) and raises AssertionError, with the ranks'
    output, if any rank fails or the world outlives ``timeout``."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({"store": os.path.join(root, "store"), "jobs": jobs}, f)
    procs, logs = [], []
    for r in range(n):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(n),
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec], env=env,
            cwd=root, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
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
    out = ""
    for r in range(n):
        with open(os.path.join(root, f"rank{r}.log")) as f:
            out += f"--- rank {r} ---\n{f.read()[-4000:]}\n"
    assert all(p.returncode == 0 for p in procs), out
    results = []
    for r in range(n):
        with open(os.path.join(root, f"result{r}.json")) as f:
            results.append(json.load(f))
    return results


def tiled_cameras():
    """Two fixed cameras (``test_torch_render.py``'s)."""
    from st3d_torch.core.cameras import build_fixed_cameras

    return build_fixed_cameras(2, seed=0)


def sphere_mesh():
    """The level-2 sphere with ``test_torch_render.py``'s seeded 24 x 20
    texture."""
    import numpy as np
    import torch

    from st3d_torch.core.primitives import ico_sphere

    tex = np.random.RandomState(0).rand(24, 20, 3).astype(np.float32)
    return ico_sphere(level=2).replace(texture=torch.tensor(tex))


def tiled_loss_weights(size):
    import torch

    return torch.linspace(0.0, 1.0, size)[None, :, None, None]


def _tiled(job, world):
    import numpy as np
    import torch

    from st3d_torch.engine.pipelines import save_render
    from st3d_torch.parallel.tiles import render_rgba_tiled
    from st3d_torch.render.rasterize import RasterizationSettings

    size = job["size"]
    mesh = sphere_mesh()
    cams = tiled_cameras()
    settings = RasterizationSettings(image_size=size)
    tex = mesh.texture.clone().requires_grad_(True)
    verts = mesh.verts.clone().requires_grad_(True)
    rgba = render_rgba_tiled(mesh.replace(texture=tex, verts=verts), cams,
                             settings, world)
    (rgba[..., :3] * tiled_loss_weights(size)).sum().backward()
    np.savez(f"{job['out']}.rank{world.rank}.npz",
             rgba=rgba.detach().numpy(), tex=tex.grad.numpy(),
             verts=verts.grad.numpy())
    save_render(mesh, cams, settings, job["out"] + "_png",
                tile_parallel=True, world=world)


def _cli(job, world):
    import importlib

    import numpy as np

    main = importlib.import_module(f"st3d_torch.{job['entry']}").main
    result = main(job["argv"])
    if job.get("save"):
        if isinstance(result, dict):
            flat = {}
            for k, v in result.items():
                if isinstance(v, dict):
                    flat.update({f"{k}/{s}": m.texture.detach().numpy()
                                 for s, m in v.items()})
                else:
                    flat[k] = v.texture.detach().numpy()
        else:
            flat = {"texture": result.texture.detach().numpy(),
                    "verts": result.verts.detach().numpy()}
        np.savez(f"{job['save']}.rank{world.rank}.npz", **flat)


def _run(job, world):
    from st3d_torch.parallel.sharding import make_device_mesh

    if job["kind"] == "cli":
        return _cli(job, world)
    if job["kind"] == "tiled":
        return _tiled(job, world)
    if job["kind"] == "mesh":
        return list(make_device_mesh(world, job["n"]))
    raise ValueError(f"unknown job {job['kind']!r}")


def _child(spec_path):
    import torch

    from st3d_torch.parallel.sharding import distributed

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    results = []
    with distributed("cpu", init_method="file://" + spec["store"]) as world:
        for job in spec["jobs"]:
            if "raises" not in job:
                results.append(_run(job, world))
                continue
            try:
                _run(job, world)
            except Exception as e:  # the job's expected error, checked below
                if type(e).__name__ != job["raises"]:
                    raise
                results.append(str(e))
            else:
                raise AssertionError(f"{job} did not raise {job['raises']}")
        assert "jax" not in sys.modules, "a rank imported jax"
        path = os.path.join(os.path.dirname(spec_path),
                            f"result{world.rank}.json")
        with open(path, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    _child(sys.argv[1])
