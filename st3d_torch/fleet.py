"""Fleet CLI of the PyTorch/CUDA port: every mesh x every style (BASELINE
config 5).

    python -m st3d_torch.fleet --obj_paths a.obj,b.obj \\
        --style_paths s1.png,s2.png --size 512 --n_views 4 --batch_size 4 \\
        --compute_dtype bfloat16 --epochs 300 --device cuda \\
        --output_path ./output_fleet

``--fleet_mode batched`` (the default) runs the whole grid as one
optimisation (``engine/fleetbatch.py``: meshes padded and stacked, one
raster launch over all meshes' views, all M x S x B renders through VGG as
one batch); ``--fleet_mode sequential`` runs the multi-style engine per
mesh into ``<output_path>/<mesh stem>``. Either way each cell lands in
``<output_path>/<mesh>/<style>/``. UV-less meshes get spherical auto-UVs
unless ``--auto_uv`` says otherwise. The second approach's flags and
``--device`` (default ``cuda``) apply, as in ``fleet.py`` at the
repository root. Under ``torchrun``, ``--data_parallel True`` shards the
grid over the ranks (``engine/fleetbatch.py``).
"""

import argparse
import dataclasses
import os

from st3d_torch.engine.config import parse_second_approach
from st3d_torch.engine.fleetbatch import run_fleet_batched
from st3d_torch.engine.multistyle import run_multistyle, stem
from st3d_torch.io.obj import load_obj
from st3d_torch.multi_style import split_paths
from st3d_torch.parallel.sharding import distributed
from st3d_torch.utils.assets import resolve_asset


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--obj_paths", default="./objects/cow_mesh/cow.obj",
                     type=str, help="comma-separated OBJ paths")
    pre.add_argument("--style_paths", default="./imgs/Style_1.jpg", type=str,
                     help="comma-separated style image paths")
    pre.add_argument("--fleet_mode", default="batched",
                     choices=("batched", "sequential"),
                     help="batched: one optimisation over the mesh x style "
                     "grid; sequential: the multi-style engine per mesh")
    ns, rest = pre.parse_known_args(argv)
    cfg = parse_second_approach(rest, entry="the fleet")
    with distributed(cfg.device):
        return _run(cfg, ns.fleet_mode, split_paths(ns.obj_paths),
                    split_paths(ns.style_paths))


def _run(cfg, fleet_mode, obj_paths, style_paths):
    if fleet_mode == "batched":
        return run_fleet_batched(cfg, obj_paths, style_paths)

    results = {}
    for obj in obj_paths:
        sub = dataclasses.replace(
            cfg, obj_path=obj,
            output_path=os.path.join(cfg.output_path, stem(obj)))
        if sub.auto_uv == "none":
            data = load_obj(resolve_asset(obj))
            if data.verts_uvs is None or not data.texture_images:
                sub = dataclasses.replace(sub, auto_uv="sphere")
        print(f"=== {stem(obj)}: {len(style_paths)} styles ===")
        results[stem(obj)] = run_multistyle(sub, style_paths)
    return results


if __name__ == "__main__":
    main()
