"""Multi-style CLI of the PyTorch/CUDA port: optimise one mesh against
several styles at once, the visibility rasterized once per view batch and
all styles' renders through VGG as one batch (BASELINE config 4).

    python -m st3d_torch.multi_style --obj_path mesh.obj \\
        --style_paths a.png,b.png,c.png --size 512 --n_views 4 \\
        --batch_size 4 --compute_dtype bfloat16 --epochs 500 --device cuda

``--style_paths`` (comma-separated) plus the second approach's flags and
``--device`` (default ``cuda``), as ``multi_style.py`` at the repository
root. Writes ``<output_path>/<style stem>/final.obj`` and
``final_render/`` per style. Under ``torchrun``, ``--data_parallel True``
shards the styles over the ranks.
"""

import argparse

from st3d_torch.engine.config import parse_second_approach
from st3d_torch.engine.multistyle import run_multistyle
from st3d_torch.parallel.sharding import distributed


def split_paths(spec: str):
    return [p for p in spec.split(",") if p]


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--style_paths", default="./imgs/Style_1.jpg", type=str,
                     help="comma-separated style image paths")
    ns, rest = pre.parse_known_args(argv)
    cfg = parse_second_approach(rest)
    with distributed(cfg.device):
        return run_multistyle(cfg, split_paths(ns.style_paths))


if __name__ == "__main__":
    main()
