"""First approach CLI of the PyTorch/CUDA port: stylise rendered views in
2D, then fit the texture to them by masked MSE through the renderer.

    python -m st3d_torch.first_approach --obj_path mesh.obj \\
        --style_path style.png --size 512 --n_views 4 --batch_size 4 \\
        --compute_dtype bfloat16 --device cuda

Same flags and defaults as ``first_approach.py`` at the repository root,
plus ``--device`` (default ``cuda``).
"""

from st3d_torch.engine.config import parse_first_approach
from st3d_torch.engine.pipelines import run_first_approach


def main(argv=None):
    cfg = parse_first_approach(argv)
    return run_first_approach(cfg)


if __name__ == "__main__":
    main()
