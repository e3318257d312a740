"""First approach CLI of the PyTorch/CUDA port: stylise rendered views in
2D, then fit the texture to them by masked MSE through the renderer.

    python -m st3d_torch.first_approach --obj_path mesh.obj \\
        --style_path style.png --size 512 --n_views 4 --batch_size 4 \\
        --compute_dtype bfloat16 --device cuda

Same flags and defaults as ``first_approach.py`` at the repository root,
plus ``--device`` (default ``cuda``). Under ``torchrun``
(``python -m torch.distributed.run --standalone --nproc_per_node N -m
st3d_torch.first_approach ... --data_parallel True``) each rank joins the
world (``parallel/sharding.py::init_world``) and the group is destroyed on
exit.
"""

from st3d_torch.engine.config import parse_first_approach
from st3d_torch.engine.pipelines import run_first_approach
from st3d_torch.parallel.sharding import distributed


def main(argv=None):
    cfg = parse_first_approach(argv)
    with distributed(cfg.device):
        return run_first_approach(cfg)


if __name__ == "__main__":
    main()
