"""Pipeline configuration and the argument parsers of both approaches
(counterpart of ``st3d/engine/config.py``): the same flag names and
defaults, plus ``--device``.

Boolean flags accept true/false/1/0/yes/no and reject anything else.
``--loss`` picks the perceptual loss: ``gram`` (the reference's, the
default) or ``nnfm`` (ARF's nearest-neighbour feature matching,
``ops/nnfm.py``), which only the second approach's plain entry runs: the
first approach, multi-style, the fleet and ``--data_parallel`` refuse it
while parsing.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional

# The JAX package's rasterizer backends (st3d/render/rasterize.py::
# resolve_backend). The port accepts each and runs its one rasterizer.
RASTER_BACKENDS = ("auto", "pallas", "xla", "bruteforce")


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = v.strip().lower()
    if s in ("true", "1", "yes", "y"):
        return True
    if s in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


@dataclasses.dataclass
class PipelineConfig:
    # --- shared flags (reference names/defaults) ---
    n_views: int = 6
    obj_path: str = "./objects/cow_mesh/cow.obj"
    style_path: str = "./imgs/Style_1.jpg"
    style_weight: float = 1e6
    content_weight: float = 1.0
    loss: str = "gram"                    # gram | nnfm
    resize_texture: bool = True
    size: int = 768
    output_path: str = "./output"
    batch_size: int = 4
    content_background: str = "white"    # noise | style | white
    current_background: str = "white"
    randomize_views: bool = True
    optimization_target: str = "texture"  # texture | mesh | both
    main_loss_weight: float = 3.0
    mesh_edge_loss_weight: float = 1.0
    mesh_laplacian_smoothing_weight: float = 1.0
    mesh_normal_consistency_weight: float = 1.0
    mesh_verts_weight: float = 1.0
    # --- first approach ---
    n_mse_steps: int = 100
    n_style_transfer_steps: int = 3000
    style_transfer_init: str = "content"  # noise | current | content
    style_transfer_lr: float = 0.01
    mse_lr: float = 0.01
    # --- second approach ---
    epochs: int = 3000
    lr: float = 0.01
    # --- framework additions (not in the reference) ---
    seed: int = 0
    raster_backend: str = "auto"
    soft_raster: bool = False
    faces_per_pixel: int = 1
    soft_sigma_px: float = 1.0
    blur_radius: float = 0.0
    hard_k_slack: int = 4
    vgg_weights: Optional[str] = None
    auto_uv: str = "none"                 # none | sphere | face_atlas
    save_intermediate: bool = True
    checkpoint_every: int = 0
    resume: bool = False
    profile: bool = False
    debug_nan: bool = False
    compute_dtype: str = "float32"        # float32 | bfloat16
    data_parallel: bool = False
    tile_parallel: bool = False
    device: str = "cuda"                  # cuda | cpu

    def loss_weights(self) -> Dict[str, float]:
        return {
            "mesh_edge_loss_weight": self.mesh_edge_loss_weight,
            "mesh_laplacian_smoothing_weight":
                self.mesh_laplacian_smoothing_weight,
            "mesh_normal_consistency_weight":
                self.mesh_normal_consistency_weight,
            "mesh_verts_weight": self.mesh_verts_weight,
            "main_loss_weight": self.main_loss_weight,
        }


def _add_shared(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n_views", default=6, type=int,
                   help="Number of views considered by the renderer")
    p.add_argument("--obj_path", default="./objects/cow_mesh/cow.obj",
                   type=str, help="Path to the object")
    p.add_argument("--style_path", default="./imgs/Style_1.jpg", type=str,
                   help="Path to the style image")
    p.add_argument("--style_weight", default=1e6, type=float,
                   help="Weight of the style loss")
    p.add_argument("--content_weight", default=1.0, type=float,
                   help="Weight of the content loss")
    p.add_argument("--loss", default="gram", type=str,
                   choices=["gram", "nnfm"],
                   help="perceptual loss: the Gram style loss with the "
                   "conv4_2 content loss, or ARF's NNFM on VGG-16's conv3 "
                   "block")
    p.add_argument("--resize_texture", default=True, type=_str2bool,
                   help="Whether to resize the texture to the image size")
    p.add_argument("--size", default=768, type=int,
                   help="Dimension of the images")
    p.add_argument("--batch_size", default=4, type=int, help="Batch size")
    p.add_argument("--content_background", default="white", type=str,
                   choices=["noise", "style", "white"])
    p.add_argument("--current_background", default="white", type=str,
                   choices=["noise", "style", "white"])
    p.add_argument("--randomize_views", default=True, type=_str2bool,
                   help="Whether or not to randomize views")
    p.add_argument("--optimization_target", default="texture", type=str,
                   choices=["texture", "mesh", "both"])
    p.add_argument("--main_loss_weight", default=3.0, type=float)
    p.add_argument("--mesh_edge_loss_weight", default=1.0, type=float)
    p.add_argument("--mesh_laplacian_smoothing_weight", default=1.0,
                   type=float)
    p.add_argument("--mesh_normal_consistency_weight", default=1.0,
                   type=float)
    p.add_argument("--mesh_verts_weight", default=1.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--raster_backend", default="auto", type=str,
                   choices=list(RASTER_BACKENDS),
                   help="accepted for flag parity; the port has one "
                   "rasterizer (kernel K1, its plain version on the CPU)")
    p.add_argument("--soft_raster", default=False, type=_str2bool)
    p.add_argument("--soft_sigma_px", default=1.0, type=float)
    p.add_argument("--faces_per_pixel", default=1, type=int)
    p.add_argument("--blur_radius", default=0.0, type=float)
    p.add_argument("--hard_k_slack", default=4, type=int)
    p.add_argument("--vgg_weights", default=None, type=str)
    p.add_argument("--auto_uv", default="none", type=str,
                   choices=["none", "sphere", "face_atlas"])
    p.add_argument("--save_intermediate", default=True, type=_str2bool)
    p.add_argument("--checkpoint_every", default=0, type=int)
    p.add_argument("--resume", default=False, type=_str2bool)
    p.add_argument("--profile", default=False, type=_str2bool)
    p.add_argument("--debug_nan", default=False, type=_str2bool)
    p.add_argument("--compute_dtype", default="float32", type=str,
                   choices=["float32", "bfloat16"])
    p.add_argument("--data_parallel", default=False, type=_str2bool)
    p.add_argument("--tile_parallel", default=False, type=_str2bool)
    p.add_argument("--device", default="cuda", type=str,
                   choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels and raises "
                   "without a GPU; cpu runs their plain versions")


def parse_first_approach(argv=None) -> PipelineConfig:
    p = argparse.ArgumentParser(description="first approach (2D ST -> MSE)")
    _add_shared(p)
    p.add_argument("--n_mse_steps", default=100, type=int)
    p.add_argument("--n_style_transfer_steps", default=3000, type=int)
    p.add_argument("--output_path", default="./output_first", type=str)
    p.add_argument("--style_transfer_init", default="content", type=str,
                   choices=["noise", "current", "content"])
    p.add_argument("--style_transfer_lr", default=0.01, type=float)
    p.add_argument("--mse_lr", default=0.01, type=float)
    return _parsed(p, argv, "the first approach")


def parse_second_approach(argv=None, entry: str = "") -> PipelineConfig:
    """The second approach's flags; ``entry`` names an entry point that
    runs them without ``--loss nnfm`` (``multi-style``, ``the fleet``)."""
    p = argparse.ArgumentParser(description="second approach (perceptual)")
    _add_shared(p)
    p.add_argument("--epochs", default=3000, type=int)
    p.add_argument("--output_path", default="./output_second", type=str)
    p.add_argument("--lr", default=0.01, type=float)
    return _parsed(p, argv, entry)


def _parsed(p: argparse.ArgumentParser, argv, entry: str) -> PipelineConfig:
    """Parse; ``--loss nnfm`` exits through ``p.error`` under ``entry`` (an
    entry point without it) or with ``--data_parallel``."""
    cfg = PipelineConfig(**vars(p.parse_args(argv)))
    if cfg.loss == "nnfm":
        if entry:
            p.error(f"argument --loss: {entry} runs the Gram loss only, "
                    "not nnfm")
        if cfg.data_parallel:
            p.error("argument --loss: nnfm does not run with "
                    "--data_parallel")
    return cfg
