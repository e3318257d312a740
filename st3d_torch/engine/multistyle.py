"""Multi-style optimisation: one mesh, S styles, jointly (counterpart of
``st3d/engine/multistyle.py``; BASELINE config 4).

The geometry is shared, so the visibility pass runs once per view batch at
set-up (``precompute_visibility`` + ``compact_visibility``, one raster
launch) and every style's texture is sampled against the same fragments
(``shade_compact_styles``: one gather and one scatter for all S); all
S x B renders go through VGG-19 as one batch; the per-style losses touch
disjoint texels, so one Adam over the stacked (S, H, W, 3) atlas optimises
every style at once, as S separate runs would.

Outputs: ``output_path/<style_stem>/final.obj`` (+ .mtl, texture PNG) and
``final_render/`` per style, a shared ``log.txt`` with the summed loss per
epoch, and ``metrics.jsonl`` with the ``per_style`` losses and ``step_s``.
``--checkpoint_every``, ``--resume``, ``--debug_nan`` and ``--profile``
act as in the second approach.

With ``--data_parallel`` in a world of W ranks the style axis shards over
them (``parallel/grid.py``): rank r owns a contiguous block of S/W styles,
their textures, Adam moments and Gram targets, and the W must divide S.
The visibility and the content features are computed on every rank. The
cells' leaves are disjoint, so no gradient crosses ranks; the summed loss
and the per-style losses are gathered for the logs, and checkpoints hold
every style, as the unsharded run writes them.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Sequence

import torch

from st3d_torch.core.cameras import build_fixed_cameras
from st3d_torch.core.mesh import Mesh, finalize_mesh
from st3d_torch.engine.config import PipelineConfig
from st3d_torch.engine.pipelines import (
    CHECKPOINT,
    _batches,
    _check_config,
    _compute_dtype,
    build_cameras,
    load_scene,
    maybe_profile,
    nan_check,
    profile_spans,
    save_render,
)
from st3d_torch.io.image import load_as_tensor
from st3d_torch.io.obj import save_mesh
from st3d_torch.models.vgg import get_features, get_vgg
from st3d_torch.ops.losses import CONTENT_LAYER, STYLE_LAYERS, gram_matrix_nhwc
from st3d_torch.parallel.grid import CellGrid
from st3d_torch.parallel.sharding import (
    World,
    current_world,
    make_view_parallel_step,
    replicate,
)
from st3d_torch.render.rasterize import RasterizationSettings
from st3d_torch.render.renderer import (
    compact_visibility,
    precompute_visibility,
    render_meshes,
)
from st3d_torch.render.shading import shade_compact_styles
from st3d_torch.utils import trace
from st3d_torch.utils.assets import resolve_asset
from st3d_torch.utils.checkpoint import restore, save_checkpoint
from st3d_torch.utils.logging import RunLogger

# Downsampling of each style tap below the input image (VGG's pools floor).
TAP_SCALE = {"conv1_1": 1, "conv2_1": 2, "conv3_1": 4, "conv4_1": 8,
             "conv5_1": 16}


def stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


@trace.spanned("loss")
def _multi_style_content_loss(feats, content_features, style_grams,
                              style_weight, content_weight, image_h):
    """Per-style reference loss on features with leading axes (a style
    axis, and a mesh axis before it in the fleet).

    feats: {layer: (..., B, H, W, C)} NHWC taps in the compute dtype, or
    ``"<layer>:gram"`` (..., B, C, C) float32 Grams (``get_features``
    ``gram1=True``); content_features (B, H, W, C), or broadcastable to the
    content tap; style_grams {layer: (..., B, C, C)} broadcastable to the
    Grams. Returns the (...) per-cell losses. A ``:gram`` key's divisor
    height is ``image_h // scale``, the floor the maxpools take (the JAX
    code's), in float (int32 would overflow at 768²).
    """
    cur = feats[CONTENT_LAYER].float()
    content = torch.mean((cur - content_features.float()) ** 2,
                         dim=(-4, -3, -2, -1))
    style = 0.0
    for layer in STYLE_LAYERS:
        if layer + ":gram" in feats:
            g = feats[layer + ":gram"]
            c, h = g.shape[-1], image_h // TAP_SCALE[layer]
        else:
            f = feats[layer]
            c, h = f.shape[-1], f.shape[-3]
            g = gram_matrix_nhwc(f.reshape((-1,) + f.shape[-3:])).reshape(
                f.shape[:-3] + (c, c))
        style = style + torch.mean((g - style_grams[layer]) ** 2,
                                   dim=(-3, -2, -1)) / (
                                       float(c) ** 2 * float(h) ** 2)
    return content_weight * content + style_weight * style


def style_gram_targets(styles: torch.Tensor, batch: int, vgg,
                       dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{layer: (S, B, C, C)} Gram targets of the (S, 3, H, W) style images,
    each repeated over a view batch of ``batch`` as the JAX package runs
    VGG on them (S x B images in one batch)."""
    s, _, h, w = styles.shape
    with torch.no_grad():
        feats = get_features(
            styles[:, None].expand(s, batch, 3, h, w).reshape(
                s * batch, 3, h, w), vgg, dtype=dtype, layout="NHWC")
        grams = {}
        for layer in STYLE_LAYERS:
            g = gram_matrix_nhwc(feats[layer])
            grams[layer] = g.reshape(s, batch, g.shape[-1], g.shape[-1])
    return grams


def load_styles(paths: Sequence[str], size: int, device) -> torch.Tensor:
    return torch.stack([load_as_tensor(resolve_asset(p), size)
                        for p in paths]).to(device)


def textured_step(cfg: PipelineConfig, vgg, dtype, textures, vis, cfeat,
                  grams):
    """The per-cell losses (G, S) of one view batch: every texture of
    ``textures`` (G, S, Ht, Wt, 3) shaded against the batch's compact
    visibility ``vis`` (``mask`` (G, B, H, W); ``group``, each covered
    pixel's mesh, where G > 1), all G x S x B renders through VGG-19 as
    one batch, each cell against its mesh's content features ``cfeat``
    (G, B, H, W, C) and its style's Grams."""
    with trace.span("render"):
        rgb = shade_compact_styles(textures, vis["cov_idx"], vis["uv_cov"],
                                   vis["mask"], vis.get("group"))
    lead = rgb.shape[:3]
    feats = get_features(rgb.reshape((-1,) + rgb.shape[3:]), vgg,
                         dtype=dtype, layout="NHWC", input_layout="NHWC",
                         gram1=True)
    feats = {k: v.reshape(lead + v.shape[1:]) for k, v in feats.items()}
    return _multi_style_content_loss(feats, cfeat[:, None], grams,
                                     cfg.style_weight, cfg.content_weight,
                                     cfg.size)


def optimise_cells(cfg: PipelineConfig, epochs: int, world: World,
                   grid: CellGrid, vgg, dtype, textures: torch.Tensor,
                   batch_const, key: str, names: Sequence[str]
                   ) -> torch.Tensor:
    """Adam on this rank's block ``textures`` (mb, sb, Ht, Wt, 3) of
    ``grid`` over ``batch_const`` [(vis, cfeat, grams)] of its cells for
    ``epochs`` epochs (from the checkpoint with ``--resume``): ``log.txt``
    gets the summed loss of each epoch, ``metrics.jsonl`` the per-cell
    losses under ``key`` by the real cells' ``names`` (M x S of them) and
    ``step_s``. Padded cells are masked to zero loss. Returns every real
    cell's optimised texture, (M, S, Ht, Wt, 3), on every rank."""
    device = world.device
    with trace.span("setup"):
        params = {"textures": textures.detach().clone(
            memory_format=torch.contiguous_format).requires_grad_(True)}
        with trace.span("setup.optim"):
            optimizer = torch.optim.Adam(list(params.values()), lr=cfg.lr)
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        ckpt = os.path.join(cfg.output_path, CHECKPOINT)
        with trace.span("setup.restore"):
            start_epoch, _ = restore(cfg.resume, ckpt, params, optimizer,
                                     gen, leaf_in=grid.block_of_array)
        logger = RunLogger(cfg.output_path, active=world.main)
        stop_profile = maybe_profile(cfg, device, world)
        mask = grid.mask(device) if grid.padded else None

    def loss_fn(vis, cfeat, grams):
        per_cell = textured_step(cfg, vgg, dtype, params["textures"], vis,
                                 cfeat, grams)
        if mask is not None:
            per_cell = per_cell * mask
        return per_cell.sum(), per_cell

    # Each rank's leaves are its own: the gradients stay local.
    step = make_view_parallel_step(loss_fn, optimizer, params, None,
                                   has_aux=True, check=nan_check(cfg, world))
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        cells = torch.zeros((grid.mb, grid.sb), device=device)
        for bi, (vis, cfeat, grams) in enumerate(batch_const):
            _, per_cell = step(vis, cfeat, grams,
                               label=f"epoch {epoch}, batch {bi}")
            cells = cells + per_cell.detach()
        with trace.span("epoch_end"):
            trace.count("epochs")
            cells = grid.gather(cells)
            values = cells.flatten().tolist()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            logger.log_epoch(epoch, float(cells.sum()),
                             **{key: dict(zip(names, values))},
                             step_s=time.perf_counter() - t0)
            if cfg.checkpoint_every and (epoch + 1) % (
                    cfg.checkpoint_every) == 0:
                save_checkpoint(ckpt, epoch + 1, params, optimizer, gen,
                                write=world.main, leaf_out=grid.gather)
    stop_profile()
    logger.close()
    # Every rank renders rank 0's cells (ranks that each ran the whole grid
    # may differ in the last bits on the card).
    textures = grid.gather(params["textures"].detach()).contiguous()
    replicate([textures], world)
    return textures


def write_cell(cfg: PipelineConfig, mesh: Mesh, texture: torch.Tensor,
               out_dir: str, settings: RasterizationSettings,
               world: World) -> Mesh:
    """``out_dir/final_render/`` (12 fixed views) and ``out_dir/final.obj``
    of ``mesh`` with ``texture``; returns the finalised mesh. Every rank
    calls it (the render may be banded over the ranks); rank 0 writes."""
    final = finalize_mesh(mesh.replace(texture=texture))
    save_render(final, build_fixed_cameras(12, seed=cfg.seed).to(
        texture.device), settings, os.path.join(out_dir, "final_render"),
        tile_parallel=cfg.tile_parallel, world=world)
    if world.main:
        save_mesh(final, os.path.join(out_dir, "final.obj"))
    return final


def run_multistyle(cfg: PipelineConfig, style_paths: Sequence[str],
                   epochs: int = None) -> Dict[str, Mesh]:
    """Second-approach optimisation of one texture per style, jointly;
    returns {style_stem: final mesh}."""
    epochs = epochs if epochs is not None else cfg.epochs
    _check_config(cfg)
    world = current_world(cfg.device)
    profile_spans(cfg, world)
    device = world.device
    names = [stem(p) for p in style_paths]
    grid = (CellGrid.styles(world, len(names))
            if cfg.data_parallel and world.sharded
            else CellGrid.whole(1, len(names)))
    if world.main:
        os.makedirs(cfg.output_path, exist_ok=True)

    # The set-up's second part, up to the first step, is optimise_cells'.
    with trace.span("setup"):
        with trace.span("setup.scene"):
            mesh = load_scene(cfg).to(device)
        settings = RasterizationSettings(image_size=cfg.size)
        with trace.span("setup.vgg"):
            vgg = get_vgg(cfg.vgg_weights, device=device)
        cameras = build_cameras(cfg).to(device)
        dtype = _compute_dtype(cfg)
        with trace.span("setup.targets"):
            styles = load_styles([style_paths[j] for j in grid.style_ids()],
                                 cfg.size, device)

        # Per-batch constants: the compact visibility, the content
        # features (shared by every style) and this rank's styles' Gram
        # targets.
        batch_const = []
        with torch.no_grad():
            for _, b0, b1 in _batches(cfg.n_views, cfg.batch_size):
                cams_b = cameras[b0:b1]
                with trace.span("setup.targets"):
                    content_imgs, _ = render_meshes(mesh, cams_b, settings)
                    cfeat = get_features(content_imgs, vgg, dtype=dtype,
                                         layout="NHWC")[CONTENT_LAYER]
                with trace.span("setup.visibility"):
                    vis = compact_visibility(
                        precompute_visibility(mesh, cams_b, settings))
                with trace.span("setup.targets"):
                    grams = style_gram_targets(styles, b1 - b0, vgg, dtype)
                batch_const.append((
                    {k: (v[None] if k == "mask" else v)
                     for k, v in vis.items()}, cfeat[None], grams))

        textures = mesh.texture[None, None].expand(
            (1, grid.sb) + tuple(mesh.texture.shape))
    textures = optimise_cells(cfg, epochs, world, grid, vgg, dtype, textures,
                              batch_const, "per_style", names)[0]
    return {name: write_cell(cfg, mesh, textures[s],
                             os.path.join(cfg.output_path, name), settings,
                             world)
            for s, name in enumerate(names)}
