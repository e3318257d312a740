"""Batched multi-mesh x multi-style optimisation on one device
(counterpart of ``st3d/engine/fleetbatch.py``; BASELINE config 5: M
meshes x S styles in one run).

  * meshes are padded to common budgets (``core/uv.py::pad_mesh``) and
    stacked on a mesh axis; padding faces have zero area, so every
    rasterizer drops them and a mesh's visibility is bit-identical to its
    unpadded one's;
  * the mesh axis folds into the rasterizer's view axis: the visibility of
    a view batch is one ``rasterize_batch`` launch over M x B views
    (``fleet_visibility``), once at set-up (textures are the only
    trainable leaves);
  * every (mesh, style) texture is shaded against its mesh's fragments in
    one gather (``shade_compact_styles``), and all M x S x B renders go
    through VGG-19 as one batch;
  * every cell owns a disjoint atlas, so one Adam over the stacked
    (M, S, H, W, 3) leaf advances the grid as M x S separate runs would.

Outputs: ``output_path/<mesh>/<style>/final.obj`` and ``final_render/``
per cell, written with the unpadded geometry; ``log.txt`` with the summed
loss and ``metrics.jsonl`` with the ``per_cell`` losses.

With ``--data_parallel`` in a world of W ranks the grid shards over a
``dm x ds`` grid of the ranks (``_pick_grid``; ``parallel/grid.py``): rank
r owns the cells of block ``(r // ds, r % ds)``, its meshes' visibility
(one ``fleet_visibility`` launch) and content features and its styles'
Gram targets. An axis that the ranks do not divide is padded by repeating
its first mesh or style, and the padded cells are masked to zero loss.
Checkpoints hold the real M x S grid, so a run resumes under any world.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence

import torch

from st3d_torch.core.cameras import transform_points_screen
from st3d_torch.core.mesh import Mesh
from st3d_torch.core.uv import pad_mesh
from st3d_torch.engine.config import PipelineConfig
from st3d_torch.engine.multistyle import (
    load_styles,
    optimise_cells,
    stem,
    style_gram_targets,
    write_cell,
)
from st3d_torch.engine.pipelines import (
    _batches,
    _check_config,
    _compute_dtype,
    build_cameras,
    load_scene,
    profile_spans,
)
from st3d_torch.models.vgg import get_features, get_vgg
from st3d_torch.ops.losses import CONTENT_LAYER
from st3d_torch.parallel.grid import CellGrid, _pad_axis, _pick_grid  # noqa: F401
from st3d_torch.parallel.sharding import current_world
from st3d_torch.render.rasterize import RasterizationSettings, rasterize_batch
from st3d_torch.render.renderer import compact_visibility, render_meshes
from st3d_torch.render.shading import pixel_uvs
from st3d_torch.utils import trace


def _load_fleet_meshes(cfg: PipelineConfig,
                       obj_paths: Sequence[str]) -> List[Mesh]:
    """Every mesh, on the CPU; a UV-less one (``load_mesh``'s ValueError)
    is loaded again with spherical auto-UVs, as the sequential fleet
    does."""
    meshes = []
    for obj in obj_paths:
        sub = dataclasses.replace(cfg, obj_path=obj)
        try:
            meshes.append(load_scene(sub))
        except ValueError:
            if sub.auto_uv != "none":
                raise
            meshes.append(
                load_scene(dataclasses.replace(sub, auto_uv="sphere")))
    return meshes


def fleet_visibility(meshes: Sequence[Mesh], padded: Sequence[Mesh],
                     cameras, settings: RasterizationSettings
                     ) -> Dict[str, torch.Tensor]:
    """Hard visibility of every mesh of the fleet in a view batch: each
    mesh's own vertices projected, gathered by its ``padded`` faces (the
    padding faces index vertex 0), and the mesh axis folded into the view
    axis: one ``rasterize_batch`` launch over M x B views. (Projecting the
    padded vertex array instead would round differently: a matmul's
    rounding may change with its row count.) Returns ``p2f`` and ``zbuf``
    (M, B, H, W), ``mask`` (M, B, H, W), and the covered pixels of every
    mesh in one list: ``cov_idx`` (flat indices into their mesh's B*H*W
    frame), ``group`` (their mesh) and ``uv_cov`` (their UVs)."""
    m, b, s = len(padded), len(cameras), settings.image_size
    with torch.no_grad():
        fv = torch.cat([transform_points_screen(cameras, x.verts, (s, s))[
            :, p.faces] for x, p in zip(meshes, padded)])
        frags = rasterize_batch(fv, settings)
        p2f = frags.pix_to_face.reshape(m, b, s, s)
        covs, groups, uvs, masks = [], [], [], []
        for g, x in enumerate(padded):
            uv, mask = pixel_uvs(fv[g * b:(g + 1) * b], p2f[g],
                                 x.verts_uvs, x.faces_uvs)
            cvis = compact_visibility({"uv": uv, "mask": mask})
            covs.append(cvis["cov_idx"])
            groups.append(torch.full_like(cvis["cov_idx"], g))
            uvs.append(cvis["uv_cov"])
            masks.append(mask)
    return {"p2f": p2f, "zbuf": frags.zbuf.reshape(m, b, s, s),
            "mask": torch.stack(masks), "cov_idx": torch.cat(covs),
            "group": torch.cat(groups), "uv_cov": torch.cat(uvs)}


def run_fleet_batched(cfg: PipelineConfig, obj_paths: Sequence[str],
                      style_paths: Sequence[str], epochs: int = None
                      ) -> Dict[str, Dict[str, Mesh]]:
    """Optimise one texture per (mesh, style) cell, jointly; returns
    {mesh_stem: {style_stem: final mesh}}."""
    epochs = epochs if epochs is not None else cfg.epochs
    _check_config(cfg)
    world = current_world(cfg.device)
    profile_spans(cfg, world)
    device = world.device
    mesh_names = [stem(p) for p in obj_paths]
    style_names = [stem(p) for p in style_paths]
    if len(set(mesh_names)) != len(mesh_names):
        raise ValueError(f"duplicate mesh stems in {mesh_names}")
    if len(set(style_names)) != len(style_names):
        raise ValueError(f"duplicate style stems in {style_names}")
    grid = (CellGrid.fleet(world, len(mesh_names), len(style_names))
            if cfg.data_parallel and world.sharded
            else CellGrid.whole(len(mesh_names), len(style_names)))
    if world.main:
        os.makedirs(cfg.output_path, exist_ok=True)

    # The set-up's second part, up to the first step, is optimise_cells'.
    with trace.span("setup"):
        with trace.span("setup.scene"):
            meshes = [m.to(device)
                      for m in _load_fleet_meshes(cfg, obj_paths)]
            padded = [pad_mesh(m, max(x.verts.shape[0] for x in meshes),
                               max(x.faces.shape[0] for x in meshes),
                               num_uvs=max(x.verts_uvs.shape[0]
                                           for x in meshes),
                               texture_size=max(x.texture.shape[0]
                                                for x in meshes))
                      for m in meshes]
        # The step shades from compact visibility, which needs hard K = 1
        # rasterization: refuse the rest rather than optimise another
        # objective than run_second_approach would for the same cfg.
        if cfg.soft_raster or cfg.blur_radius > 0 or cfg.faces_per_pixel > 1:
            raise ValueError(
                "fleet_mode=batched requires hard K=1 rasterization "
                f"(got soft_raster={cfg.soft_raster}, "
                f"blur_radius={cfg.blur_radius}, "
                f"faces_per_pixel={cfg.faces_per_pixel}); use the "
                "multi-style or second-approach entry points for soft or "
                "blurred rasterization.")
        settings = RasterizationSettings(image_size=cfg.size)
        with trace.span("setup.vgg"):
            vgg = get_vgg(cfg.vgg_weights, device=device)
        cameras = build_cameras(cfg).to(device)
        dtype = _compute_dtype(cfg)
        rows, cols = grid.mesh_ids(), grid.style_ids()
        with trace.span("setup.targets"):
            styles = load_styles([style_paths[j] for j in cols], cfg.size,
                                 device)

        # Per-batch constants of this rank's cells: its meshes' visibility
        # and content features and its styles' Gram targets.
        batch_const = []
        with torch.no_grad():
            for _, b0, b1 in _batches(cfg.n_views, cfg.batch_size):
                cams_b = cameras[b0:b1]
                with trace.span("setup.visibility"):
                    vis = fleet_visibility([meshes[i] for i in rows],
                                           [padded[i] for i in rows],
                                           cams_b, settings)
                with trace.span("setup.targets"):
                    cfeat = torch.stack([
                        get_features(render_meshes(padded[i], cams_b,
                                                   settings)[0],
                                     vgg, dtype=dtype,
                                     layout="NHWC")[CONTENT_LAYER]
                        for i in rows])
                    grams = style_gram_targets(styles, b1 - b0, vgg, dtype)
                batch_const.append((vis, cfeat, grams))

        textures = torch.stack([
            padded[i].texture[None].expand((len(cols),)
                                           + tuple(padded[i].texture.shape))
            for i in rows])
    textures = optimise_cells(
        cfg, epochs, world, grid, vgg, dtype, textures, batch_const,
        "per_cell", [f"{m}/{s}" for m in mesh_names for s in style_names])
    return {mn: {sn: write_cell(cfg, meshes[mi], textures[mi, si],
                                os.path.join(cfg.output_path, mn, sn),
                                settings, world)
                 for si, sn in enumerate(style_names)}
            for mi, mn in enumerate(mesh_names)}
