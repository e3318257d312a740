"""The two pipelines (counterpart of ``st3d/engine/pipelines.py``), for the
texture, mesh and both optimisation targets, in every raster mode.

First approach (``run_first_approach``), per view batch: render the
content, stylise it in 2D (``style_transfer``, hot loop A), write
``2d_style_transfer/view_k.png``, then take ``n_mse_steps`` Adam steps
against the masked MSE to the stylised images. ``log.txt`` holds ``Batch
i, Step s, Loss v`` per MSE step.

Second approach (``run_second_approach``), per view batch, hoisted out of
the epoch loop: the content render and the style/content targets. Per
step: render, composite the background, run VGG-19 to conv5_1 with
in-model Grams, take ``style_content_loss``, backpropagate and let Adam
update the trainable leaves.

The texture target hoists the visibility out of the step loop too
(``precompute_visibility``): the geometry never moves. The mesh and both
targets re-rasterise the view batch every step (``render_rgba``, one
raster launch per step) and add the mesh regularizers after
``main_loss_weight``, as the JAX package does. On a CUDA device every
conv, Gram and raster pass goes through the hand-written kernels
(st3d_torch/kernels).

Second-approach outputs follow the reference layout: ``log.txt``
(``Epoch e, Loss v``),
``metrics.jsonl`` (with ``step_s``, the wall time of the epoch up to a
device synchronisation and a host fetch of its loss), ``current_images/``,
``final_render/view_i.png`` (12 fixed views) and ``final.obj`` (+ .mtl +
texture PNG).
"""

from __future__ import annotations

import math
import os
import time

import torch

from st3d_torch.core.cameras import (
    FoVPerspectiveCameras,
    build_fixed_cameras,
    build_random_cameras,
)
from st3d_torch.core.mesh import Mesh, finalize_mesh
from st3d_torch.engine.background import apply_background
from st3d_torch.engine.config import RASTER_BACKENDS, PipelineConfig
from st3d_torch.engine.optim import apply_params, setup_optimizations
from st3d_torch.engine.style_transfer2d import style_transfer
from st3d_torch.io.image import load_as_tensor, resize_bilinear_chw, save_image
from st3d_torch.io.obj import load_mesh, save_mesh
from st3d_torch.models.vgg import get_features, get_vgg
from st3d_torch.ops.losses import (
    CONTENT_LAYER,
    StyleContentTargets,
    compute_first_approach_loss,
    mesh_regularizer_loss,
    style_content_loss,
)
from st3d_torch.render.rasterize import RasterizationSettings
from st3d_torch.render.renderer import (
    compact_visibility,
    precompute_visibility,
    render_meshes,
    render_rgba,
    render_rgba_static,
    warn_if_hard_k_saturated,
)
from st3d_torch.utils.assets import resolve_asset
from st3d_torch.utils.logging import RunLogger


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; asking for CUDA without a GPU raises (there
    is no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA GPU is available; pass "
            "--device cpu to run the kernels' plain versions")
    return dev


def _check_config(cfg: PipelineConfig) -> None:
    """Raise before any work on a config the port cannot run: ValueError
    for an unknown ``raster_backend`` (every known one takes the port's one
    rasterizer, as st3d/render/rasterize.py::resolve_backend accepts them),
    NotImplementedError for the parts not ported yet."""
    if cfg.raster_backend not in RASTER_BACKENDS:
        raise ValueError(f"unknown rasterizer backend {cfg.raster_backend!r}")
    why = _unsupported(cfg)
    if why:
        raise NotImplementedError(f"st3d_torch does not run {why}")


def _unsupported(cfg: PipelineConfig) -> str:
    """Why ``cfg`` is outside what the port runs yet ('' when it is not)."""
    if cfg.checkpoint_every or cfg.resume:
        return "checkpoints and --resume (not yet ported)"
    if cfg.data_parallel or cfg.tile_parallel:
        return "data/tile parallelism (not yet ported)"
    if cfg.profile or cfg.debug_nan:
        return "--profile and --debug_nan (not yet ported)"
    return ""


def load_scene(cfg: PipelineConfig) -> Mesh:
    """Mesh + texture on the CPU; ``--auto_uv`` synthesizes UVs for a
    UV-less mesh, ``--resize_texture`` resizes the texture to the render
    size, and the mesh and both targets get the regularizers' topology."""
    auto = cfg.auto_uv
    mesh = load_mesh(resolve_asset(cfg.obj_path), require_uvs=(auto == "none"))
    if auto != "none" and mesh.texture.shape[0] <= 2:
        from st3d_torch.core.uv import generate_uvs

        mesh = generate_uvs(mesh, mode=auto, texture_size=cfg.size)
    if cfg.resize_texture and mesh.texture.shape[0] != cfg.size:
        tex = resize_bilinear_chw(mesh.texture.permute(2, 0, 1), cfg.size)
        mesh = mesh.replace(texture=tex.permute(1, 2, 0).contiguous())
    if cfg.optimization_target != "texture":
        mesh = mesh.with_topology()
    return mesh


def build_cameras(cfg: PipelineConfig) -> FoVPerspectiveCameras:
    if cfg.randomize_views:
        return build_random_cameras(cfg.n_views, seed=cfg.seed)
    return build_fixed_cameras(cfg.n_views, seed=cfg.seed)


def _batches(n_views: int, batch_size: int):
    for i in range(math.ceil(n_views / batch_size)):
        yield i, i * batch_size, min((i + 1) * batch_size, n_views)


def save_render(mesh: Mesh, cameras: FoVPerspectiveCameras,
                settings: RasterizationSettings, path: str) -> None:
    """Render every camera and write ``view_{i}.png``."""
    os.makedirs(path, exist_ok=True)
    warn_if_hard_k_saturated(mesh, cameras, settings,
                             context=f"save_render({path})")
    with torch.no_grad():
        imgs, _ = render_meshes(mesh, cameras, settings)
    for i in range(imgs.shape[0]):
        save_image(imgs[i], os.path.join(path, f"view_{i}.png"))


def _settings(cfg: PipelineConfig) -> RasterizationSettings:
    return RasterizationSettings(
        image_size=cfg.size, blur_radius=cfg.blur_radius,
        faces_per_pixel=cfg.faces_per_pixel, soft=cfg.soft_raster,
        soft_sigma_px=cfg.soft_sigma_px, hard_k_slack=cfg.hard_k_slack)


def _compute_dtype(cfg: PipelineConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _finish(cfg: PipelineConfig, content_mesh: Mesh, params,
            settings: RasterizationSettings, device) -> Mesh:
    """Write ``final_render/`` (12 fixed views) and ``final.obj``; returns
    the final clamped mesh."""
    final = finalize_mesh(apply_params(content_mesh, params))
    save_render(final, build_fixed_cameras(12, seed=cfg.seed).to(device),
                settings, os.path.join(cfg.output_path, "final_render"))
    save_mesh(final, os.path.join(cfg.output_path, "final.obj"))
    return final


def run_first_approach(cfg: PipelineConfig) -> Mesh:
    """Stylise each view batch in 2D, then fit the texture to the stylised
    views by masked MSE through the renderer; returns the final (clamped)
    mesh."""
    _check_config(cfg)
    device = resolve_device(cfg.device)
    st_dir = os.path.join(cfg.output_path, "2d_style_transfer")
    os.makedirs(st_dir, exist_ok=True)

    content_mesh = load_scene(cfg).to(device)
    settings = _settings(cfg)
    vgg = get_vgg(cfg.vgg_weights, device=device)
    cameras = build_cameras(cfg).to(device)
    warn_if_hard_k_saturated(content_mesh, cameras[:cfg.batch_size],
                             settings, context="first render")
    params, optimizer = setup_optimizations(cfg.optimization_target,
                                            content_mesh, cfg.mse_lr)
    static_vis = cfg.optimization_target == "texture"
    weights = cfg.loss_weights()
    dtype = _compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    style = load_as_tensor(resolve_asset(cfg.style_path), size=cfg.size)
    logger = RunLogger(cfg.output_path)

    for i, b0, b1 in _batches(cfg.n_views, cfg.batch_size):
        cams_b = cameras[b0:b1]
        style_b = style[None].expand(b1 - b0, -1, -1, -1).to(device)
        with torch.no_grad():
            vis = (compact_visibility(
                precompute_visibility(content_mesh, cams_b, settings))
                if static_vis else None)
            cimgs, cmasks = render_meshes(content_mesh, cams_b, settings)
            content_b = apply_background(cimgs, cmasks,
                                         cfg.content_background, style_b, gen)
            if cfg.style_transfer_init == "noise":
                init = torch.rand(content_b.shape, generator=gen,
                                  dtype=content_b.dtype, device=device)
            elif cfg.style_transfer_init == "content":
                init = content_b
            elif cfg.style_transfer_init == "current":
                cur_imgs, cur_masks = render_meshes(
                    apply_params(content_mesh, params), cams_b, settings)
                init = apply_background(cur_imgs, cur_masks,
                                        cfg.current_background, style_b, gen)
            else:
                raise ValueError(
                    f"unknown style_transfer_init {cfg.style_transfer_init!r}")

        applied = style_transfer(
            init, content_b, style_b, vgg, steps=cfg.n_style_transfer_steps,
            style_weight=cfg.style_weight, content_weight=cfg.content_weight,
            lr=cfg.style_transfer_lr, dtype=dtype).clamp(0.0, 1.0)
        for j in range(b1 - b0):
            save_image(applied[j], os.path.join(
                st_dir, f"view_{i * cfg.batch_size + j}.png"))

        # Hot loop B: the trainable leaves against the stylised views, NHWC.
        target = applied.permute(0, 2, 3, 1)
        losses = []
        for _ in range(cfg.n_mse_steps):
            optimizer.zero_grad(set_to_none=True)
            mesh = apply_params(content_mesh, params)
            rgba = (render_rgba_static(mesh, vis, settings) if static_vis
                    else render_rgba(mesh, cams_b, settings))
            imgs = rgba[..., :3]
            masks = (rgba[..., 3:4] > 0).to(imgs.dtype)
            loss = compute_first_approach_loss(
                imgs, masks, target, mesh.verts, content_mesh.verts, mesh,
                weights, cfg.optimization_target)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        # One host fetch per batch, not one per step.
        for s, value in enumerate(torch.stack(losses).tolist()
                                  if losses else []):
            logger.log_step(i, s, value)

    final = _finish(cfg, content_mesh, params, settings, device)
    logger.close()
    return final


def run_second_approach(cfg: PipelineConfig) -> Mesh:
    """Optimise the trainable leaves against the VGG style/content loss
    (plus the mesh regularizers for the mesh and both targets); returns the
    final (clamped) mesh."""
    _check_config(cfg)
    device = resolve_device(cfg.device)
    os.makedirs(cfg.output_path, exist_ok=True)
    os.makedirs(os.path.join(cfg.output_path, "current_images"),
                exist_ok=True)

    content_mesh = load_scene(cfg).to(device)
    settings = _settings(cfg)
    vgg = get_vgg(cfg.vgg_weights, device=device)
    cameras = build_cameras(cfg).to(device)
    warn_if_hard_k_saturated(content_mesh, cameras[:cfg.batch_size],
                             settings, context="first render")
    params, optimizer = setup_optimizations(cfg.optimization_target,
                                            content_mesh, cfg.lr)
    weights = cfg.loss_weights()
    static_vis = cfg.optimization_target == "texture"
    dtype = _compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    style = load_as_tensor(resolve_asset(cfg.style_path), size=cfg.size)
    content_noise = cfg.content_background == "noise"

    # Per-batch constants, hoisted out of the epoch loop (the visibility
    # only for the texture target).
    batch_const = []
    with torch.no_grad():
        for _, b0, b1 in _batches(cfg.n_views, cfg.batch_size):
            cams_b = cameras[b0:b1]
            style_b = style[None].expand(b1 - b0, -1, -1, -1).to(device)
            cimgs, cmasks = render_meshes(content_mesh, cams_b, settings)
            content_b = cimgs if content_noise else apply_background(
                cimgs, cmasks, cfg.content_background, style_b, gen)
            targets = StyleContentTargets.create(content_b, style_b, vgg,
                                                 dtype=dtype, layout="NHWC")
            vis = (compact_visibility(
                precompute_visibility(content_mesh, cams_b, settings))
                if static_vis else None)
            batch_const.append((cams_b, style_b, cimgs, cmasks, targets,
                                vis))

    logger = RunLogger(cfg.output_path)
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        total = torch.zeros((), device=device)
        for bi, (cams_b, style_b, cimgs, cmasks, targets, vis) in enumerate(
                batch_const):
            optimizer.zero_grad(set_to_none=True)
            mesh = apply_params(content_mesh, params)
            rgba = (render_rgba_static(mesh, vis, settings) if static_vis
                    else render_rgba(mesh, cams_b, settings))
            cur_i = rgba[..., :3]
            cur_m = (rgba[..., 3:4] > 0).to(cur_i.dtype)
            cur = apply_background(cur_i, cur_m, cfg.current_background,
                                   style_b.permute(0, 2, 3, 1), gen)
            feats = get_features(cur, vgg, dtype=dtype, layout="NHWC",
                                 input_layout="NHWC", gram1=True)
            tg = targets
            if content_noise:
                with torch.no_grad():
                    content_b = apply_background(cimgs, cmasks, "noise",
                                                 style_b, gen)
                    cf = get_features(content_b, vgg, dtype=dtype,
                                      layout="NHWC")[CONTENT_LAYER]
                tg = StyleContentTargets(cf, targets.style_grams,
                                         targets.feature_shapes)
            loss = style_content_loss(feats, tg, cfg.style_weight,
                                      cfg.content_weight, layout="NHWC")
            if not static_vis:
                loss = weights["main_loss_weight"] * loss + (
                    mesh_regularizer_loss(mesh, mesh.verts,
                                          content_mesh.verts, weights))
            loss.backward()
            optimizer.step()
            total = total + loss.detach()
            if cfg.save_intermediate:
                frames = cur.detach().clamp(0.0, 1.0).permute(0, 3, 1, 2)
                for j in range(frames.shape[0]):
                    save_image(frames[j], os.path.join(
                        cfg.output_path, "current_images",
                        f"view_{bi * cfg.batch_size + j}.png"))
        loss_value = float(total)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        logger.log_epoch(epoch, loss_value,
                         step_s=time.perf_counter() - t0)

    final = _finish(cfg, content_mesh, params, settings, device)
    logger.close()
    return final
