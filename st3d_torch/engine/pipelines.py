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
update the trainable leaves. With ``--loss nnfm`` the targets are the
style's conv3 block (once) and each batch's content blocks, VGG runs to
conv3_3 and matches the render's block to the style's inside the call,
and the loss is ``ops/nnfm.py::nnfm_loss``.

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

Under ``torchrun`` (a world of W > 1 ranks, ``st3d_torch/parallel``),
``--data_parallel`` shards each view batch over the ranks: rank r takes
views ``[r·B/W, (r+1)·B/W)`` of the second approach's step and of the
first approach's MSE phase, every gradient and loss is averaged over the
ranks, and the leaves stay replicated; hot loop A runs unsharded on rank
0, which broadcasts the stylised views. ``--tile_parallel`` bands the
final render's rows over the ranks (``save_render``). In a world of 1
both flags run the plain path, as the JAX package does on one device.
Only rank 0 writes files; every rank reads a checkpoint.

As in the JAX package, both pipelines write ``checkpoint.npz``
(``utils/checkpoint.py``): the second approach every ``checkpoint_every``
epochs, the first approach after every view batch and, with
``checkpoint_every``, every that many MSE steps within a batch (with the
step reached and the batch's stylised targets, so that a resume neither
re-runs the style transfer nor over-optimises the batch). ``--resume``
continues from it, the generator state included, with a fresh ``log.txt``
that holds only the resumed steps. ``--debug_nan`` checks each step's loss,
gradients and updated leaves (``utils/debug.py``), and ``--profile``
traces the optimisation loop with ``torch.profiler`` into
``output_path/profile/``.

Every entry runs in named spans (``utils/trace.py``, off unless
``--profile`` or ``portbench/spans.py`` turns them on): ``st3d.setup``
from the entry to its first step, with ``setup.scene``, ``setup.vgg``,
``setup.optim``, ``setup.targets``, ``setup.visibility`` and
``setup.restore`` inside;
``st3d.step`` with its ``forward`` (``render``, ``vgg``, ``loss``),
``backward``, ``optim`` and, under ``--debug_nan``, ``check``;
``st3d.epoch_end`` (the loss fetch, the sync, the log, the checkpoint);
``st3d.stylise`` (hot loop A); ``st3d.kernels.load``. ``--profile``'s
``trace.json`` holds them beside the kernels, and ``spans.json`` holds
every span and counter (``steps``, ``epochs``, ``kernels.loaded``,
``kernels.built``).
"""

from __future__ import annotations

import functools
import math
import os
import time

import numpy as np
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
from st3d_torch.models.vgg import BLOCK3_CONVS, get_features, get_vgg
from st3d_torch.ops import nnfm as nnfm_ops
from st3d_torch.ops.losses import (
    CONTENT_LAYER,
    StyleContentTargets,
    compute_first_approach_loss,
    mesh_regularizer_loss,
    style_content_loss,
)
from st3d_torch.parallel.sharding import (
    World,
    current_world,
    gather_cat,
    make_view_parallel_step,
    replicate,
    resolve_device,  # noqa: F401  (the entry points' device check)
    shard_views,
    view_block,
)
from st3d_torch.parallel.tiles import render_meshes_tiled
from st3d_torch.render.rasterize import RasterizationSettings
from st3d_torch.render.renderer import (
    compact_visibility,
    precompute_visibility,
    render_meshes,
    render_rgba,
    render_rgba_static,
    warn_if_hard_k_saturated,
)
from st3d_torch.utils import trace
from st3d_torch.utils.assets import resolve_asset
from st3d_torch.utils.checkpoint import restore, save_checkpoint
from st3d_torch.utils.debug import check_finite
from st3d_torch.utils.logging import RunLogger

CHECKPOINT = "checkpoint.npz"


def _check_config(cfg: PipelineConfig, nnfm_ok: bool = False) -> None:
    """Raise ValueError before any work for an unknown ``raster_backend``
    (every known one takes the port's one rasterizer, as
    st3d/render/rasterize.py::resolve_backend accepts them), and for
    ``--loss nnfm`` where the entry (``nnfm_ok`` false) or
    ``--data_parallel`` does not run it (the parsers refuse it first)."""
    if cfg.raster_backend not in RASTER_BACKENDS:
        raise ValueError(f"unknown rasterizer backend {cfg.raster_backend!r}")
    if cfg.loss != "gram" and (not nnfm_ok or cfg.data_parallel):
        raise ValueError(f"--loss {cfg.loss} runs in the second approach's "
                         "plain entry only")


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
                settings: RasterizationSettings, path: str,
                tile_parallel: bool = False, world: World = None) -> None:
    """Render every camera and write ``view_{i}.png`` (rank 0). With
    ``tile_parallel`` in a world of several ranks the rows are banded over
    the ranks (``parallel/tiles.py``), so every rank must call it;
    otherwise rank 0 renders alone."""
    world = world or World()
    tiled = tile_parallel and world.sharded
    if not (tiled or world.main):
        return
    if world.main:
        os.makedirs(path, exist_ok=True)
        warn_if_hard_k_saturated(mesh, cameras, settings,
                                 context=f"save_render({path})")
    with torch.no_grad():
        imgs, _ = (render_meshes_tiled(mesh, cameras, settings, world)
                   if tiled else render_meshes(mesh, cameras, settings))
    if world.main:
        for i in range(imgs.shape[0]):
            save_image(imgs[i], os.path.join(path, f"view_{i}.png"))


def _settings(cfg: PipelineConfig) -> RasterizationSettings:
    return RasterizationSettings(
        image_size=cfg.size, blur_radius=cfg.blur_radius,
        faces_per_pixel=cfg.faces_per_pixel, soft=cfg.soft_raster,
        soft_sigma_px=cfg.soft_sigma_px, hard_k_slack=cfg.hard_k_slack)


def _compute_dtype(cfg: PipelineConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def profile_spans(cfg: PipelineConfig, world: World = None) -> None:
    """With ``--profile``, turn the port's spans on (rank 0) from the
    entry on, so that ``spans.json`` holds the set-up by phase, which the
    profiler, started after set-up, does not see."""
    if cfg.profile and (world or World()).main:
        trace.enable()


def maybe_profile(cfg: PipelineConfig, device: torch.device,
                  world: World = None):
    """With ``--profile``, start a ``torch.profiler`` trace (CPU, and CUDA
    on a GPU) on rank 0 and return the function that stops it and writes
    ``output_path/profile/trace.json`` (Chrome trace format, with the
    port's ``st3d.*`` spans), ``device_ms.json``, the device milliseconds
    of each kernel over the traced span (``profile_step.kernel_ms``), and
    ``spans.json``, every span since the entry and the counters on the
    trace's clock (``utils/trace.py``), and turns the spans off; without
    it, a no-op."""
    if not cfg.profile or not (world or World()).main:
        return lambda: None
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CPU] + ([act.CUDA] if device.type == "cuda" else []))
    prof.start()

    def stop():
        import json

        from st3d_torch.profile_step import kernel_ms

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        out = os.path.join(cfg.output_path, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        with open(os.path.join(out, "device_ms.json"), "w") as f:
            json.dump(kernel_ms(prof.events(), 1), f, indent=1)
        trace.write(os.path.join(out, "spans.json"))
        trace.disable()

    return stop


def nan_check(cfg: PipelineConfig, world: World):
    """With ``--debug_nan``, the step's check of its loss, gradients and
    updated leaves (``check_finite``, one host synchronisation each; every
    rank of ``world`` stops together); else None."""
    if not cfg.debug_nan:
        return None
    return functools.partial(check_finite, world=world)


def view_noise_seeds(seed: int, step: int, n_views: int) -> np.ndarray:
    """The noise seeds of a data-parallel step, one per view: ``seed + step
    * 131071 + arange(B)`` as uint32 (st3d/engine/pipelines.py:848-851)."""
    return ((seed + step * 131071 + np.arange(n_views, dtype=np.int64))
            & 0xFFFFFFFF).astype(np.uint32)


def noise_generators(seed: int, device) -> tuple:
    """The two noise streams of a shard whose first view's seed is
    ``seed``: the current background's, seeded with it, and the content
    background's, derived from it as ``fold_in(key, 1)`` is in the JAX
    package (the 1 in the seed's high word)."""
    return (torch.Generator(device=device).manual_seed(int(seed)),
            torch.Generator(device=device).manual_seed(int(seed) + (1 << 32)))


def _finish(cfg: PipelineConfig, content_mesh: Mesh, params,
            settings: RasterizationSettings, world: World) -> Mesh:
    """Write ``final_render/`` (12 fixed views) and ``final.obj``; returns
    the final clamped mesh. Every rank renders rank 0's leaves."""
    with torch.no_grad():
        replicate(params.values(), world)
    final = finalize_mesh(apply_params(content_mesh, params))
    save_render(final, build_fixed_cameras(12, seed=cfg.seed).to(
        world.device), settings, os.path.join(cfg.output_path,
                                              "final_render"),
        tile_parallel=cfg.tile_parallel, world=world)
    if world.main:
        save_mesh(final, os.path.join(cfg.output_path, "final.obj"))
    return final


def _stylise(cfg: PipelineConfig, content_mesh: Mesh, params, cams_b,
             style_b: torch.Tensor, settings: RasterizationSettings,
             vgg, gen: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """The first approach's 2D targets of a view batch: render the content,
    composite its background, pick the init and run hot loop A; (B, 3, H,
    W) in [0, 1]."""
    device = style_b.device
    with torch.no_grad():
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
    return style_transfer(
        init, content_b, style_b, vgg, steps=cfg.n_style_transfer_steps,
        style_weight=cfg.style_weight, content_weight=cfg.content_weight,
        lr=cfg.style_transfer_lr, dtype=dtype).clamp(0.0, 1.0)


def _data_parallel(cfg: PipelineConfig, world: World) -> bool:
    """Whether the view batches shard over the ranks: ``--data_parallel``
    in a world of several, where every view batch must divide the ranks
    (``view_block``'s ValueError otherwise)."""
    if not (cfg.data_parallel and world.sharded):
        return False
    for _, b0, b1 in _batches(cfg.n_views, cfg.batch_size):
        view_block(b1 - b0, world)
    return True


def run_first_approach(cfg: PipelineConfig) -> Mesh:
    """Stylise each view batch in 2D, then fit the texture to the stylised
    views by masked MSE through the renderer; returns the final (clamped)
    mesh."""
    _check_config(cfg)
    world = current_world(cfg.device)
    profile_spans(cfg, world)
    device = world.device
    use_dp = _data_parallel(cfg, world)
    st_dir = os.path.join(cfg.output_path, "2d_style_transfer")
    if world.main:
        os.makedirs(st_dir, exist_ok=True)

    with trace.span("setup"):
        with trace.span("setup.scene"):
            content_mesh = load_scene(cfg).to(device)
        settings = _settings(cfg)
        with trace.span("setup.vgg"):
            vgg = get_vgg(cfg.vgg_weights, device=device)
        cameras = build_cameras(cfg).to(device)
        warn_if_hard_k_saturated(content_mesh, cameras[:cfg.batch_size],
                                 settings, context="first render")
        with trace.span("setup.optim"):
            params, optimizer = setup_optimizations(
                cfg.optimization_target, content_mesh, cfg.mse_lr)
        static_vis = cfg.optimization_target == "texture"
        weights = cfg.loss_weights()
        dtype = _compute_dtype(cfg)
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        with trace.span("setup.targets"):
            style = load_as_tensor(resolve_asset(cfg.style_path),
                                   size=cfg.size)
        ckpt = os.path.join(cfg.output_path, CHECKPOINT)
        with trace.span("setup.restore"):
            start_batch, extras = restore(cfg.resume, ckpt, params,
                                          optimizer, gen)
        logger = RunLogger(cfg.output_path, active=world.main)
        stop_profile = maybe_profile(cfg, device, world)

    def mse_loss(cams, target, vis):
        mesh = apply_params(content_mesh, params)
        rgba = (render_rgba_static(mesh, vis, settings) if static_vis
                else render_rgba(mesh, cams, settings))
        imgs = rgba[..., :3]
        masks = (rgba[..., 3:4] > 0).to(imgs.dtype)
        return compute_first_approach_loss(
            imgs, masks, target, mesh.verts, content_mesh.verts, mesh,
            weights, cfg.optimization_target)

    # Hot loop B over this rank's views (all of them without data
    # parallelism): the masked MSE is a batch mean and the regularizers
    # are the same on every rank, so the averaged loss is the batch's.
    mse_step = make_view_parallel_step(mse_loss, optimizer, params,
                                       world if use_dp else None,
                                       check=nan_check(cfg, world))
    for i, b0, b1 in _batches(cfg.n_views, cfg.batch_size):
        if i < start_batch:
            continue
        cams_b = cameras[b0:b1]
        if i == start_batch and "mse_done" in extras:
            # A mid-batch checkpoint: continue the MSE steps against the
            # stored stylised targets.
            done = int(extras["mse_done"])
            applied = torch.from_numpy(extras["applied"]).to(device)
        else:
            # Hot loop A runs unsharded: rank 0 stylises the whole batch
            # and the others receive its views.
            if world.main:
                style_b = style[None].expand(b1 - b0, -1, -1, -1).to(device)
                with trace.span("stylise"):
                    applied = _stylise(cfg, content_mesh, params, cams_b,
                                       style_b, settings, vgg, gen, dtype)
                for j in range(b1 - b0):
                    save_image(applied[j], os.path.join(
                        st_dir, f"view_{i * cfg.batch_size + j}.png"))
            else:
                applied = torch.empty((b1 - b0, 3, cfg.size, cfg.size),
                                      device=device)
            replicate([applied], world)
            done = 0

        # NHWC targets of this rank's views.
        target = applied.permute(0, 2, 3, 1)
        if use_dp:
            cams_b, target = cams_b[view_block(b1 - b0, world)], shard_views(
                target, world)
        with torch.no_grad():
            vis = (compact_visibility(
                precompute_visibility(content_mesh, cams_b, settings))
                if static_vis else None)
        pending = []
        while done < cfg.n_mse_steps:
            pending.append(mse_step(cams_b, target, vis,
                                    label=f"batch {i}, step {done}"))
            done += 1
            mid_batch = (cfg.checkpoint_every and done < cfg.n_mse_steps
                         and done % cfg.checkpoint_every == 0)
            if mid_batch or done == cfg.n_mse_steps:
                # One host fetch per checkpoint or batch, not one per step;
                # log.txt covers every step up to the checkpoint a resume
                # would continue from.
                for s, value in enumerate(torch.stack(pending).tolist()):
                    logger.log_step(i, done - len(pending) + s, value)
                pending.clear()
            if mid_batch:
                save_checkpoint(ckpt, i, params, optimizer, gen,
                                extras={"mse_done": done, "applied": applied},
                                write=world.main)
        save_checkpoint(ckpt, i + 1, params, optimizer, gen,
                        write=world.main)

    stop_profile()
    final = _finish(cfg, content_mesh, params, settings, world)
    logger.close()
    return final


def run_second_approach(cfg: PipelineConfig) -> Mesh:
    """Optimise the trainable leaves against the VGG style/content loss
    (plus the mesh regularizers for the mesh and both targets); returns the
    final (clamped) mesh."""
    _check_config(cfg, nnfm_ok=True)
    world = current_world(cfg.device)
    profile_spans(cfg, world)
    device = world.device
    use_dp = _data_parallel(cfg, world)
    if world.main:
        os.makedirs(os.path.join(cfg.output_path, "current_images"),
                    exist_ok=True)

    with trace.span("setup"):
        with trace.span("setup.scene"):
            content_mesh = load_scene(cfg).to(device)
        settings = _settings(cfg)
        nnfm = cfg.loss == "nnfm"
        with trace.span("setup.vgg"):
            vgg = get_vgg(cfg.vgg_weights, device=device,
                          convs=BLOCK3_CONVS if nnfm else None)
        cameras = build_cameras(cfg).to(device)
        warn_if_hard_k_saturated(content_mesh, cameras[:cfg.batch_size],
                                 settings, context="first render")
        with trace.span("setup.optim"):
            params, optimizer = setup_optimizations(
                cfg.optimization_target, content_mesh, cfg.lr)
        weights = cfg.loss_weights()
        static_vis = cfg.optimization_target == "texture"
        dtype = _compute_dtype(cfg)
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        with trace.span("setup.targets"):
            style = load_as_tensor(resolve_asset(cfg.style_path),
                                   size=cfg.size)
            # NNFM: the style's block once, not once a view.
            style_block = (nnfm_ops.style_target(style[None].to(device), vgg,
                                                 dtype) if nnfm else None)
        content_noise = cfg.content_background == "noise"
        noise = content_noise or cfg.current_background == "noise"

        # Per-batch constants, hoisted out of the epoch loop (the
        # visibility only for the texture target), each cut to this rank's
        # views under data parallelism.
        batch_const = []
        with torch.no_grad():
            for _, b0, b1 in _batches(cfg.n_views, cfg.batch_size):
                cams_b = cameras[b0:b1]
                with trace.span("setup.targets"):
                    style_b = style[None].expand(b1 - b0, -1, -1, -1).to(
                        device)
                    cimgs, cmasks = render_meshes(content_mesh, cams_b,
                                                  settings)
                    content_b = cimgs if content_noise else apply_background(
                        cimgs, cmasks, cfg.content_background, style_b, gen)
                    targets = (
                        nnfm_ops.content_target(content_b, vgg, dtype)
                        if nnfm else StyleContentTargets.create(
                            content_b, style_b, vgg, dtype=dtype,
                            layout="NHWC"))
                if use_dp:
                    cams_b = cams_b[view_block(b1 - b0, world)]
                    style_b, cimgs, cmasks = shard_views(
                        (style_b, cimgs, cmasks), world)
                    targets = StyleContentTargets(
                        shard_views(targets.content_features, world),
                        shard_views(targets.style_grams, world),
                        targets.feature_shapes)
                with trace.span("setup.visibility"):
                    vis = (compact_visibility(
                        precompute_visibility(content_mesh, cams_b, settings))
                        if static_vis else None)
                batch_const.append((cams_b, style_b, cimgs, cmasks, targets,
                                    vis))

        def loss_fn(cams_b, style_b, cimgs, cmasks, targets, vis, g_cur,
                    g_content):
            mesh = apply_params(content_mesh, params)
            rgba = (render_rgba_static(mesh, vis, settings) if static_vis
                    else render_rgba(mesh, cams_b, settings))
            cur_i = rgba[..., :3]
            cur_m = (rgba[..., 3:4] > 0).to(cur_i.dtype)
            cur = apply_background(cur_i, cur_m, cfg.current_background,
                                   style_b.permute(0, 2, 3, 1), g_cur)
            content_b = None
            if content_noise:
                with torch.no_grad():
                    content_b = apply_background(cimgs, cmasks, "noise",
                                                 style_b, g_content)
            if nnfm:
                feats = get_features(cur, vgg, dtype=dtype,
                                     input_layout="NHWC",
                                     nnfm=style_block.operand)
                content = targets if content_b is None else (
                    nnfm_ops.content_target(content_b, vgg, dtype))
                loss = nnfm_ops.nnfm_loss(feats, content, style_block,
                                          cfg.style_weight,
                                          cfg.content_weight)
            else:
                feats = get_features(cur, vgg, dtype=dtype, layout="NHWC",
                                     input_layout="NHWC", gram1=True)
                tg = targets
                if content_b is not None:
                    with torch.no_grad():
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
            return loss, cur

        step = make_view_parallel_step(loss_fn, optimizer, params,
                                       world if use_dp else None,
                                       has_aux=True,
                                       check=nan_check(cfg, world))
        ckpt = os.path.join(cfg.output_path, CHECKPOINT)
        with trace.span("setup.restore"):
            start_epoch, _ = restore(cfg.resume, ckpt, params, optimizer,
                                     gen)
        # Data-parallel noise comes from seeds of the global step index,
        # which a resume continues (the plain path's generator is
        # checkpointed).
        step_counter = start_epoch * len(batch_const)
        logger = RunLogger(cfg.output_path, active=world.main)
        stop_profile = maybe_profile(cfg, device, world)
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        total = torch.zeros((), device=device)
        for bi, const in enumerate(batch_const):
            g_cur = g_content = gen
            if use_dp and noise:
                # Shard r draws from the first seed of its block of views.
                n_local = len(const[0])
                seeds = view_noise_seeds(cfg.seed, step_counter,
                                         n_local * world.size)
                g_cur, g_content = noise_generators(
                    seeds[world.rank * n_local], device)
            loss, cur = step(*const, g_cur, g_content,
                             label=f"epoch {epoch}, batch {bi}")
            step_counter += 1
            total = total + loss
            if cfg.save_intermediate:
                frames = cur.detach().clamp(0.0, 1.0).permute(0, 3, 1, 2)
                if use_dp:
                    frames = gather_cat(frames, world)
                if world.main:
                    for j in range(frames.shape[0]):
                        save_image(frames[j], os.path.join(
                            cfg.output_path, "current_images",
                            f"view_{bi * cfg.batch_size + j}.png"))
        with trace.span("epoch_end"):
            trace.count("epochs")
            loss_value = float(total)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            logger.log_epoch(epoch, loss_value,
                             step_s=time.perf_counter() - t0)
            if cfg.checkpoint_every and (epoch + 1) % (
                    cfg.checkpoint_every) == 0:
                save_checkpoint(ckpt, epoch + 1, params, optimizer, gen,
                                write=world.main)

    stop_profile()
    final = _finish(cfg, content_mesh, params, settings, world)
    logger.close()
    return final
