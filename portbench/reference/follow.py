"""The reference's second-approach optimisation, followed for a few steps.

The perceptual loss is the configuration's (``loss``, a module of
``portbench/losses/``); VGG runs to the deepest of its ``TAPS``. Per view
batch (views ``[k * batch, (k + 1) * batch)`` of the rig), set up once: the
content render of the unmoved mesh and the loss's ``targets`` from its taps
and the style image's. Each step renders the batch from the current leaves
(the texture target keeps the content mesh's visibility; a vertex target
rasterizes the moved mesh every step), takes the loss (times
``main_loss_weight`` plus the regularizers for a vertex target),
backpropagates to the leaves and takes one Adam step (betas (0.9, 0.999),
eps 1e-8, bias-corrected), batch after batch. ``follow`` returns what a
run is judged by: each epoch's summed loss (and each step's), each leaf's
first gradient (its norm, and the tensor on the host), the norm of its
change after ``change_after`` steps, and the loss's ``first_step``
statistic of the first step's taps, on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import camera, render, vgg
from portbench.reference.loss import Topology, regularizers
from portbench.reference.precision import full_float32


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            self.p[k] -= self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.norm(t.double()))


def follow(inp, style: np.ndarray, cell: dict, loss, seed: int, steps: int,
           change_after: int, device, fmt: str = "float64",
           half_batch: bool = False) -> dict:
    """Follow ``steps`` steps of a run with one style image.

    ``cell``: size, n_views, batch_size, optimization_target, lr, the
    regularizer weights and the loss's ``FLAGS``, as the run was
    configured. ``fmt`` is the arithmetic (``precision``'s formats);
    ``half_batch`` keeps only the first half of each batch's views, the
    mean taken over them (a planted fault)."""
    with full_float32():
        return _follow(inp, style, cell, loss, seed, steps, change_after,
                       device, fmt, half_batch)


def _follow(inp, style, cell, loss, seed, steps, change_after, device, fmt,
            half_batch) -> dict:
    size, n_views, bsz = cell["size"], cell["n_views"], cell["batch_size"]
    vertex = cell["optimization_target"] != "texture"
    ft = torch.float64 if fmt == "float64" else torch.float32
    weights = [(k.to(ft), b.to(ft))
               for k, b in vgg.load_weights(inp.vgg, device)]
    R, T = camera.random_rig(n_views, seed)
    R, T = R.to(device), T.to(device)
    verts0 = torch.as_tensor(inp.verts, device=device)
    faces = torch.as_tensor(inp.faces, device=device)
    face_uvs = torch.as_tensor(inp.verts_uvs, device=device)[
        torch.as_tensor(inp.faces_uvs, device=device)]
    tex0 = (torch.as_tensor(inp.texture, device=device).float() / 255.0
            ).to(ft)
    sty = (torch.as_tensor(style, device=device).float() / 255.0).permute(
        2, 0, 1)[None].to(ft)
    face_uvs = face_uvs.to(ft)
    topo = Topology(inp.faces, len(inp.verts), device) if vertex else None

    batches = []
    with torch.no_grad():
        style_taps = vgg.taps(sty, weights, loss.TAPS, fmt)
        for b0 in range(0, n_views, bsz):
            b1 = min(b0 + bsz, n_views)
            if half_batch:
                b1 = b0 + max((b1 - b0) // 2, 1)
            scr = camera.to_screen(verts0, R[b0:b1], T[b0:b1], size)
            p2f = render.rasterize(scr, faces, size)
            img, _ = render.render(scr.to(ft), faces, face_uvs, tex0, size,
                                   p2f)
            target = loss.targets(style_taps,
                                  vgg.taps(img, weights, loss.TAPS, fmt),
                                  b1 - b0, fmt)
            batches.append((b0, b1, p2f, target))

    params = {"texture": tex0.clone()}
    if vertex:
        params["verts"] = verts0.clone()
    start = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, cell["lr"])
    losses: List[float] = []
    first_grad, change, first_step = {}, {}, {}
    for s in range(steps):
        b0, b1, p2f, target = batches[s % len(batches)]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        verts = leaves.get("verts", verts0)
        scr = camera.to_screen(verts, R[b0:b1], T[b0:b1], size)
        if vertex:
            p2f = render.rasterize(scr.detach().float(), faces, size)
        img, _ = render.render(scr.to(ft), faces, face_uvs,
                               leaves["texture"], size, p2f)
        cur = vgg.taps(img, weights, loss.TAPS, fmt)
        value = loss.loss(cur, target, cell, fmt)
        if s == 0:
            with torch.no_grad():
                first_step = loss.first_step(cur, fmt)
        if vertex:
            value = cell["main_loss_weight"] * value + regularizers(
                verts, verts0, topo, cell)
        value.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        if s == 0:
            first_grad = {k: g.detach().cpu() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(value.detach()))
        if s + 1 == change_after:
            change = {k: _norm(params[k] - start[k]) for k in params}
    per_epoch = len(batches)
    epochs = [math.fsum(losses[e:e + per_epoch])
              for e in range(0, len(losses) - per_epoch + 1, per_epoch)]
    return {"epoch_loss": epochs, "step_loss": losses,
            "first_grad": {k: _norm(g) for k, g in first_grad.items()},
            "first_grad_t": first_grad, "change": change,
            "first_step": first_step}
