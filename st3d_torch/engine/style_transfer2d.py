"""The 2D neural style transfer of the first approach, "hot loop A"
(counterpart of ``st3d/engine/style_transfer2d.py``): Adam directly on the
pixels against the content loss (conv4_2 MSE) plus the Gram style loss.

As in the JAX package, the targets are computed once
(``StyleContentTargets.create(..., layout="NHWC")``), the pixel buffer and
Adam's state stay NHWC float32 for the whole loop (Adam is elementwise, so
the trajectory is the NCHW one transposed), and each step runs
``get_features(gram1=True)``: on the default route that is the stage-1
kernels, then K2/K3. The loop is a plain Python loop; the JAX package's
executable cache and ``lax.scan`` chunks have no counterpart here. The
result is not clamped (the caller clamps).
"""

from __future__ import annotations

import torch

from st3d_torch.models.vgg import VGG19, get_features
from st3d_torch.ops.losses import StyleContentTargets, style_content_loss


def style_transfer(initial_optimized_imgs: torch.Tensor,
                   content_imgs: torch.Tensor, style_imgs: torch.Tensor,
                   model: VGG19, steps: int = 2000,
                   style_weight: float = 1e6, content_weight: float = 1.0,
                   lr: float = 0.003,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Optimise a copy of ``initial_optimized_imgs`` (B, 3, H, W) toward the
    style of ``style_imgs`` and the content of ``content_imgs`` (both
    (B, 3, H, W)) for ``steps`` Adam steps; VGG runs in ``dtype``. Returns
    (B, 3, H, W) float32. Reference signature and defaults
    (style_transfer.py:38)."""
    if not (initial_optimized_imgs.shape[0] == content_imgs.shape[0]
            == style_imgs.shape[0]):
        raise ValueError("init, content and style batches differ in size")
    with torch.no_grad():
        targets = StyleContentTargets.create(content_imgs, style_imgs, model,
                                             dtype=dtype, layout="NHWC")
    imgs = (initial_optimized_imgs.detach().float().permute(0, 2, 3, 1)
            .clone(memory_format=torch.contiguous_format)
            .requires_grad_(True))
    optimizer = torch.optim.Adam([imgs], lr=lr)
    for _ in range(steps):
        optimizer.zero_grad(set_to_none=True)
        feats = get_features(imgs, model, dtype=dtype, layout="NHWC",
                             input_layout="NHWC", gram1=True)
        loss = style_content_loss(feats, targets, style_weight,
                                  content_weight, layout="NHWC")
        loss.backward()
        optimizer.step()
    return imgs.detach().permute(0, 3, 1, 2).contiguous()
