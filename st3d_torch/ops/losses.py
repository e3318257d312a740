"""Style/content perceptual loss and the first approach's masked MSE
(counterpart of ``st3d/ops/losses.py``, texture target).

Reference quirks kept exactly: the Gram is UNNORMALISED, the per-layer
style divisor is ``C**2 * H**2`` (height squared, not H*W), computed in
float, and the content loss is a plain mean MSE on conv4_2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from st3d_torch.core.mesh import Mesh
from st3d_torch.kernels.conv import gram_nhwc_diff
from st3d_torch.models.vgg import VGG19, get_features

STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
CONTENT_LAYER = "conv4_2"


def gram_matrix_nhwc(tensor: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) taps in any dtype -> (B, C, C) float32 Grams, taken from
    the tap in its own dtype with float32 accumulation (kernel K3 on CUDA
    tensors)."""
    return gram_nhwc_diff(tensor)


def gram_matrix(tensor: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C), unnormalised."""
    return gram_matrix_nhwc(tensor.permute(0, 2, 3, 1))


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error (torch.nn.functional.mse_loss, mean reduction)."""
    return torch.mean((a - b) ** 2)


@dataclasses.dataclass
class StyleContentTargets:
    """Precomputed optimisation targets: conv4_2 content features and the
    style Grams, hoisted out of the step loop."""

    content_features: torch.Tensor
    style_grams: Dict[str, torch.Tensor]
    feature_shapes: Dict[str, tuple]

    @classmethod
    def create(cls, content_imgs: torch.Tensor, style_imgs: torch.Tensor,
               model: VGG19, dtype: torch.dtype = torch.float32,
               layout: str = "NCHW") -> "StyleContentTargets":
        """Targets from NCHW content and style images; ``layout="NHWC"``
        keeps the content features NHWC in the compute dtype."""
        with torch.no_grad():
            content = get_features(content_imgs, model, dtype=dtype,
                                   layout=layout)[CONTENT_LAYER]
            style = get_features(style_imgs, model, dtype=dtype,
                                 layout=layout)
            if layout == "NHWC":
                grams = {l: gram_matrix_nhwc(style[l]) for l in STYLE_LAYERS}
            else:
                grams = {l: gram_matrix(style[l]) for l in STYLE_LAYERS}
        shapes = {l: tuple(style[l].shape) for l in STYLE_LAYERS}
        return cls(content_features=content, style_grams=grams,
                   feature_shapes=shapes)


def style_content_loss(current_features: Dict[str, torch.Tensor],
                       targets: StyleContentTargets,
                       style_weight: float = 1e6,
                       content_weight: float = 1.0,
                       layout: str = "NCHW") -> torch.Tensor:
    """content_weight * Lc + style_weight * Ls with the reference formulas.
    ``layout`` must match the features' and targets' layout."""
    cur = current_features[CONTENT_LAYER].float()
    tgt = targets.content_features.float()
    content_loss = mse_loss(cur, tgt)
    style_loss = 0.0
    for layer in STYLE_LAYERS:
        if layer + ":gram" in current_features:
            g = current_features[layer + ":gram"]
            shape = targets.feature_shapes[layer]
            c, h = ((shape[3], shape[1]) if layout == "NHWC"
                    else (shape[1], shape[2]))
        elif layout == "NHWC":
            feat = current_features[layer]
            c, h = feat.shape[3], feat.shape[1]
            g = gram_matrix_nhwc(feat)
        else:
            feat = current_features[layer]
            c, h = feat.shape[1], feat.shape[2]
            g = gram_matrix(feat)
        layer_loss = torch.mean((g - targets.style_grams[layer]) ** 2)
        style_loss = style_loss + layer_loss / (float(c) ** 2 * float(h) ** 2)
    return content_weight * content_loss + style_weight * style_loss


def compute_perceptual_loss(current_imgs: torch.Tensor,
                            content_imgs: torch.Tensor,
                            style_imgs: torch.Tensor, model: VGG19,
                            style_weight: float = 1e6,
                            content_weight: float = 1.0) -> torch.Tensor:
    """Reference-signature perceptual loss on NCHW images: the targets and
    the current features are all extracted here (float32, NCHW taps).
    Prefer ``StyleContentTargets`` hoisted out of a step loop."""
    if not (current_imgs.shape[0] == content_imgs.shape[0]
            == style_imgs.shape[0]):
        raise ValueError("current, content and style batches differ in size")
    targets = StyleContentTargets.create(content_imgs, style_imgs, model)
    return style_content_loss(get_features(current_imgs, model), targets,
                              style_weight, content_weight)


def compute_first_approach_loss(rendered: torch.Tensor, masks: torch.Tensor,
                                target_rendered: torch.Tensor,
                                verts: torch.Tensor,
                                target_verts: torch.Tensor, mesh: Mesh,
                                weights: Dict[str, float],
                                opt_type: str) -> torch.Tensor:
    """Masked MSE against the 2D-stylized targets. For the texture target
    ``main_loss_weight`` is ignored, as in the reference; the mesh and both
    targets add the mesh regularizers, which are not ported yet."""
    if opt_type in ("mesh", "both"):
        raise NotImplementedError(
            f"opt_type={opt_type!r}: the mesh regularizers are ROADMAP queue "
            "1 item 11")
    if opt_type != "texture":
        raise ValueError(f"unknown opt_type {opt_type!r}")
    return mse_loss(rendered * masks, target_rendered * masks)
