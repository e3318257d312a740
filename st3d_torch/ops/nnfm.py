"""ARF's nearest-neighbour feature matching loss (Zhang et al., "ARF:
Artistic Radiance Fields", ECCV 2022, arXiv:2206.06360; its released
``nnfm_loss.py``), the second approach's ``--loss nnfm``.

F, S and C are VGG-16's conv3 block (relu3_1, relu3_2, relu3_3
concatenated over channels: 768 of them at P = (H/4)(W/4) positions; the
port's VGG-19 shares those seven convs) of the render, the style image and
the content render of the unmoved mesh. Matching, with no gradient: each
side centred over its own positions and its rows normalised, nn(i) =
argmax_j F̂_i · Ŝ_j, the lowest j on a tie (``models/vgg.py`` runs it inside
the VGG call, ``kernels/nnfm.py::match``). The loss:

    style_weight * mean_i [1 - <F_i / (|F_i| + 1e-8), S_nn(i) / (|S_nn(i)|
    + 1e-8)>] + content_weight * mean((F - C)^2),

the gradient through F only (``kernels/nnfm.py::loss_rows``). The style's
block is computed once a style (``style_target``), the content's once a
view batch (``content_target``). Departures from ARF, as the benchmark's
reference states them: the raw [0, 1] image goes into VGG without
ImageNet's normalisation, as the port's Gram loss takes it; no
total-variation term (ARF regularises a voxel grid with it; a UV texture
has no counterpart).
"""

from __future__ import annotations

import dataclasses

import torch

from st3d_torch.kernels import nnfm as knnfm
from st3d_torch.models.vgg import VGG19, get_features
from st3d_torch.utils import trace


@dataclasses.dataclass
class StyleTarget:
    """A style's block, once: its matching operand (centred, normalised,
    split for the tensor cores) and its rows over their norms, which the
    loss gathers."""

    operand: knnfm.StyleOperand
    unit: torch.Tensor


def style_target(style_img: torch.Tensor, model: VGG19,
                 dtype: torch.dtype = torch.float32) -> StyleTarget:
    """The target of one style image (1, 3, H, W) in [0, 1]."""
    with torch.no_grad():
        s = get_features(style_img[:1], model, dtype=dtype,
                         relu3=True)["relu3"]
        hat = knnfm.center_normalize(s)
        unit = s[0] / (torch.sqrt((s[0] * s[0]).sum(-1, keepdim=True))
                       + knnfm.EPS)
    return StyleTarget(knnfm.style_operand(hat), unit.contiguous())


def content_target(content_imgs: torch.Tensor, model: VGG19,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The content renders' blocks (B, P, 768), from (B, 3, H, W)."""
    with torch.no_grad():
        return get_features(content_imgs, model, dtype=dtype,
                            relu3=True)["relu3"]


@trace.spanned("loss")
def nnfm_loss(feats, content: torch.Tensor, style: StyleTarget,
              style_weight: float, content_weight: float) -> torch.Tensor:
    """The loss of ``get_features(..., nnfm=style.operand)``'s ``feats``
    against the content blocks (B, P, C)."""
    f = feats["relu3"]
    c = f.shape[-1]
    f = f.reshape(-1, c)
    m = f.shape[0]
    rows = knnfm.loss_rows(f, style.unit, content.reshape(-1, c),
                           feats["relu3:nn"].reshape(-1),
                           style_weight / m, content_weight / (m * c))
    return rows.sum()
