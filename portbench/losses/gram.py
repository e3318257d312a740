"""The Gram style loss with the conv4_2 content loss (Gatys et al., the
reference repository's second approach), as the benchmark holds a
configuration whose ``model`` section names ``"loss": "gram"``.

Taps: the pre-ReLU maps of conv1_1, conv2_1, conv3_1, conv4_1 and conv5_1
(style) and conv4_2 (content), so the reference's VGG-19 runs to conv5_1.
A Gram is the unnormalised ``F^T F`` of a tap's (pixels, C) map, per
image; in a lower ``precision`` every Gram takes rounded operands.

Targets, per view batch of ``n`` views: the content render's conv4_2 map
and the style image's Grams, one per view. The loss: the content term is
the mean squared difference of conv4_2 against the content render's; the
style term sums over the style taps the mean squared difference of the
Grams against the style image's, each divided by ``C**2 * H**2`` (the
tap's height squared, not H*W); the loss is ``content_weight * content +
style_weight * style``.

First step: ``gram_diff``, over the style taps (and styles), the largest
``||G - G_ref|| / ||G_ref||`` of the first step's style Grams (every view
of the first batch), as the port's VGG returns them to its loss (its
``get_features`` gives them as ``"<tap>:gram"``). The Grams are VGG's
forward alone: their gap follows the precision of its convolutions and
Grams, where the gradient's gap also carries the render's float32
arithmetic against the reference's float64 and answers to a coarser
format by a factor of 2 to 4 only.

Work: each style tap's Gram of its (pixels, C) map is ``2 * pixels *
C**2`` FLOPs, and its backward, ``dF = F (dG + dG^T)``, as many again:
``69,632 * H * W`` an image. It runs with its tap's conv, so its bytes (the
map and the (C, C) result, and their gradients) count in that layer.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench import work
from portbench.reference.precision import grad_operand, operand

STYLE_TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
CONTENT_TAP = "conv4_2"
TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2", "conv5_1")
FLAGS = ("style_weight", "content_weight")
FIRST_STEP = "gram_diff"


def gram(f: torch.Tensor, fmt: str = "float32") -> torch.Tensor:
    """(B, C, C) unnormalised Grams of maps (B, C, H, W)."""
    m = operand(f.flatten(2), fmt)
    return grad_operand(torch.bmm(m, m.transpose(1, 2)), fmt)


def style_content(cur: Dict[str, torch.Tensor], content: torch.Tensor,
                  style_grams: Dict[str, torch.Tensor], style_weight: float,
                  content_weight: float, fmt: str = "float32"
                  ) -> torch.Tensor:
    c_loss = torch.mean((cur[CONTENT_TAP] - content) ** 2)
    s_loss = 0.0
    for t in STYLE_TAPS:
        f = cur[t]
        g = gram(f, fmt)
        c, h = f.shape[1], f.shape[2]
        s_loss = s_loss + torch.mean((g - style_grams[t]) ** 2) / (
            float(c) ** 2 * float(h) ** 2)
    return content_weight * c_loss + style_weight * s_loss


def targets(style: Dict[str, torch.Tensor], content: Dict[str, torch.Tensor],
            n: int, fmt: str):
    """A batch's targets: ``content``'s conv4_2 and ``style``'s Grams, one
    per view of the ``n``."""
    return (content[CONTENT_TAP],
            {t: gram(style[t], fmt).expand(n, -1, -1) for t in STYLE_TAPS})


def loss(cur: Dict[str, torch.Tensor], target, cell: dict, fmt: str
         ) -> torch.Tensor:
    content, grams = target
    return style_content(cur, content, grams, cell["style_weight"],
                         cell["content_weight"], fmt)


def first_step(cur: Dict[str, torch.Tensor], fmt: str
               ) -> Dict[str, torch.Tensor]:
    """The first step's style Grams (B, C, C) of each style tap, on the
    host."""
    return {t: gram(cur[t], fmt).cpu() for t in STYLE_TAPS}


def port_first_step(feats: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The same, from what the port's ``get_features`` returned."""
    return {k.split(":")[0]: v.detach().float().cpu()
            for k, v in feats.items() if k.endswith(":gram")}


def _taps() -> Dict[str, Tuple[int, int]]:
    """{conv: (Cout, downscale)}."""
    return {n: (co, s) for n, _, co, s in work.vgg_layers() if co}


def flops(h: int, w: int) -> float:
    """FLOPs of one image's five style Grams, forward and backward."""
    taps = _taps()
    return float(sum(4 * (h // taps[t][1]) * (w // taps[t][1])
                     * taps[t][0] ** 2 for t in STYLE_TAPS))


def layer_work(h: int, w: int, dtype: str) -> Dict[str, Tuple[int, int]]:
    """{style tap: (FLOPs, bytes)} of its Gram, forward and backward, which
    count in the tap's conv layer."""
    nb = work.DTYPE_BYTES[dtype]
    out = {}
    for t, (co, s) in _taps().items():
        if t in STYLE_TAPS:
            px = (h // s) * (w // s)
            out[t] = (4 * px * co * co, nb * 2 * px * co + 4 * 2 * co * co)
    return out
