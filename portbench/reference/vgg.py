"""VGG-19 (Simonyan & Zisserman, arXiv:1409.1556) to conv5_1, with the style
Grams.

Raw [0, 1] RGB in, NCHW; 3x3 convs with padding 1, ReLU, 2x2 max-pools.
The taps are the pre-ReLU outputs of conv1_1, conv2_1, conv3_1, conv4_1,
conv4_2 (content) and conv5_1; the stack stops after conv5_1. Weights come
as HWIO kernels ``conv{i}_kernel`` and biases ``conv{i}_bias``. A Gram is
the unnormalised ``F^T F`` of a tap's (pixels, C) map, per image. In a
lower ``precision`` every conv and Gram takes rounded operands.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.precision import grad_operand, operand

CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
       512, 512, 512, 512, "M", 512)
TAPS = {0: "conv1_1", 2: "conv2_1", 4: "conv3_1", 8: "conv4_1",
        9: "conv4_2", 12: "conv5_1"}
STYLE_TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
CONTENT_TAP = "conv4_2"


def load_weights(arrays, device):
    """[(OIHW kernel, bias)] of the 13 convs up to conv5_1."""
    out = []
    for i in range(13):
        k = torch.as_tensor(arrays[f"conv{i}_kernel"], dtype=torch.float32)
        b = torch.as_tensor(arrays[f"conv{i}_bias"], dtype=torch.float32)
        out.append((k.permute(3, 2, 0, 1).contiguous().to(device),
                    b.to(device)))
    return out


def taps(x: torch.Tensor, weights, fmt: str = "float32"
         ) -> Dict[str, torch.Tensor]:
    """{tap: (B, C, H, W)} pre-ReLU maps of images ``x`` (B, 3, H, W)."""
    out, i = {}, 0
    for v in CFG:
        if v == "M":
            x = F.max_pool2d(x, 2)
            continue
        k, b = weights[i]
        z = grad_operand(F.conv2d(operand(x, fmt), operand(k, fmt), b,
                                  padding=1), fmt)
        if i in TAPS:
            out[TAPS[i]] = z
        x = torch.relu(z)
        i += 1
    return out


def gram(f: torch.Tensor, fmt: str = "float32") -> torch.Tensor:
    """(B, C, C) unnormalised Grams of maps (B, C, H, W)."""
    m = operand(f.flatten(2), fmt)
    return grad_operand(torch.bmm(m, m.transpose(1, 2)), fmt)
