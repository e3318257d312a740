"""VGG-19 (Simonyan & Zisserman, arXiv:1409.1556) to conv5_1.

Raw [0, 1] RGB in, NCHW; 3x3 convs with padding 1, ReLU, 2x2 max-pools.
The taps are the pre-ReLU outputs of the convs a loss names
(``portbench/losses/<loss>.py``'s ``TAPS``, by VGG's names ``conv1_1`` ...
``conv5_1``); the stack stops after the deepest of them. Weights come as
HWIO kernels ``conv{i}_kernel`` and biases ``conv{i}_bias``. In a lower
``precision`` every conv takes rounded operands.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn.functional as F

from portbench.reference.precision import grad_operand, operand

CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
       512, 512, 512, 512, "M", 512)


def _conv_names():
    out, block, idx = [], 1, 1
    for v in CFG:
        if v == "M":
            block, idx = block + 1, 1
        else:
            out.append(f"conv{block}_{idx}")
            idx += 1
    return tuple(out)


CONVS = _conv_names()


def load_weights(arrays, device):
    """[(OIHW kernel, bias)] of the 13 convs up to conv5_1."""
    out = []
    for i in range(13):
        k = torch.as_tensor(arrays[f"conv{i}_kernel"], dtype=torch.float32)
        b = torch.as_tensor(arrays[f"conv{i}_bias"], dtype=torch.float32)
        out.append((k.permute(3, 2, 0, 1).contiguous().to(device),
                    b.to(device)))
    return out


def taps(x: torch.Tensor, weights, names: Iterable[str],
         fmt: str = "float32") -> Dict[str, torch.Tensor]:
    """{tap: (B, C, H, W)} pre-ReLU maps of images ``x`` (B, 3, H, W) at
    the convs ``names``; no conv past the deepest of them runs."""
    want = set(names)
    if not want or not want <= set(CONVS):
        raise KeyError(f"taps {sorted(want)}: each one of {CONVS}")
    last = max(CONVS.index(n) for n in want)
    out, i = {}, 0
    for v in CFG:
        if v == "M":
            x = F.max_pool2d(x, 2)
            continue
        k, b = weights[i]
        z = grad_operand(F.conv2d(operand(x, fmt), operand(k, fmt), b,
                                  padding=1), fmt)
        if CONVS[i] in want:
            out[CONVS[i]] = z
        if i == last:
            break
        x = torch.relu(z)
        i += 1
    return out
