"""ARF's nearest-neighbour feature matching loss (NNFM; Zhang et al., "ARF:
Artistic Radiance Fields", ECCV 2022, arXiv:2206.06360, and its released
``nnfm_loss.py``), as the benchmark holds a configuration whose ``model``
section names ``"loss": "nnfm"``.

Taps: the pre-ReLU maps of conv3_1, conv3_2 and conv3_3, so the
reference's VGG runs to conv3_3 (VGG-16's first seven convs, which VGG-19
shares); the ReLU is applied here, and the three maps are concatenated
over channels into the block phi (B, P, 768), positions in the order y * W
+ x. F = phi(render), S = phi(style), C = phi(content render).

Matching, with no gradient: each side centred over its own positions, F̄ =
F - mean_i F_i and S̄ = S - mean_j S_j (per image), its rows normalised,
x / (sqrt(|x|^2 + 1e-8) + 1e-8), and nn(i) = argmax_j F̂_i . Ŝ_j, the lowest
j on a tie. The similarities are taken in blocks of at most ``BLOCK_ROWS``
render rows (a float64 block of 4,096 x 36,864 is 1.2 GB); in a lower
``precision`` both operands are rounded (``reference/precision.py``'s
``operand``), so the TF32 control matches in TF32.

The loss: ``style_weight * mean_i [1 - <F_i / (|F_i| + 1e-8), S_nn(i) /
(|S_nn(i)| + 1e-8)>] + content_weight * mean((F - C)^2)``, the gradient
through F only (S_nn(i) is a gathered constant).

Targets, per view batch of ``n`` views: (S, Ŝ, C), the style's block and
its normalised rows, and the content renders' blocks (n, P, 768).

First step: ``nn_cos_diff``, the relative distance of the first step's best
centred cosines (B, P) from the reference's, as the port's VGG returns them
(its ``get_features`` gives them as ``"relu3:nn_cos"``). They are VGG's
forward and the matching alone, continuous where the argmax flips between
near-equal matches. ``follow`` calls ``first_step`` right after ``loss`` on
the same ``cur`` and passes it no target, so ``loss`` keeps the cosines of
its last call here, beside the ``cur`` it was given; ``first_step`` checks
that it is handed that same tensor.

Work: the matching is ``2 * P_render * P_style * 768`` FLOPs an image
(``flops``; 2.09 TFLOP at 768², 83% of an epoch's model FLOPs); the
gather, the cosines and the content term are ``O(P * 768)``, under 1e-4 of
it, and not counted. ``layer_work`` gives no entry: the matching's kernels
are a layer of their own (``layers/nnfm.json``), which ``vgg.device_ms``
leaves out, so its work must stay out of ``vgg_bound_s`` too;
``match_work`` gives the (FLOPs, bytes) that ``nnfm.roofline`` reads.

Departures from ARF, as the configuration's ``assumed`` lists them: the
raw [0, 1] image goes into VGG without ImageNet's normalisation (the
benchmark's reference VGG takes the raw image, and with seeded weights the
affine changes no shape or work); no total-variation term (ARF's
regularises a voxel grid; a UV texture has no counterpart); the style image
at the render size (ARF resizes it to its own); ``content_weight`` 0.005,
an assumed weight.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench import work
from portbench.reference.precision import operand

TAPS = ("conv3_1", "conv3_2", "conv3_3")
FLAGS = ("loss", "style_weight", "content_weight")
FIRST_STEP = "nn_cos_diff"
PORT_KEY = "relu3:nn_cos"
BLOCK_ROWS = 4096
EPS = 1e-8
CHANNELS = 768

# The last call of ``loss``: {"cur": its taps, "nn_cos": (B, P)}.
_LAST: Dict[str, object] = {}


def block(taps: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, P, 768): the taps (B, C, H, W) through the ReLU, concatenated
    over channels, positions y * W + x."""
    x = torch.cat([torch.relu(taps[t]) for t in TAPS], dim=1)
    return x.flatten(2).transpose(1, 2)


def normalized(x: torch.Tensor) -> torch.Tensor:
    """(B, P, C) centred over each image's positions, rows normalised."""
    x = x - x.mean(dim=1, keepdim=True)
    return x / (torch.sqrt((x * x).sum(-1, keepdim=True) + EPS) + EPS)


def match(f_hat: torch.Tensor, s_hat: torch.Tensor, fmt: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M,) indices and values of each row's largest F̂_i . Ŝ_j, in blocks
    of ``BLOCK_ROWS`` rows."""
    s_t = operand(s_hat, fmt).t()
    idx, val = [], []
    for r0 in range(0, f_hat.shape[0], BLOCK_ROWS):
        sim = torch.matmul(operand(f_hat[r0:r0 + BLOCK_ROWS], fmt), s_t)
        best = torch.argmax(sim, dim=1)          # the first of equal maxima
        idx.append(best)
        val.append(sim.gather(1, best[:, None])[:, 0])
        del sim
    return torch.cat(idx), torch.cat(val)


def targets(style: Dict[str, torch.Tensor], content: Dict[str, torch.Tensor],
            n: int, fmt: str):
    """A batch's targets: the style's block S (P, 768), Ŝ, and the content
    renders' blocks (n, P, 768)."""
    s = block(style)
    return s[0], normalized(s)[0], block(content)


def loss(cur: Dict[str, torch.Tensor], target, cell: dict, fmt: str
         ) -> torch.Tensor:
    s, s_hat, content = target
    f = block(cur)
    bsz, p, c = f.shape
    with torch.no_grad():
        nn, best = match(normalized(f.detach()).reshape(-1, c), s_hat, fmt)
    _LAST.clear()
    _LAST.update(cur=cur, nn_cos=best.reshape(bsz, p))
    rows = f.reshape(-1, c)
    sn = s[nn]
    cos = ((rows / (torch.sqrt((rows * rows).sum(-1, keepdim=True)) + EPS))
           * (sn / (torch.sqrt((sn * sn).sum(-1, keepdim=True)) + EPS))
           ).sum(-1)
    return (cell["style_weight"] * torch.mean(1.0 - cos)
            + cell["content_weight"] * torch.mean((f - content) ** 2))


def first_step(cur: Dict[str, torch.Tensor], fmt: str
               ) -> Dict[str, torch.Tensor]:
    """The best centred cosines (B, P) of the matching of ``loss``'s last
    call, which must have been handed this same ``cur``, on the host."""
    if _LAST.get("cur") is not cur:
        raise RuntimeError("nnfm.first_step: call it right after loss() on "
                           "the same taps")
    return {PORT_KEY: _LAST["nn_cos"].cpu()}


def port_first_step(feats: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The same, from what the port's ``get_features`` returned."""
    return {k: v.detach().float().cpu() for k, v in feats.items()
            if k == PORT_KEY}


def positions(h: int, w: int) -> int:
    """Positions of the conv3 block of an h x w image."""
    return (h // 4) * (w // 4)


def flops(h: int, w: int) -> float:
    """FLOPs of one image's matching against a style at the same size."""
    p = positions(h, w)
    return 2.0 * p * p * CHANNELS


def layer_work(h: int, w: int, dtype: str) -> Dict[str, Tuple[int, int]]:
    """None: the matching's work is ``match_work``'s, a layer of its own."""
    return {}


def match_work(h: int, w: int, dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one image's ``nnfm`` kernels, each tensor read and
    written once, float32 whatever ``dtype``: the centring and
    normalisation (F in, F̂ out), the matching (F̂ and Ŝ's two tf32 parts
    in, an index and a value a row out), the loss forward (F, the matched
    style rows and C in; a row's loss and two statistics out) and backward
    (the same, the rows' gradient in, dF out)."""
    p = positions(h, w)
    row = 4 * p * CHANNELS
    nbytes = (2 * row                     # normalise
              + 3 * row + 8 * p           # match
              + 3 * row + 12 * p          # loss forward
              + 4 * row + 16 * p)         # loss backward
    return flops(h, w), float(nbytes)


def match_bound_s(h: int, w: int, dtype: str) -> float:
    """The least time one image's ``nnfm`` kernels take on the card: the
    larger of FLOPs over the peak of ``dtype`` and bytes over HBM
    bandwidth (``work.py``'s rule; one product a FLOP)."""
    f, b = match_work(h, w, dtype)
    return max(f / work.PEAK_FLOPS[dtype], b / work.HBM_BYTES_S)
