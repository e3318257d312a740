"""VGG-19 feature extractor (counterpart of ``st3d/models/vgg.py``).

Taps are the pre-ReLU outputs of conv1_1, conv2_1, conv3_1, conv4_1,
conv4_2 and conv5_1 (torchvision indices 0, 5, 10, 19, 21, 28); inputs are
raw [0, 1] RGB; the stack stops after conv5_1. Weights are frozen, stored
HWIO, and activations run NHWC, as in the JAX package.

``get_features`` dispatches as the JAX package does on a TPU
(st3d/models/vgg.py:404-448, 496-540), its opt-in routes included:
  * stage 1: with ``gram1``, conv1_1 wanted, and H and W multiples of 8 (the
    shape gate of ``_pallas_conv_ok``), conv1_1, its Gram, conv1_2 and pool1
    are one of two stage-1 routes, and conv1_2 and pool1 are skipped after:
    - v2, the default: ``kernels.stage1``'s ``conv1_1_relu_stats`` (kernels
      A/B) and ``conv1_2_relu_pool`` (C/D); conv1_1's Gram is
      ``gram1_closed_form`` of the statistics;
    - v3, with ``ST3D_STAGE1=v3``: ``kernels.stage1v3``'s
      ``conv1_1_relu_gram`` (E/F), whose Gram is the direct Gram of the
      rounded pre-ReLU output, and ``conv1_2_relu_pool_v3`` (C/D).
    ``ST3D_NO_STAGE1_V2`` switches both off. v3's shape gate (H and W
    even, W/2 >= 2, stage1v3_pallas.py:499-518) holds wherever the
    multiple-of-8 one does. The JAX gates' band checks
    (``stage1_supported``, ``stage1_v3_supported``) size TPU VMEM tiles and
    have no counterpart here: where v3's fails (images 8 rows high) the JAX
    package runs v2 and the port v3;
  * otherwise conv1_1 is an im2col matmul, and with ``gram1`` its Gram comes
    from ``gram1_closed_form`` on the patch statistics, whose PᵀP is K3;
  * a non-tap conv followed by a pool, with Cin < 128 and even H and W
    (conv1_2 when stage 1 is off), is ``conv3x3_bias_relu_pool_packed``
    (K5: kernels C/D) and takes the pool with it; ``ST3D_NO_PACKED1``
    switches this route off;
  * with ``ST3D_FUSED_POOL`` set, the other non-tap convs followed by a pool
    (conv2_2, conv3_4, conv4_4, and conv1_2 under ``ST3D_NO_PACKED1``), with
    even H and W, take the same ``conv3x3_bias_relu_pool_packed`` (K8, whose
    JAX name ``conv3x3_bias_relu_pool`` is its alias in ``kernels/conv.py``)
    and the pool with it;
  * conv2_1, conv3_1, conv4_1 and conv5_1 with ``gram1`` are
    ``conv3x3_bias_gram`` (K2 then K3; the taps come back as Grams);
  * the other non-tap layers are ``conv3x3_bias_relu`` (K2 with ReLU);
  * conv4_2 and the taps without ``gram1`` are ``conv3x3_bias``;
  * the remaining pools are ``max_pool2d``.
With both switches set this is the dispatch of the port's first slice.
With ``relu3`` (ARF's NNFM loss, ``ops/nnfm.py``) the stack is VGG-16's
conv1_1-conv3_3 (VGG-19's first seven convs, the same widths): conv3_1,
conv3_2 and conv3_3 are K2 with ReLU and their outputs come back as one
float32 (B, P, 768) map ``"relu3"``; given the style's operand
(``nnfm``), the same call matches it (``kernels/nnfm.py``, span
``st3d.nnfm``) and adds ``"relu3:nn"`` and ``"relu3:nn_cos"``. The stack
stops at the deepest conv wanted.
Every other backward is K2 on flipped weights. The same dispatch runs on
the CPU (plain versions) and on the GPU (kernels).

Weights resolve as in the JAX package (``convs`` of them, all 16 by
default; the first seven of a VGG-16 or VGG-19 file for ``relu3``):
explicit path, then ``$ST3D_VGG_WEIGHTS``, then ``<repo>/weights/vgg19_imagenet.npz``, then a
deterministic random He initialisation from a ``torch.Generator`` (whose
bits differ from ``jax.random``'s; ``st3d_torch.convert.vgg19_from_numpy``
carries the JAX package's weights across).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from st3d_torch.kernels.conv import (
    conv3x3_bias,
    conv3x3_bias_gram,
    conv3x3_bias_relu,
    conv3x3_bias_relu_pool_packed,
    gram_nhwc_diff,
)
from st3d_torch.kernels.nnfm import StyleOperand, center_normalize, match
from st3d_torch.kernels.stage1 import conv1_1_relu_stats, conv1_2_relu_pool
from st3d_torch.kernels.stage1v3 import conv1_1_relu_gram, conv1_2_relu_pool_v3
from st3d_torch.utils import trace

VGG19_CFG: Tuple = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
    512, 512, 512, 512, "M", 512, 512, 512, 512, "M",
)

TAP_CONV_INDEX: Dict[str, int] = {
    "conv1_1": 0,   # features[0]
    "conv2_1": 2,   # features[5]
    "conv3_1": 4,   # features[10]
    "conv4_1": 8,   # features[19]
    "conv4_2": 9,   # features[21]  (content layer)
    "conv5_1": 12,  # features[28]
}
LAST_TAP_CONV = max(TAP_CONV_INDEX.values())
# ARF's NNFM block: relu3_1, relu3_2 and relu3_3, concatenated.
BLOCK3_CONV_INDEX: Dict[str, int] = {"conv3_1": 4, "conv3_2": 5,
                                     "conv3_3": 6}
BLOCK3_CONVS = max(BLOCK3_CONV_INDEX.values()) + 1
# The matching's counters kept on the device (``trace.device_counts``).
MATCH_COUNTERS = ("nnfm.candidates", "nnfm.full_rows")
# Style taps whose Gram is taken right after the conv (K3) when gram1=True.
FUSED_GRAM_CONVS = frozenset(
    TAP_CONV_INDEX[n] for n in ("conv2_1", "conv3_1", "conv4_1", "conv5_1"))


def conv_shapes() -> List[Tuple[int, int]]:
    """(in_ch, out_ch) of each of the 16 convs in order."""
    shapes, c_in = [], 3
    for v in VGG19_CFG:
        if v == "M":
            continue
        shapes.append((c_in, int(v)))
        c_in = int(v)
    return shapes


class VGG19(torch.nn.Module):
    """Frozen VGG-19 feature stack: the HWIO kernels and biases of its 16
    convs, or of its first ``convs`` (such as the seven that VGG-16
    shares), held as buffers (nothing here trains)."""

    def __init__(self, kernels: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor],
                 convs: Optional[int] = None):
        super().__init__()
        shapes = conv_shapes()[:convs]
        if len(kernels) != len(shapes) or len(biases) != len(shapes):
            raise ValueError(f"want {len(shapes)} kernels and biases")
        for i, ((c_in, c_out), w, b) in enumerate(zip(shapes, kernels,
                                                      biases)):
            w = torch.as_tensor(w, dtype=torch.float32)
            b = torch.as_tensor(b, dtype=torch.float32)
            if tuple(w.shape) != (3, 3, c_in, c_out) or tuple(b.shape) != (
                    c_out,):
                raise ValueError(
                    f"conv{i}: kernel {tuple(w.shape)} / bias "
                    f"{tuple(b.shape)}, want {(3, 3, c_in, c_out)} / "
                    f"{(c_out,)}")
            self.register_buffer(f"kernel{i}", w.contiguous())
            self.register_buffer(f"bias{i}", b.contiguous())
        self._convs = len(shapes)

    @property
    def num_convs(self) -> int:
        return self._convs

    @property
    def kernels(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"kernel{i}")
                     for i in range(self.num_convs))

    @property
    def biases(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"bias{i}") for i in range(self.num_convs))


def init_random_vgg19(seed: int = 0, device=None,
                      convs: Optional[int] = None) -> VGG19:
    """Deterministic He-initialised weights from a ``torch.Generator`` (the
    first ``convs`` of them: a prefix of the full stack's draws)."""
    gen = torch.Generator().manual_seed(seed)
    kernels, biases = [], []
    for c_in, c_out in conv_shapes()[:convs]:
        w = torch.randn((3, 3, c_in, c_out), generator=gen)
        kernels.append(w * float(np.sqrt(2.0 / (9 * c_in))))
        biases.append(torch.zeros(c_out))
    return VGG19(kernels, biases, convs).to(device)


def load_vgg19_npz(path: str, device=None,
                   convs: Optional[int] = None) -> VGG19:
    """Weights from an .npz with keys conv{i}_kernel (HWIO) and
    conv{i}_bias, i in 0..15 (the JAX package's converter format); with
    ``convs``, only the first that many are read and checked, so a VGG-16
    file (13 convs, its eighth conv4_1) serves the seven convs it shares
    with VGG-19."""
    n = len(conv_shapes()[:convs])
    with np.load(path) as data:
        kernels = [np.asarray(data[f"conv{i}_kernel"], np.float32)
                   for i in range(n)]
        biases = [np.asarray(data[f"conv{i}_bias"], np.float32)
                  for i in range(n)]
    return VGG19(kernels, biases, convs).to(device)


def save_vgg19_npz(model: VGG19, path: str) -> None:
    """Write ``model`` in the format ``load_vgg19_npz`` reads."""
    arrays = {}
    for i, (w, b) in enumerate(zip(model.kernels, model.biases)):
        arrays[f"conv{i}_kernel"] = w.detach().cpu().numpy()
        arrays[f"conv{i}_bias"] = b.detach().cpu().numpy()
    np.savez(path, **arrays)


_warned_random = False


def get_vgg(weights_path: Optional[str] = None, device=None,
            convs: Optional[int] = None) -> VGG19:
    """Resolution order: ``weights_path`` (missing -> FileNotFoundError),
    ``$ST3D_VGG_WEIGHTS``, ``<repo>/weights/vgg19_imagenet.npz``, then the
    random initialisation with a one-time warning; ``convs`` as
    ``load_vgg19_npz`` takes it."""
    global _warned_random
    candidates = []
    if weights_path:
        if not os.path.isfile(weights_path):
            raise FileNotFoundError(weights_path)
        candidates.append(weights_path)
    env = os.environ.get("ST3D_VGG_WEIGHTS")
    if env:
        candidates.append(env)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates.append(os.path.join(repo_root, "weights", "vgg19_imagenet.npz"))
    for cand in candidates:
        if os.path.isfile(cand):
            return load_vgg19_npz(cand, device, convs)
    if not _warned_random:
        warnings.warn(
            "No pretrained VGG-19 weights found; using deterministic random "
            "init. Point ST3D_VGG_WEIGHTS at an .npz made by "
            "scripts/convert_vgg_weights.py.", stacklevel=2)
        _warned_random = True
    return init_random_vgg19(device=device, convs=convs)


def gram1_closed_form(ptp: torch.Tensor, s27: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """conv1_1's Gram from im2col patch statistics, all float32:
    G = Wᵀ PᵀP W + u bᵀ + b uᵀ + N b bᵀ with u = s27 W; ptp (B, 27, 27),
    s27 (B, 27), w HWIO (3, 3, 3, 64), b (64,) (vgg.py:200-216)."""
    w27 = w.reshape(27, -1).float()
    bf = b.float()
    u = s27 @ w27
    g = torch.einsum("ko,bkl,lp->bop", w27, ptp, w27)
    return (g + u[:, :, None] * bf[None, None, :]
            + bf[None, :, None] * u[:, None, :]
            + float(n_pixels) * bf[None, :, None] * bf[None, None, :])


def _stage1_route(x: torch.Tensor, gram1: bool, wanted) -> Optional[str]:
    """The stage-1 route conv1_1 .. pool1 take: "v2", "v3" or None for
    none (vgg.py:219-238, 417-421 of the JAX package, less its TPU tiling
    checks)."""
    if os.environ.get("ST3D_NO_STAGE1_V2"):
        return None
    if not (gram1 and "conv1_1" in wanted):
        return None
    if x.shape[1] % 8 or x.shape[2] % 8:
        return None
    return "v3" if os.environ.get("ST3D_STAGE1") == "v3" else "v2"


def _packed_pool_route(x: torch.Tensor) -> bool:
    """Whether a pre-pool non-tap conv takes K5 (vgg.py:503-507 of the JAX
    package): Cin < 128 and even H and W, unless ``ST3D_NO_PACKED1``."""
    return (x.shape[3] < 128 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
            and not os.environ.get("ST3D_NO_PACKED1"))


def _fused_pool_route(x: torch.Tensor) -> bool:
    """Whether a pre-pool non-tap conv that is not K5 takes K8 (vgg.py:521-535
    of the JAX package): ``ST3D_FUSED_POOL`` set and H and W even."""
    return bool(os.environ.get("ST3D_FUSED_POOL")) and (
        x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, 2) on NHWC (floor mode)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


@trace.spanned("vgg")
def get_features(images: torch.Tensor, model: VGG19,
                 layers: Optional[Dict[str, str]] = None,
                 dtype: torch.dtype = torch.float32, layout: str = "NCHW",
                 input_layout: str = "NCHW",
                 gram1: bool = False, relu3: bool = False,
                 nnfm: Optional[StyleOperand] = None
                 ) -> Dict[str, torch.Tensor]:
    """Tap dict for a batch of [0, 1] images (B, 3, H, W), or (B, H, W, 3)
    with ``input_layout="NHWC"``.

    ``layout="NCHW"`` returns float32 (B, C, H', W') taps; ``"NHWC"``
    returns (B, H', W', C) taps in the compute ``dtype``. With ``gram1``,
    conv1_1 is replaced by ``"conv1_1:gram"`` and the other style taps by
    ``"<tap>:gram"``: (B, C, C) float32 Grams, the taps never exported.
    With ``relu3`` or ``nnfm`` the one output is ``"relu3"``, the float32
    (B, P, 768) post-ReLU conv3 block (positions y * W' + x); with
    ``nnfm``, a style's operand (``kernels/nnfm.py::style_operand``), also
    ``"relu3:nn"`` (B, P) int32, each position's matched style row, and
    ``"relu3:nn_cos"`` (B, P) float32, its centred cosine.
    """
    block = relu3 or nnfm is not None
    if block:
        wanted = set(BLOCK3_CONV_INDEX)
        name_by_conv = {v: k for k, v in BLOCK3_CONV_INDEX.items()}
    else:
        wanted = set(TAP_CONV_INDEX)
        if layers is not None:
            wanted = set(layers.values())
        name_by_conv = {v: k for k, v in TAP_CONV_INDEX.items()}
    last_conv = max((ci for ci, n in name_by_conv.items() if n in wanted),
                    default=LAST_TAP_CONV)
    if last_conv >= model.num_convs:
        raise ValueError(f"get_features: conv {last_conv} wanted, the model "
                         f"holds {model.num_convs} convs")
    x = images.to(dtype)
    if input_layout != "NHWC":
        x = x.permute(0, 2, 3, 1)
    x = x.contiguous()
    feats: Dict[str, torch.Tensor] = {}
    relus: List[torch.Tensor] = []
    kernels, biases = model.kernels, model.biases

    conv_i = 0
    skip_pool = False
    skip_convs = 0
    for cfg_i, v in enumerate(VGG19_CFG):
        if v == "M":
            if skip_pool:
                skip_pool = False
            else:
                x = _max_pool_2x2(x)
            continue
        if skip_convs:                 # consumed by stage 1
            skip_convs -= 1
            conv_i += 1
            continue
        w = kernels[conv_i].to(dtype)
        b = biases[conv_i].to(dtype)
        name = name_by_conv.get(conv_i)
        next_is_pool = (cfg_i + 1 < len(VGG19_CFG)
                        and VGG19_CFG[cfg_i + 1] == "M")
        did_relu = False
        # The block takes stage 1 too, its conv1_1 Gram left unused.
        stage1 = (_stage1_route(x, gram1 or block,
                                {"conv1_1"} if block else wanted)
                  if conv_i == 0 else None)
        if stage1 == "v3":
            z, feats["conv1_1:gram"] = conv1_1_relu_gram(x, w, b)
            x, _ = conv1_2_relu_pool_v3(z, kernels[1].to(dtype),
                                        biases[1].to(dtype))
            skip_convs = 1             # conv1_2 consumed here
            skip_pool = True           # pool1 consumed here
            did_relu = True
        elif stage1 == "v2":
            bsz, h, wd, _ = x.shape
            z, ptp, s27 = conv1_1_relu_stats(x, w, b)
            if not block:
                feats["conv1_1:gram"] = gram1_closed_form(
                    ptp, s27, kernels[0], biases[0], h * wd)
            x, _ = conv1_2_relu_pool(z, kernels[1].to(dtype),
                                     biases[1].to(dtype))
            skip_convs = 1             # conv1_2 consumed here
            skip_pool = True           # pool1 consumed here
            did_relu = True
        elif conv_i == 0:
            # Cin=3: an im2col matmul (patch order (dy, dx, c) matches the
            # HWIO flatten).
            bsz, h, wd, _ = x.shape
            xp = F.pad(x, (0, 0, 1, 1, 1, 1))
            patches = torch.cat(
                [xp[:, dy:dy + h, dx:dx + wd, :]
                 for dy in range(3) for dx in range(3)], dim=-1)
            x = patches @ w.reshape(27, -1) + b
            if gram1 and "conv1_1" in wanted:
                # PᵀP is a Gram of the (B, H, W, 27) patches: K3's narrow
                # route on CUDA (csrc/gram_narrow.cu).
                s27 = patches.float().sum(dim=(1, 2))
                feats["conv1_1:gram"] = gram1_closed_form(
                    gram_nhwc_diff(patches), s27, kernels[0], biases[0],
                    h * wd)
        elif block and name is not None:
            x = conv3x3_bias_relu(x, w, b)
            relus.append(x)
            did_relu = True
        elif gram1 and conv_i in FUSED_GRAM_CONVS and name in wanted:
            x, g = conv3x3_bias_gram(x, w, b)
            feats[name + ":gram"] = g
        elif name is None and next_is_pool and (
                _packed_pool_route(x) or _fused_pool_route(x)):
            # K5 and K8 compute one function, kernels C/D.
            x, _ = conv3x3_bias_relu_pool_packed(x, w, b)
            skip_pool = True
            did_relu = True
        elif name is None:
            x = conv3x3_bias_relu(x, w, b)
            did_relu = True
        else:
            x = conv3x3_bias(x, w, b)
        if (not block and name is not None and name in wanted
                and name + ":gram" not in feats):
            feats[name] = x if layout == "NHWC" else (
                x.permute(0, 3, 1, 2).float())
        if conv_i >= last_conv:
            break
        if not did_relu:
            x = torch.relu(x)
        conv_i += 1
    if block:
        bsz = images.shape[0]
        f = torch.cat(relus, dim=-1).float()
        f = f.reshape(bsz, -1, f.shape[-1])
        feats["relu3"] = f
        if nnfm is not None:
            feats.update(_match_block(f, nnfm))
    return feats


def _match_block(f: torch.Tensor, style: StyleOperand
                 ) -> Dict[str, torch.Tensor]:
    """The matching of the block ``f`` (B, P, C) against ``style``, with no
    gradient: span ``st3d.nnfm``, counters ``nnfm.rows`` (render positions
    matched), ``nnfm.pairs`` (rows times style rows scored) and, on a card,
    ``nnfm.candidates`` (pairs re-scored) and ``nnfm.full_rows`` (rows
    scored against every style row), those two kept on the device."""
    bsz, p, _ = f.shape
    with trace.span("nnfm"), torch.no_grad():
        stats = (trace.device_counts(MATCH_COUNTERS, f.device)
                 if f.device.type == "cuda" else None)
        nn, cos = match(center_normalize(f.detach()), style, stats)
        trace.count("nnfm.rows", bsz * p)
        trace.count("nnfm.pairs", bsz * p * style.rows)
    return {"relu3:nn": nn.reshape(bsz, p), "relu3:nn_cos": cos.reshape(bsz, p)}
