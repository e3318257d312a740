"""Operations and bytes of the VGG-19 work from shapes, and the card's peaks.

Counted once from the configuration's shapes, whatever implements them:

* VGG-19 (Simonyan & Zisserman, arXiv:1409.1556) runs forward to the
  deepest tap of the configuration's loss (``portbench/losses/<loss>.py``'s
  ``TAPS``; conv5_1, 13 of its 16 3x3 convs, for the Gram loss), each conv
  ``2 * 9 * Cin * Cout`` FLOPs a pixel of its resolution, and backward to
  the input image only: the weights are frozen, so a conv's backward is its
  input gradient, as many FLOPs again.
* The loss adds its own FLOPs (``flops``) and the (FLOPs, bytes) of its
  layers (``layer_work``): an entry named after a VGG layer runs with it
  and counts in it, any other is a layer of its own after them.

To conv5_1 at H x W pixels that is ``722,304 * H * W`` forward and the same
backward; the Gram loss adds ``69,632 * H * W``: 893.1 GFLOP an image at
768². Over VGG-19's 16 convs at 224² the forward is ``777,600 * 224**2`` =
39.0 GFLOP (19.5 GMAC, the published 19.6 GMAC less the three FC layers).

The bound of a layer is the larger of its FLOPs over the peak and its bytes
over HBM bandwidth, each tensor read once and written once (a conv's input,
weights and output forward; its output gradient, weights, output, for the
ReLU mask, and input gradient backward; a pool's input and output, and
their gradients; the loss's layers as it counts them). The VGG bound sums
the layers' bounds: they run one after another.

Peaks are NVIDIA's data sheet for one H100 SXM, dense: 989 TFLOP/s bf16 on
the tensor cores, 495 TFLOP/s TF32 (the float32 route runs 3xTF32 on those
units, so its FLOPs are held against this rate), 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}

# VGG-19's feature stack: conv widths, "M" a 2x2 max-pool.
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def vgg_layers(n_convs: int = 16) -> List[Tuple[str, int, int, int]]:
    """(name, Cin, Cout or 0 for a pool, downscale) of the first
    ``n_convs`` convs and the pools between them, in order."""
    out, c_in, scale, block, idx = [], 3, 1, 1, 1
    convs = 0
    for v in VGG19_CFG:
        if convs == n_convs:
            break
        if v == "M":
            out.append((f"pool{block}", c_in, 0, scale))
            scale, block, idx = scale * 2, block + 1, 1
            continue
        out.append((f"conv{block}_{idx}", c_in, int(v), scale))
        c_in, idx, convs = int(v), idx + 1, convs + 1
    return out


def conv_names() -> List[str]:
    return [n for n, _, c, _ in vgg_layers() if c]


def convs_to(last: str) -> int:
    return conv_names().index(last) + 1


def deepest(taps) -> str:
    """The conv of ``taps`` that lies deepest in the stack."""
    return max(taps, key=conv_names().index)


def conv_forward_flops(h: int, w: int, n_convs: int) -> float:
    """FLOPs of one image's forward through the first ``n_convs`` convs."""
    return float(sum(2 * 9 * ci * co * (h // s) * (w // s)
                     for _, ci, co, s in vgg_layers(n_convs) if co))


def image_step_flops(h: int, w: int, loss) -> float:
    """Model FLOPs of one image's optimisation step: the forward to the
    loss's deepest tap, its input-gradient backward and the loss's own."""
    return (2 * conv_forward_flops(h, w, convs_to(deepest(loss.TAPS)))
            + loss.flops(h, w))


def images_per_epoch(n_views: int, styles: int) -> int:
    """VGG images an epoch runs: every view once per style."""
    return n_views * styles


def epoch_flops(size: int, n_views: int, styles: int, loss) -> float:
    return images_per_epoch(n_views, styles) * image_step_flops(size, size,
                                                                loss)


def _layer_work(h: int, w: int, dtype: str, loss
                ) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each layer of one image's step, forward and
    backward together: VGG's to the loss's deepest tap, with the loss's
    work in the layer it names, then the loss's layers of their own."""
    nb = DTYPE_BYTES[dtype]
    extra = loss.layer_work(h, w, dtype)
    work = []
    layers = vgg_layers(convs_to(deepest(loss.TAPS)))
    for name, ci, co, s in layers:
        px = (h // s) * (w // s)
        if not co:                               # a pool
            out = px // 4 * ci
            work.append((0.0, nb * 2 * (px * ci + out)))
            continue
        flops = 2 * 2 * 9 * ci * co * px
        wbytes = 4 * 9 * ci * co
        nbytes = nb * (px * ci + px * co) + wbytes            # forward
        nbytes += nb * (2 * px * co + px * ci) + wbytes       # backward
        if name in extra:
            flops += extra[name][0]
            nbytes += extra[name][1]
        work.append((float(flops), float(nbytes)))
    names = {layer[0] for layer in layers}
    work += [(float(f), float(b)) for name, (f, b) in extra.items()
             if name not in names]
    return work


def vgg_bound_s(size: int, images: int, dtype: str, loss) -> float:
    """Seconds the card needs at least for ``images`` images' VGG steps:
    the sum over layers of max(FLOPs / peak, bytes / HBM bandwidth)."""
    peak = PEAK_FLOPS[dtype]
    return images * sum(max(f / peak, b / HBM_BYTES_S)
                        for f, b in _layer_work(size, size, dtype, loss))


def summary(cell) -> Dict[str, float]:
    """The work of ``cell``'s epoch (a ``cells.Cell``), with its loss."""
    size, n_views = int(cell.flags["size"]), int(cell.flags["n_views"])
    n = images_per_epoch(n_views, cell.styles)
    return {"images_per_epoch": n,
            "epoch_flops": epoch_flops(size, n_views, cell.styles,
                                       cell.loss),
            "vgg_bound_s_per_epoch": vgg_bound_s(size, n, cell.dtype,
                                                 cell.loss),
            "peak_flops": PEAK_FLOPS[cell.dtype]}
