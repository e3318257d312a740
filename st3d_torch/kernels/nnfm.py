"""ARF's nearest-neighbour feature matching (NNFM; Zhang et al., "ARF:
Artistic Radiance Fields", ECCV 2022, arXiv:2206.06360): the kernels of
``csrc/nnfm_match_tf32x3.cu`` with their plain versions.

No counterpart in the JAX package, which has no NNFM loss. Rows are the
positions of VGG-16's conv3 block (relu3_1, relu3_2 and relu3_3
concatenated: C = 768 channels), float32:

- ``center_normalize``: each image's rows centred over its own positions
  and normalised, ``x = f - mean_p f``, ``x / (sqrt(|x|^2 + 1e-8) +
  1e-8)`` (ARF's ``cos_distance``); kernels ``nnfm_colsum``, ``nnfm_mean``,
  ``nnfm_normalize``, one launch of the three.
- ``match``: for each normalised render row the style row of largest dot
  product and that dot product (the best centred cosine), the lowest style
  row on a tie. On a CUDA tensor ``nnfm_match_tf32x3`` (3xTF32 on the
  tensor cores, the style's tf32 split made once by ``style_operand``,
  the columns cut by ``match_chunks``) and ``nnfm_merge``; on a CPU tensor
  ``match_plain``, a row-blockwise ``torch.matmul`` and ``argmax`` that
  never holds more than ``PLAIN_ROWS`` rows of similarities.
- ``loss_rows``: each row's loss, ``a * (1 - f . s / (|f| + 1e-8)) + b *
  |f - c|^2`` with ``s`` its matched style row over its norm (the gather)
  and ``c`` its content row, differentiable in ``f``; kernels
  ``nnfm_loss_fwd`` and ``nnfm_loss_bwd``.

Each wrapper launches its kernel for a CUDA tensor and its plain version,
defined beside it, for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from st3d_torch.kernels import build
from st3d_torch.kernels.conv import split_tf32

LIB = "nnfm_match_tf32x3"
LAUNCHES: Dict[str, int] = {"nnfm_normalize": 0, "nnfm_match_tf32x3": 0,
                            "nnfm_loss_fwd": 0, "nnfm_loss_bwd": 0}
EPS = 1e-8
SUM_ROWS = 256          # positions per column-sum slice (the kernel's)
TILE = 128              # rows of a work item, columns of a tile
CHUNKS = 4              # column chunks of the matching (``match_chunks``)
PLAIN_ROWS = 4096       # render rows per block of the plain matching


def _rows_ready(t: torch.Tensor, name: str) -> torch.Tensor:
    """A contiguous float32 CUDA tensor of rows whose width is a multiple
    of 4 (16-byte rows, as TMA and the float4 loads want)."""
    build.check_operands(name, t)
    if t.dtype != torch.float32 or t.shape[-1] % 4:
        raise ValueError(f"{name}: float32 rows of a width that is a "
                         f"multiple of 4, got {t.dtype} {tuple(t.shape)}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def center_normalize_plain(f: torch.Tensor) -> torch.Tensor:
    """Plain ``center_normalize``: (B, P, C) -> (B * P, C)."""
    x = f - f.mean(dim=1, keepdim=True)
    den = torch.sqrt((x * x).sum(-1, keepdim=True) + EPS) + EPS
    return (x / den).reshape(-1, f.shape[-1])


def center_normalize(f: torch.Tensor) -> torch.Tensor:
    """Rows of ``f`` (B, P, C) centred over their image's P positions and
    normalised, as (B * P, C)."""
    if f.device.type == "cpu":
        return center_normalize_plain(f)
    f = _rows_ready(f, "nnfm_normalize")
    bsz, p, c = f.shape
    partial = torch.empty((bsz, -(-p // SUM_ROWS), c), dtype=f.dtype,
                          device=f.device)
    mean = torch.empty((bsz, c), dtype=f.dtype, device=f.device)
    out = torch.empty_like(f)
    fn = build.symbol(LIB, "st3d_nnfm_normalize_f32", 4, 3)
    err = fn(f.data_ptr(), partial.data_ptr(), mean.data_ptr(),
             out.data_ptr(), bsz, p, c, build.stream_handle(f.device))
    build.check(err, "nnfm_normalize")
    LAUNCHES["nnfm_normalize"] += 1
    return out.reshape(-1, c)


@dataclasses.dataclass
class StyleOperand:
    """A style's centred, normalised rows ``hat`` (N, C), and on a CUDA
    device their exact tf32 split (``split_tf32``), made once a style."""

    hat: torch.Tensor
    hi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.hat.shape[0]


def style_operand(hat: torch.Tensor) -> StyleOperand:
    if hat.device.type == "cpu":
        return StyleOperand(hat)
    hat = _rows_ready(hat, "nnfm_match_tf32x3")
    hi, lo = split_tf32(hat)
    return StyleOperand(hat, hi.contiguous(), lo.contiguous())


def match_chunks(n: int) -> Tuple[int, int]:
    """(chunks, tiles a chunk) of the matching's ``n`` style columns: their
    128-column tiles cut into up to ``CHUNKS`` runs, so that the CTAs
    running at a time (one item each, the chunk fastest) share about SMs /
    CHUNKS row tiles in L2: 72 tiles each at the cell's 36,864 columns."""
    n_tiles = -(-n // TILE)
    chunk_tiles = -(-n_tiles // min(CHUNKS, n_tiles))
    return -(-n_tiles // chunk_tiles), chunk_tiles


def match_plain(fhat: torch.Tensor, shat: torch.Tensor,
                rows: int = PLAIN_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``match``: (M, C) against (N, C) in blocks of ``rows`` render
    rows, in the operands' dtype; (M,) int32 columns and (M,) values."""
    idx, val = [], []
    for r0 in range(0, fhat.shape[0], rows):
        sim = torch.matmul(fhat[r0:r0 + rows], shat.t())
        best = torch.argmax(sim, dim=1)          # the first of equal maxima
        idx.append(best.to(torch.int32))
        val.append(sim.gather(1, best[:, None])[:, 0])
    return torch.cat(idx), torch.cat(val)


def match(fhat: torch.Tensor, style: StyleOperand
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``fhat`` (M, C) the style row of ``style`` with the
    largest dot product, the lowest on a tie, and that dot product: (M,)
    int32 and (M,) float32. Not differentiable."""
    if fhat.device.type == "cpu":
        return match_plain(fhat, style.hat)
    fhat = _rows_ready(fhat, "nnfm_match_tf32x3")
    m, k = fhat.shape
    n = style.rows
    if style.hi is None or style.hi.shape[1] != k:
        raise ValueError("nnfm_match_tf32x3: the style operand wants "
                         f"{k} channels and its tf32 split")
    chunks, chunk_tiles = match_chunks(n)
    dev = fhat.device
    part_val = torch.empty((m, chunks), dtype=torch.float32, device=dev)
    part_idx = torch.empty((m, chunks), dtype=torch.int32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    val = torch.empty((m,), dtype=torch.float32, device=dev)
    fn = build.symbol(LIB, "st3d_nnfm_match_tf32x3_f32", 7, 5)
    err = fn(fhat.data_ptr(), style.hi.data_ptr(), style.lo.data_ptr(),
             part_val.data_ptr(), part_idx.data_ptr(), idx.data_ptr(),
             val.data_ptr(), m, n, k, chunks, chunk_tiles,
             build.stream_handle(dev))
    build.check(err, "nnfm_match_tf32x3")
    LAUNCHES["nnfm_match_tf32x3"] += 1
    return idx, val


def loss_rows_plain(f: torch.Tensor, unit: torch.Tensor,
                    content: torch.Tensor, nn: torch.Tensor, a: float,
                    b: float) -> torch.Tensor:
    """Plain ``loss_rows``, by autograd."""
    s = unit[nn.long()]
    n = torch.sqrt((f * f).sum(-1))
    cos = (f * s).sum(-1) / (n + EPS)
    return a * (1.0 - cos) + b * ((f - content) ** 2).sum(-1)


def _loss_launch(name: str, n_ptr: int, ptrs, m: int, c: int, a: float,
                 b: float, device) -> None:
    fn = build.symbol(LIB, f"st3d_{name}_f32", n_ptr, 2, 2)
    err = fn(*ptrs, m, c, a, b, build.stream_handle(device))
    build.check(err, name)
    LAUNCHES[name] += 1


class _LossRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, unit, content, nn, a, b):
        f = _rows_ready(f, "nnfm_loss_fwd")
        unit = _rows_ready(unit, "nnfm_loss_fwd")
        content = _rows_ready(content, "nnfm_loss_fwd")
        nn = nn.to(torch.int32).contiguous()
        m, c = f.shape
        stats = torch.empty((m, 2), dtype=torch.float32, device=f.device)
        rows = torch.empty((m,), dtype=torch.float32, device=f.device)
        _loss_launch("nnfm_loss_fwd", 6,
                     (f.data_ptr(), unit.data_ptr(), content.data_ptr(),
                      nn.data_ptr(), stats.data_ptr(), rows.data_ptr()),
                     m, c, a, b, f.device)
        ctx.save_for_backward(f, unit, content, nn, stats)
        ctx.ab = (a, b)
        return rows

    @staticmethod
    def backward(ctx, grad):
        f, unit, content, nn, stats = ctx.saved_tensors
        grad = grad.float().contiguous()
        df = torch.empty_like(f)
        m, c = f.shape
        _loss_launch("nnfm_loss_bwd", 7,
                     (f.data_ptr(), unit.data_ptr(), content.data_ptr(),
                      nn.data_ptr(), stats.data_ptr(), grad.data_ptr(),
                      df.data_ptr()), m, c, *ctx.ab, f.device)
        return df, None, None, None, None, None


def loss_rows(f: torch.Tensor, unit: torch.Tensor, content: torch.Tensor,
              nn: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """(M,) rows ``a * (1 - f . s / (|f| + 1e-8)) + b * |f - c|^2`` of ``f``
    and ``content`` (M, C), ``s = unit[nn]`` (``unit`` (N, C), the style
    rows over their norms), differentiable in ``f`` only."""
    if f.device.type == "cpu":
        return loss_rows_plain(f, unit, content, nn, a, b)
    return _LossRows.apply(f, unit, content, nn, float(a), float(b))
