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
  row on a tie. On a CUDA tensor the certified matching
  (``nnfm_filter_tf32``, ``nnfm_rescore``, ``nnfm_fallback``): one tf32
  product hi x hi a pair (the style's tf32 split made once by
  ``style_operand``, the columns cut by ``match_chunks``) keeps each row's
  columns within twice its bound ``row_bound_plain`` of its best, float64
  scores those, and a row with more than ``CAP`` is scored against every
  column on the CUDA cores; its plain version ``match_certified_plain``
  (filter ``filter_plain``). ``match_full`` is the 3xTF32 kernel
  ``nnfm_match_tf32x3`` with ``nnfm_merge`` over every pair, which a style
  of more than 65,536 rows takes (the lists hold uint16 columns). On a CPU
  tensor ``match`` is ``match_plain``, a row-blockwise ``torch.matmul``
  and ``argmax`` that never holds more than ``PLAIN_ROWS`` rows of
  similarities.
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

LIB = "nnfm_match_tf32x3"
LAUNCHES: Dict[str, int] = {"nnfm_normalize": 0, "nnfm_match_tf32x3": 0,
                            "nnfm_match_certified": 0, "nnfm_loss_fwd": 0,
                            "nnfm_loss_bwd": 0}
EPS = 1e-8
SUM_ROWS = 256          # positions per column-sum slice (the kernel's)
TILE = 128              # rows of a work item, columns of a tile
FILTER_TILE = 256       # columns of a tile of the certified filter
CHUNKS = 4              # column chunks of the matching (``match_chunks``)
PLAIN_ROWS = 4096       # render rows per block of the plain matching
CAP = 64                # candidate columns a row's list holds (the kernel's)
LIST = 8                # a lane's live candidates of a row (the kernel's)
MAX_LIST_COLUMNS = 65536  # the lists hold uint16 columns
NORM_SLACK = 1.0 + 2.0 ** -12   # over the float32 sums of the norms


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
    device their exact tf32 split (``split_tf32_nearest``) and its
    ``style_norms``, made once a style."""

    hat: torch.Tensor
    hi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None
    norms: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.hat.shape[0]


def split_tf32_nearest(t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` as ``(hi, lo)`` with hi the TF32 value nearest t (ties
    away from zero, as the filter kernel rounds its A fragments: 0x1000
    added to the bits, then the low 13 mantissa bits cleared) and lo = t -
    hi, exact in float32 (a zero lo takes t's sign), so hi + lo == t bit
    for bit. |lo| is at most half a TF32 step, half of what
    ``split_tf32``'s truncation leaves, and the filter's bound with it."""
    bits = t.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -8192).view(torch.float32)
    lo = t - hi
    return hi, torch.where(lo == 0, torch.copysign(lo, t), lo)


def style_norms(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(2,) float32 on ``hi``'s device: bounds on the largest row norm of
    the style's tf32 hi and lo parts (their float32 norms raised by
    ``NORM_SLACK``), computed there with no sync."""
    n = torch.stack([torch.linalg.vector_norm(hi, dim=1).max(),
                     torch.linalg.vector_norm(lo, dim=1).max()])
    return (n * NORM_SLACK).to(torch.float32).contiguous()


def style_operand(hat: torch.Tensor) -> StyleOperand:
    if hat.device.type == "cpu":
        return StyleOperand(hat)
    hat = _rows_ready(hat, "nnfm_match_tf32x3")
    hi, lo = split_tf32_nearest(hat)
    return StyleOperand(hat, hi.contiguous(), lo.contiguous(),
                        style_norms(hi, lo))


def match_chunks(n: int, tile: int = TILE) -> Tuple[int, int]:
    """(chunks, tiles a chunk) of the matching's ``n`` style columns: their
    ``tile``-column tiles cut into up to ``CHUNKS`` runs, so that the CTAs
    running at a time (one item each, the chunk fastest) share about SMs /
    CHUNKS row tiles in L2: 72 tiles of 128 each at the cell's 36,864
    columns (the filter's 36 of 256)."""
    n_tiles = -(-n // tile)
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


def row_bound_plain(fhat: torch.Tensor, norms: torch.Tensor
                    ) -> torch.Tensor:
    """Each row's ``eps`` (M,) float32, the kernel's bound (the header of
    ``csrc/nnfm_match_tf32x3.cu``): |H - E| + the error of the float32
    rounded float64 score, from the row's |a_hi|, |a_lo| and ``norms``
    (``style_norms``), split as the kernel splits them
    (``split_tf32_nearest``)."""
    hi, lo = split_tf32_nearest(fhat.float())
    ah = torch.sqrt((hi * hi).sum(-1))
    al = torch.sqrt((lo * lo).sum(-1))
    bhi, blo = (float(v) for v in norms)
    k8 = -(-fhat.shape[1] // 32) * 4                # the kernel's k8 steps
    eps = (al * bhi + ah * blo + al * blo + k8 * 2.0 ** -20 * ah * bhi
           + 2.0 ** -22 * (ah + al) * (bhi + blo))
    return eps * NORM_SLACK


def filter_plain(fhat: torch.Tensor, shat: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain filter: ``H`` (M, N) = A_hi B_hi^T in float32, each row's
    ``eps`` (``row_bound_plain``) and its candidates (M, N) bool, the
    columns with H >= max_j H - 2 eps: the set the kernel's lists hold
    once the row's maximum is known."""
    a_hi = split_tf32_nearest(fhat.float())[0]
    b_hi, b_lo = split_tf32_nearest(shat.float())
    h = a_hi @ b_hi.t()
    eps = row_bound_plain(fhat, style_norms(b_hi, b_lo))
    cand = h >= (h.max(dim=1).values - 2.0 * eps)[:, None]
    return h, eps, cand


def _best_by_key(scores: torch.Tensor, cols: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Of float64 ``scores`` (M, L) at columns ``cols`` (M, L; -1 for no
    column), the column of the largest float32-rounded score, the lowest
    column on a tie, and that value; column 0 and NaN where none."""
    r = scores.to(torch.float32).double()
    r = torch.where(cols >= 0, r, torch.full_like(r, -float("inf")))
    best = r.max(dim=1, keepdim=True).values
    big = torch.iinfo(torch.int64).max
    col = torch.where((r == best) & (cols >= 0), cols,
                      torch.full_like(cols, big)).min(dim=1).values
    none = col == big
    return (torch.where(none, 0, col).to(torch.int32),
            torch.where(none, float("nan"), best[:, 0]).to(torch.float32))


def match_certified_plain(fhat: torch.Tensor, shat: torch.Tensor,
                          cap: int = CAP
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain certified matching: ``filter_plain``'s candidates scored in
    float64 (float32 inputs, exact products) and rounded to float32, the
    lowest column on a tie; a row of more than ``cap`` candidates scored
    against every column the same way. (M,) int32 columns, (M,) float32
    values and (M,) bool, the rows scored in full."""
    _, _, cand = filter_plain(fhat, shat)
    full = cand.sum(dim=1) > cap
    cand = cand | full[:, None]
    s = fhat.double() @ shat.double().t()
    cols = torch.arange(shat.shape[0]).expand_as(s)
    idx, val = _best_by_key(s, torch.where(cand, cols, -1))
    return idx, val, full


def certified_scratch_bytes(m: int) -> int:
    """Bytes of the certified matching's scratch for ``m`` rows (the
    kernel's ``certified_lists_offset`` and lists): counters, each row's
    running max, list count and fallback slot, and its ``CAP`` uint16
    columns."""
    return -(-(16 + 12 * m) // 128) * 128 + m * CAP * 2


def match(fhat: torch.Tensor, style: StyleOperand,
          stats: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``fhat`` (M, C) the style row of ``style`` with the
    largest dot product, the lowest on a tie, and that dot product: (M,)
    int32 and (M,) float32. Not differentiable. On a card, ``stats`` (2,)
    int64, if given, gains the pairs re-scored and the rows scored in
    full, on the device."""
    if fhat.device.type == "cpu":
        return match_plain(fhat, style.hat)
    if style.rows > MAX_LIST_COLUMNS:
        return match_full(fhat, style)
    fhat = _rows_ready(fhat, "nnfm_match_certified")
    m, k = fhat.shape
    n = style.rows
    if style.hi is None or style.norms is None or style.hi.shape[1] != k:
        raise ValueError("nnfm_match_certified: the style operand wants "
                         f"{k} channels, its tf32 split and its norms")
    dev = fhat.device
    if stats is not None and (stats.dtype != torch.int64
                              or stats.shape != (2,) or stats.device != dev
                              or not stats.is_contiguous()):
        raise ValueError("nnfm_match_certified: stats wants a contiguous "
                         f"(2,) int64 tensor on {dev}")
    chunks, chunk_tiles = match_chunks(n, FILTER_TILE)
    scratch = torch.empty((certified_scratch_bytes(m),), dtype=torch.uint8,
                          device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    val = torch.empty((m,), dtype=torch.float32, device=dev)
    fn = build.symbol(LIB, "st3d_nnfm_match_certified_f32", 8, 5)
    err = fn(fhat.data_ptr(), style.hat.data_ptr(), style.hi.data_ptr(),
             style.norms.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
             val.data_ptr(), 0 if stats is None else stats.data_ptr(), m, n,
             k, chunks, chunk_tiles, build.stream_handle(dev))
    build.check(err, "nnfm_match_certified")
    LAUNCHES["nnfm_match_certified"] += 1
    return idx, val


def match_full(fhat: torch.Tensor, style: StyleOperand
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``match`` by 3xTF32 over every pair (``nnfm_match_tf32x3``), on a
    card."""
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
