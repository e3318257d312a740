"""3x3 convolution kernels for the VGG stack, with their gradients.

Counterpart of ``st3d/kernels/conv_pallas.py``. Its hand-written CUDA
kernels:

- K2 ``conv3x3_nhwc``: 3x3 SAME stride-1 conv + bias (+ ReLU), NHWC
  activations, HWIO weights, float32 accumulation, output in the input
  dtype (bf16 or f32). It also runs every backward: the input gradient of a
  stride-1 SAME conv is the same conv of the cotangent with flipped,
  IO-transposed weights and a zero bias. Four kernels, chosen by
  ``conv_route`` on dtype and widths: ``csrc/conv3x3_wgmma.cu`` (bf16 on
  the tensor cores, TMA-fed tiles of ``conv_tile``'s shape),
  ``csrc/conv3x3_tf32x3.cu`` (float32 on the tensor cores by the 3xTF32
  split of ``split_tf32``, the same tiles), and for the widths TMA cannot
  stride (conv1_1's 3 -> 64 and its 64 -> 3 input gradient)
  ``csrc/conv3x3_narrow_wgmma.cu`` (bf16) and
  ``csrc/conv3x3_narrow_tf32x3.cu`` (float32, 3xTF32), both on the tensor
  cores with the A fragments loaded from a halo staged by cp.async (3
  channels) or TMA (multiples of 32 bytes) and the weights laid out by
  ``narrow_weights``. ``csrc/conv3x3_nhwc.cu`` (the CUDA cores) takes no
  route but widths whose narrow tiles overflow shared memory (none in
  VGG); ``conv3x3_cuda_core`` calls it.
- K3 ``gram_nhwc``: per-image unnormalised Gram ``yᵀy`` from y in its
  stored dtype, into float32, split over pixel slices by ``gram_split``.
  Three kernels, chosen by ``gram_route``: ``csrc/gram_wgmma.cu`` (bf16,
  tensor cores), ``csrc/gram_tf32x3.cu`` (float32 on the tensor cores by
  the 3xTF32 split, the K-major operand tiles built in shared memory) and
  ``csrc/gram_nhwc.cu`` (CUDA cores: other widths).
- ``conv3x3_relu_pool`` and its backward ``pool_route_conv3x3_bwd``:
  conv + bias + ReLU + 2x2 max-pool with the window index, and the input
  gradient routed by that index. The forward has three kernels, chosen by
  ``relu_pool_route``: ``csrc/conv3x3_wgmma.cu``'s pool epilogue (bf16,
  K2's mainloop on tiles of ``pool_tile``'s shape, the 2x2 pool in shared
  memory), ``csrc/conv3x3_tf32x3.cu``'s pool epilogue (float32, the 3xTF32
  mainloop on the same tiles) and ``csrc/conv3x3_relu_pool.cu`` (the CUDA
  cores: other widths). The backward has three, chosen by ``pool_route``:
  ``csrc/pool_route_wgmma.cu`` (bf16 on the tensor cores, K2's mainloop
  with the routed A tile built in shared memory from the TMA-loaded
  ``pool_footprint``), ``csrc/pool_route_tf32x3.cu`` (float32 the same
  way, on the 3xTF32 mainloop) and ``csrc/pool_route_conv3x3_bwd.cu`` (the
  CUDA cores: other widths). Together they are
  ``conv3x3_bias_relu_pool_packed``
  (K5), and ``kernels/stage1.py`` runs them as conv1_2 of stage 1 (K4b,
  K4d; K10c, K10d under v3). They take any Cin/Cout, so they are also
  ``conv3x3_bias_relu_pool`` (K8, the ``ST3D_FUSED_POOL`` route).

Each wrapper takes its kernel for a CUDA tensor and its plain PyTorch
version, defined beside it, for a CPU tensor; nothing else. The plain
versions are also what ``chip_smoke.py`` holds the kernels against.
``LAUNCHES`` counts kernel launches (plain-version calls do not count).

VGG weights are frozen, so the autograd functions give the input gradient
only, exactly as the JAX custom VJPs do (conv_pallas.py:455-501, 649-681,
934-997). The ReLU mask and the Gram term of the cotangent are torch ops,
as they were XLA ops outside the TPU kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from st3d_torch.kernels import build

LAUNCHES: Dict[str, int] = {"conv3x3_nhwc": 0, "conv3x3_wgmma": 0,
                            "conv3x3_tf32x3": 0,
                            "conv3x3_narrow_wgmma": 0,
                            "conv3x3_narrow_tf32x3": 0,
                            "gram_nhwc": 0, "gram_wgmma": 0,
                            "gram_tf32x3": 0,
                            "conv3x3_relu_pool": 0,
                            "conv3x3_relu_pool_wgmma": 0,
                            "conv3x3_relu_pool_tf32x3": 0,
                            "pool_route_conv3x3_bwd": 0,
                            "pool_route_wgmma": 0,
                            "pool_route_tf32x3": 0}

SMS = 132                       # streaming multiprocessors of an H100
CONV_TILE_PIXELS = 128          # output pixels of one tensor-core K2 tile
POOL_TILE_WIDTH = 64            # widest tile that holds whole 2x2 windows
# K3's split over pixel slices, per route: (Gram tile edge, upper triangle
# only, pixels per step, shortest slice, blocks wanted). The tensor-core
# kernels' steps are TMA boxes (64 pixels in bf16, 32 in float32) and they
# compute the tiles with row <= column; the CUDA-core kernel computes every
# 64 x 64 tile.
GRAM_PLAN = {"wgmma": (128, True, 64, 256, 2 * SMS),
             "tf32x3": (128, True, 32, 256, 2 * SMS),
             "cuda_core": (64, False, 16, 256, 4 * SMS)}
# The narrow K2 (csrc/conv_narrow.cuh): output channels a block (wgmma's n),
# and a block's dynamic shared memory.
NARROW_NB = (8, 16, 32, 64)
NARROW_MAX_BW = 64              # its widest 128-pixel tile box: 64 x 2
SMEM_LIMIT = 232448
NARROW_ROUTES = {torch.bfloat16: "narrow_wgmma",
                 torch.float32: "narrow_tf32x3"}


def _tma_route(dtype: torch.dtype, cin: int, cout: int) -> str:
    if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0:
        return "wgmma"
    if dtype == torch.float32 and cin % 4 == 0 and cout % 4 == 0:
        return "tf32x3"
    return "cuda_core"


def conv_route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The K2 kernel a CUDA tensor takes: "wgmma" (``csrc/conv3x3_wgmma.cu``)
    for bf16 with Cin and Cout multiples of 8, "tf32x3"
    (``csrc/conv3x3_tf32x3.cu``) for float32 with Cin and Cout multiples of
    4 (TMA's global strides are multiples of 16 bytes); the other widths
    in bf16 "narrow_wgmma" (``csrc/conv3x3_narrow_wgmma.cu``) and in
    float32 "narrow_tf32x3" (``csrc/conv3x3_narrow_tf32x3.cu``) wherever
    ``narrow_nb`` finds a plan; else "cuda_core" (``csrc/conv3x3_nhwc.cu``:
    widths whose narrow tiles overflow shared memory, and dtypes with no
    tensor-core route, which the wrapper refuses)."""
    route = _tma_route(dtype, cin, cout)
    if route == "cuda_core" and dtype in NARROW_ROUTES and narrow_nb(
            dtype, cin, cout):
        return NARROW_ROUTES[dtype]
    return route


def relu_pool_route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The kernel ``conv3x3_relu_pool`` takes for a CUDA tensor: "wgmma"
    (``csrc/conv3x3_wgmma.cu`` with its pool epilogue) for bf16 with Cin
    and Cout multiples of 8, "tf32x3" (``csrc/conv3x3_tf32x3.cu`` with its
    pool epilogue) for float32 with Cin and Cout multiples of 4
    (``conv_route``'s TMA rules), else "cuda_core"
    (``csrc/conv3x3_relu_pool.cu``)."""
    return _tma_route(dtype, cin, cout)


def pool_route(dtype: torch.dtype, c: int, cin: int) -> str:
    """The kernel ``pool_route_conv3x3_bwd`` takes for a CUDA tensor with C
    pooled channels and Cin input channels: "wgmma"
    (``csrc/pool_route_wgmma.cu``) for bf16 with C a multiple of 16 (the
    uint8 index rows are C bytes apart, and TMA strides are multiples of 16
    bytes) and Cin a multiple of 8; "tf32x3" (``csrc/pool_route_tf32x3.cu``)
    for float32 with C a multiple of 16 and Cin a multiple of 4 (the f32
    weight and dz rows, as ``conv_route``'s float32 rule); else
    "cuda_core" (``csrc/pool_route_conv3x3_bwd.cu``)."""
    if dtype == torch.bfloat16 and c % 16 == 0 and cin % 8 == 0:
        return "wgmma"
    if dtype == torch.float32 and c % 16 == 0 and cin % 4 == 0:
        return "tf32x3"
    return "cuda_core"


def gram_route(dtype: torch.dtype, c: int) -> str:
    """The K3 kernel a CUDA tensor takes: "wgmma" (``csrc/gram_wgmma.cu``)
    for bf16 with C a multiple of 8, "tf32x3" (``csrc/gram_tf32x3.cu``) for
    float32 with C a multiple of 4 (the pixel rows of y are C * 4 bytes
    apart, and TMA strides are multiples of 16 bytes), else "cuda_core"
    (``csrc/gram_nhwc.cu``: conv1_1's 27-wide patch Gram)."""
    if dtype == torch.bfloat16 and c % 8 == 0:
        return "wgmma"
    if dtype == torch.float32 and c % 4 == 0:
        return "tf32x3"
    return "cuda_core"


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def narrow_smem(esize: int, cin: int, cout: int, nb: int, bw: int) -> int:
    """Dynamic shared memory of a narrow K2 block (``csrc/conv_narrow.cuh``
    ``make_plan``) for ``esize``-byte elements, ``nb`` output channels and
    tiles ``bw`` wide (a power of two up to ``NARROW_MAX_BW``): the
    weights (hi and lo in float32), two halo stages (TMA boxes of
    128-byte channel slabs when Cin fills whole 32-byte k-steps, else raw
    rows), the output staging (two swizzled TMA tiles where an output
    pixel is 128 or 256 bytes), the bias, the k table of a raw halo and
    1 KB of alignment."""
    kstep, slab = 32 // esize, 128 // esize
    bh = CONV_TILE_PIXELS // bw
    # 128- and 256-byte output pixels leave by TMA from two swizzled tiles.
    out = (2 * CONV_TILE_PIXELS * cout * esize
           if cout * esize in (128, 256) and nb == cout
           else _round_up(bh * (_round_up(bw * nb * esize, 16) + 16), 128))
    padded = cin % kstep == 0
    pitch = 128 if padded else _round_up((bw + 2) * cin * esize, 16) + 32
    kt = _round_up(9 * cin, kstep)
    w = -(-kt * esize // 128) * nb * 128 * (2 if esize == 4 else 1)
    stage = _round_up((bh + 2) * ((bw + 2) * pitch if padded else pitch),
                      1024)
    table = 0 if padded else 4 * kt
    return (_round_up(w + 2 * stage, 1024) + out + _round_up(4 * nb, 128)
            + table + 1024)


@functools.lru_cache(maxsize=None)
def narrow_nb(dtype: torch.dtype, cin: int, cout: int):
    """Output channels a narrow K2 block takes: the least of
    ``NARROW_NB`` that covers Cout (64 past it: more blocks), halved while
    a block of the widest tile plan overflows ``SMEM_LIMIT``; None where 8
    does."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nb = next((n for n in NARROW_NB if n >= cout), NARROW_NB[-1])
    widths = [2 ** i for i in range(NARROW_MAX_BW.bit_length())]
    while nb >= NARROW_NB[0]:
        if max(narrow_smem(esize, cin, cout, nb, bw) for bw in widths) \
                <= SMEM_LIMIT:
            return nb
        nb //= 2
    return None


@functools.lru_cache(maxsize=None)
def narrow_perm(cin: int, esize: int) -> torch.Tensor:
    """The channel each K position of a tap holds in the narrow K2, for
    ``esize``-byte elements: in order, but where Cin fills whole 32-byte
    k-steps (a padded halo), each full 128-byte slab of 4 k-steps is
    permuted so that a thread's fragment words of two k-steps are one
    16-byte chunk of a halo pixel: position KSTEP * s + col holds channel
    16 * ((col % 8) // 2) + 4 * s + 2 * (col // 8) + col % 2 in bf16 and
    8 * (col % 4) + 2 * s + col // 4 in float32 (csrc/conv_narrow.cuh)."""
    kstep, slab = 32 // esize, 128 // esize
    perm = list(range(cin))
    if cin % kstep == 0:
        for base in range(0, cin - slab + 1, slab):
            for s in range(4):
                for col in range(kstep):
                    ch = (16 * ((col % 8) // 2) + 4 * s + 2 * (col // 8)
                          + col % 2 if esize == 2
                          else 8 * (col % 4) + 2 * s + col // 4)
                    perm[base + kstep * s + col] = base + ch
    return torch.tensor(perm)


@functools.lru_cache(maxsize=None)
def _narrow_index(cin: int, cout: int, nb: int, esize: int,
                  device: torch.device) -> torch.Tensor:
    """``narrow_weights``' gather, built once: for each of its (rows, KT)
    entries, the flat index into HWIO weights with one zero appended (the
    padding's), on ``device``."""
    kt = _round_up(9 * cin, 32 // esize)
    rows = _round_up(cout, nb)
    perm = narrow_perm(cin, esize)
    k = torch.arange(kt)
    tap, j = k // cin, k % cin
    src = (tap[None, :] * cin + perm[j % cin][None, :]) * cout + torch.arange(
        rows)[:, None]
    pad = (k[None, :] >= 9 * cin) | (torch.arange(rows)[:, None] >= cout)
    return torch.where(pad, 9 * cin * cout, src).reshape(-1).to(device)


def narrow_weights(w: torch.Tensor, nb: int) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) weights as the narrow K2's B operand:
    (nb * ceil(Cout / nb), KT) K-major, row n holding
    w[dy, dx, narrow_perm[j], n] at k = (dy * 3 + dx) * Cin + j (the dense
    im2col order), KT = 9 * Cin rounded up to a 32-byte k-step (16 bf16,
    8 float32); padding rows and columns zero. One gather a call, by an
    index built once per shape."""
    cin, cout = w.shape[2], w.shape[3]
    idx = _narrow_index(cin, cout, nb, w.element_size(), w.device)
    flat = F.pad(w.reshape(-1), (0, 1))
    return flat[idx].view(_round_up(cout, nb), -1)


def conv_tile(width: int) -> Tuple[int, int]:
    """(BW, BH) of the tensor-core K2's output tile: a BW x BH box of one
    image, BW * BH = 128 pixels, BW the smallest power of two that covers
    the width, at most 128. The tile's rows past the image are loaded as
    zeros and not stored."""
    bw = 1
    while bw < min(width, CONV_TILE_PIXELS):
        bw *= 2
    return bw, CONV_TILE_PIXELS // bw


def pool_tile(width: int) -> Tuple[int, int]:
    """(BW, BH) of the tensor-core ``conv3x3_relu_pool``'s output tile:
    ``conv_tile``'s box with BW capped at 64, so that BH >= 2 and both
    sides are even and the tile holds whole 2x2 windows (tile origins are
    even, and so are H and W)."""
    bw = min(conv_tile(width)[0], POOL_TILE_WIDTH)
    return bw, CONV_TILE_PIXELS // bw


def pool_footprint(width: int) -> Tuple[int, int]:
    """(PW, PH) of the pooled box the tensor-core ``pool_route_conv3x3_bwd``
    loads per tile of a ``width``-wide full-resolution image: the pooled
    pixels under the ``conv_tile`` box plus its one-pixel full-resolution
    halo. The box starts at pooled ((x0 - 1) >> 1, (y0 - 1) >> 1); x0 is
    even, and so is y0 unless the box is one row high."""
    bw, bh = conv_tile(width)
    return bw // 2 + 2, (2 if bh == 1 else bh // 2 + 2)


# ---------------------------------------------------------------------------
# K2: 3x3 SAME conv + bias (+ ReLU)
# ---------------------------------------------------------------------------

def _conv_shapes(x, w, b):
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.dim() != 4:
        raise ValueError(
            f"conv3x3: want x (B,H,W,Cin) and w (3,3,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    if x.shape[3] != cin or b.shape != (cout,):
        raise ValueError(
            f"conv3x3: channel mismatch x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, b {tuple(b.shape)}")
    return cin, cout


def conv3x3_nhwc_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       relu: bool = False) -> torch.Tensor:
    """Plain version of K2: float32 sum of the nine shifted-tap matmuls,
    bias, optional ReLU, one rounding into ``x.dtype``."""
    _conv_shapes(x, w, b)
    bsz, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, dy:dy + h, dx:dx + wd, :] @ wf[dy, dx]
            acc = term if acc is None else acc + term
    acc = acc + b.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype)


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 relu: bool = False) -> torch.Tensor:
    """K2: ``relu?(conv3x3_same(x, w) + b)`` for x (B,H,W,Cin), w HWIO
    (3,3,Cin,Cout), b (Cout,); output (B,H,W,Cout) in ``x.dtype``."""
    cin, cout = _conv_shapes(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_nhwc_plain(x, w, b, relu)
    build.check_operands("conv3x3_nhwc", x, w, b)
    route = conv_route(x.dtype, cin, cout)
    if route == "wgmma":
        return _conv3x3_wgmma(x, w, b, relu)
    if route == "tf32x3":
        return _conv3x3_tf32x3(x, w, b, relu)
    if route in ("narrow_wgmma", "narrow_tf32x3"):
        return _conv3x3_narrow(x, w, b, relu)
    return conv3x3_cuda_core(x, w, b, relu)


def conv3x3_cuda_core(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool = False) -> torch.Tensor:
    """K2 on the CUDA cores (``csrc/conv3x3_nhwc.cu``): scalar FMAs, any
    widths; CUDA tensors only. ``conv_route`` sends it only widths whose
    narrow tiles overflow shared memory."""
    cin, cout = _conv_shapes(x, w, b)
    build.check_operands("conv3x3_nhwc", x, w, b)
    bsz, h, wd, _ = x.shape
    x = x.contiguous()
    wf = w.reshape(9 * cin, cout).contiguous()
    b = b.contiguous()
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    fn = build.symbol("conv3x3_nhwc",
                      "st3d_conv3x3_nhwc_" + build.DTYPE_SUFFIX[x.dtype], 4, 6)
    err = fn(x.data_ptr(), wf.data_ptr(), b.data_ptr(), y.data_ptr(),
             bsz, h, wd, cin, cout, int(relu), build.stream_handle(x.device))
    build.check(err, "conv3x3_nhwc")
    LAUNCHES["conv3x3_nhwc"] += 1
    return y


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as a TMA descriptor
    wants (a view into a larger buffer may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _conv3x3_wgmma(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    """K2 on the tensor cores: bf16 x (B,H,W,Cin), w HWIO laid out
    (Cout, 3, 3, Cin) so that K is innermost, tiles of ``conv_tile``."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    x = _tma_ready(x)
    wk = w.permute(3, 0, 1, 2).contiguous()
    b = b.contiguous()
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    fn = build.symbol("conv3x3_wgmma", "st3d_conv3x3_wgmma_bf16", 4, 7)
    err = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h,
             wd, cin, cout, conv_tile(wd)[0], int(relu),
             build.stream_handle(x.device))
    build.check(err, "conv3x3_wgmma")
    LAUNCHES["conv3x3_wgmma"] += 1
    return y


def _conv3x3_narrow(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    relu: bool) -> torch.Tensor:
    """K2 at the widths TMA cannot stride, on the tensor cores: bf16
    (``csrc/conv3x3_narrow_wgmma.cu``) or float32 by the 3xTF32 split
    (``csrc/conv3x3_narrow_tf32x3.cu``, the weights split by
    ``split_tf32``), w laid out by ``narrow_weights``."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    nb = narrow_nb(x.dtype, cin, cout)
    x = _tma_ready(x)
    wk = narrow_weights(w, nb)
    b = b.contiguous()
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    stream = build.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        key = "conv3x3_narrow_wgmma"
        fn = build.symbol(key, "st3d_conv3x3_narrow_wgmma_bf16", 4, 7)
        err = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(),
                 bsz, h, wd, cin, cout, int(relu), nb, stream)
    else:
        key = "conv3x3_narrow_tf32x3"
        w_hi, w_lo = split_tf32(wk)
        fn = build.symbol(key, "st3d_conv3x3_narrow_tf32x3_f32", 5, 7)
        err = fn(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                 b.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout,
                 int(relu), nb, stream)
    build.check(err, key)
    LAUNCHES[key] += 1
    return y


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` as ``(hi, lo)``: hi is t with its low 13 mantissa bits
    cleared (a TF32 value), lo = t - hi, exact in float32, with t's sign
    where it is zero, so hi + lo == t bit for bit (-0.0 included)."""
    hi = (t.contiguous().view(torch.int32) & -8192).view(torch.float32)
    return hi, torch.copysign(t - hi, t)


def _conv3x3_tf32x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    relu: bool) -> torch.Tensor:
    """K2 in float32 on the tensor cores by the 3xTF32 split: x
    (B,H,W,Cin), w HWIO laid out (Cout, 3, 3, Cin) and split by
    ``split_tf32``, tiles of ``conv_tile``."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    x = _tma_ready(x)
    w_hi, w_lo = split_tf32(w.permute(3, 0, 1, 2).contiguous())
    b = b.contiguous()
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    fn = build.symbol("conv3x3_tf32x3", "st3d_conv3x3_tf32x3_f32", 5, 7)
    err = fn(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), b.data_ptr(),
             y.data_ptr(), bsz, h, wd, cin, cout, conv_tile(wd)[0], int(relu),
             build.stream_handle(x.device))
    build.check(err, "conv3x3_tf32x3")
    LAUNCHES["conv3x3_tf32x3"] += 1
    return y


def transpose_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO weights of the input gradient of a SAME conv with ``w``: the
    kernel flipped in space, in and out channels swapped."""
    return torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2).to(dtype)


def _transpose_conv(ct: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the SAME conv: K2 on the cotangent with the
    spatially flipped, IO-transposed kernel and a zero bias."""
    zb = torch.zeros(w.shape[2], dtype=ct.dtype, device=ct.device)
    return conv3x3_nhwc(ct, transpose_weights(w, ct.dtype), zb)


class _Conv3x3Bias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(w)
        return conv3x3_nhwc(x, w, b)

    @staticmethod
    def backward(ctx, ct):
        (w,) = ctx.saved_tensors
        return _transpose_conv(ct, w), None, None


class _Conv3x3BiasRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        z = conv3x3_nhwc(x, w, b, relu=True)
        ctx.save_for_backward(w, z)
        return z

    @staticmethod
    def backward(ctx, ct):
        w, z = ctx.saved_tensors
        # ReLU mask from the saved output: z > 0 iff the pre-ReLU value is.
        return _transpose_conv(ct * (z > 0).to(ct.dtype), w), None, None


class _Conv3x3BiasGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y = conv3x3_nhwc(x, w, b)
        g = gram_nhwc(y)
        ctx.save_for_backward(w, y)
        return y, g

    @staticmethod
    def backward(ctx, ct_y, ct_g):
        w, y = ctx.saved_tensors
        # The Gram cotangent folds into the output cotangent.
        return _transpose_conv(ct_y + _gram_vjp(y, ct_g), w), None, None


def _gram_vjp(y: torch.Tensor, ct_g: torch.Tensor) -> torch.Tensor:
    """d(yᵀy)/dy applied to ct_g: y·(ctG + ctGᵀ), in y's dtype."""
    bsz, c = y.shape[0], y.shape[-1]
    sym = (ct_g + ct_g.transpose(-1, -2)).to(y.dtype)
    return torch.matmul(y.reshape(bsz, -1, c), sym).reshape(y.shape)


def conv3x3_bias(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv + bias, NHWC/HWIO, differentiable in ``x``
    (conv_pallas.py:456)."""
    return _Conv3x3Bias.apply(x, w, b)


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x) + b) in one kernel pass (conv_pallas.py:479)."""
    return _Conv3x3BiasRelu.apply(x, w, b)


def conv3x3_bias_gram(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, G)`` with y = conv3x3(x) + b and ``G[v] = y_vᵀ y_v`` over pixels,
    (B, C, C) float32 from y in its output dtype (conv_pallas.py:650): K2
    then K3."""
    return _Conv3x3BiasGram.apply(x, w, b)


# ---------------------------------------------------------------------------
# K3: per-image Gram
# ---------------------------------------------------------------------------

def gram_nhwc_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: float32 ``flatᵀ·flat`` per image."""
    bsz, c = y.shape[0], y.shape[-1]
    flat = y.reshape(bsz, -1, c).float()
    return torch.matmul(flat.transpose(1, 2), flat)


def gram_tiles(c: int, route: str = "wgmma") -> int:
    """Gram tiles one (image, slice) of K3 computes on ``route``."""
    edge, triangle = GRAM_PLAN[route][:2]
    t = -(-c // edge)
    return t * (t + 1) // 2 if triangle else t * t


def gram_split(bsz: int, pixels: int, c: int,
               route: str = "wgmma") -> Tuple[int, int]:
    """(slices, slice_len) of K3's two-pass split over pixels on ``route``:
    about the route's wanted blocks (tile, image, slice), slices whole
    steps and never shorter than its shortest slice (one slice for fewer
    pixels); the last slice may be shorter."""
    _, _, step, min_slice, target = GRAM_PLAN[route]
    want = -(-target // (bsz * gram_tiles(c, route)))
    slices = max(1, min(want, pixels // min_slice, 65535 // bsz))
    slice_len = -(-pixels // slices)
    slice_len = -(-slice_len // step) * step
    return -(-pixels // slice_len), slice_len


GRAM_LIBS = {"wgmma": "gram_wgmma", "tf32x3": "gram_tf32x3",
             "cuda_core": "gram_nhwc"}


def gram_nhwc(y: torch.Tensor) -> torch.Tensor:
    """K3: (B, ..., C) activation -> (B, C, C) float32 Grams over all
    non-batch, non-channel positions. Not differentiable by itself: see
    ``gram_nhwc_diff`` and ``conv3x3_bias_gram``."""
    if y.device.type == "cpu":
        return gram_nhwc_plain(y)
    build.check_operands("gram_nhwc", y)
    return _gram(y, gram_route(y.dtype, y.shape[-1]))


def gram_cuda_core(y: torch.Tensor) -> torch.Tensor:
    """K3 on the CUDA cores (``csrc/gram_nhwc.cu``), the route of the widths
    ``gram_route`` keeps off the tensor cores; CUDA tensors only."""
    build.check_operands("gram_nhwc", y)
    return _gram(y, "cuda_core")


def _gram(y: torch.Tensor, route: str) -> torch.Tensor:
    bsz, c = y.shape[0], y.shape[-1]
    pixels = y.numel() // (bsz * c)
    y = _tma_ready(y)
    slices, slice_len = gram_split(bsz, pixels, c, route)
    partial = torch.empty((bsz, slices, c, c), dtype=torch.float32,
                          device=y.device)
    g = torch.empty((bsz, c, c), dtype=torch.float32, device=y.device)
    lib = GRAM_LIBS[route]
    fn = build.symbol(lib, f"st3d_{lib}_" + build.DTYPE_SUFFIX[y.dtype], 3, 5)
    err = fn(y.data_ptr(), partial.data_ptr(), g.data_ptr(), bsz, pixels, c,
             slices, slice_len, build.stream_handle(y.device))
    build.check(err, lib)
    LAUNCHES[lib] += 1
    return g


class _GramNHWC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return gram_nhwc(y)

    @staticmethod
    def backward(ctx, ct_g):
        (y,) = ctx.saved_tensors
        return _gram_vjp(y, ct_g)


def gram_nhwc_diff(y: torch.Tensor) -> torch.Tensor:
    """``gram_nhwc`` (K3), differentiable in ``y``."""
    return _GramNHWC.apply(y)


# ---------------------------------------------------------------------------
# Conv + bias + ReLU + 2x2 max-pool with the window index (K5, K4b), and its
# index-routed input gradient (K5's backward, K4d)
# ---------------------------------------------------------------------------

def _pool_dims(x: torch.Tensor) -> Tuple[int, int]:
    h, wd = x.shape[1], x.shape[2]
    if h % 2 or wd % 2:
        raise ValueError(f"2x2 pool needs even H and W, got {tuple(x.shape)}")
    return h // 2, wd // 2


def pool4_first_max(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 max-pool of a float32 (B, H, W, C) with the window index: the
    position of the first maximum in scan order ((0,0), (0,1), (1,0),
    (1,1)), by strict comparisons (conv_pallas.py:739 ``_pool4_first_max``).
    Returns (pooled float32, idx uint8)."""
    bsz, h, wd, c = y.shape
    win = y.reshape(bsz, h // 2, 2, wd // 2, 2, c)
    c0, c1 = win[:, :, 0, :, 0], win[:, :, 0, :, 1]
    c2, c3 = win[:, :, 1, :, 0], win[:, :, 1, :, 1]
    w01 = (c1 > c0).to(torch.uint8)
    w23 = (c3 > c2).to(torch.uint8)
    m01, m23 = torch.maximum(c0, c1), torch.maximum(c2, c3)
    idx = torch.where(m23 > m01, 2 + w23, w01)
    return torch.maximum(m01, m23), idx


def conv3x3_relu_pool_plain(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``conv3x3_relu_pool``: K2's plain conv with ReLU
    (one rounding into ``x.dtype``), then the first-max pool on the rounded
    values."""
    _pool_dims(x)
    pooled, idx = pool4_first_max(conv3x3_nhwc_plain(x, w, b, True).float())
    return pooled.to(x.dtype), idx


def conv3x3_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """maxpool2x2(relu(conv3x3_same(x, w) + b)) for x (B,H,W,Cin) with H, W
    even, w HWIO: pooled (B,H/2,W/2,Cout) in ``x.dtype`` and idx uint8 in
    {0..3} (``pool4_first_max``'s rule, on output-dtype values)."""
    cin, cout = _conv_shapes(x, w, b)
    _pool_dims(x)
    if x.device.type == "cpu":
        return conv3x3_relu_pool_plain(x, w, b)
    build.check_operands("conv3x3_relu_pool", x, w, b)
    route = relu_pool_route(x.dtype, cin, cout)
    if route == "wgmma":
        return _conv3x3_relu_pool_wgmma(x, w, b)
    if route == "tf32x3":
        return _conv3x3_relu_pool_tf32x3(x, w, b)
    return conv3x3_relu_pool_cuda_core(x, w, b)


def _pool_outputs(x: torch.Tensor, cout: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    bsz, h, wd, _ = x.shape
    shape = (bsz, h // 2, wd // 2, cout)
    return (torch.empty(shape, dtype=x.dtype, device=x.device),
            torch.empty(shape, dtype=torch.uint8, device=x.device))


def _conv3x3_relu_pool_wgmma(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C on the tensor cores (bf16): K2's mainloop with the pool epilogue,
    w HWIO laid out (Cout, 3, 3, Cin), tiles of ``pool_tile``."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    x = _tma_ready(x)
    wk = w.permute(3, 0, 1, 2).contiguous()
    b = b.contiguous()
    pooled, idx = _pool_outputs(x, cout)
    fn = build.symbol("conv3x3_wgmma", "st3d_conv3x3_relu_pool_wgmma_bf16",
                      5, 6)
    err = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), pooled.data_ptr(),
             idx.data_ptr(), bsz, h, wd, cin, cout, pool_tile(wd)[0],
             build.stream_handle(x.device))
    build.check(err, "conv3x3_relu_pool_wgmma")
    LAUNCHES["conv3x3_relu_pool_wgmma"] += 1
    return pooled, idx


def _conv3x3_relu_pool_tf32x3(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C in float32 on the tensor cores: the 3xTF32 mainloop with the pool
    epilogue, w HWIO laid out (Cout, 3, 3, Cin) and split by
    ``split_tf32``, tiles of ``pool_tile``."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    x = _tma_ready(x)
    w_hi, w_lo = split_tf32(w.permute(3, 0, 1, 2).contiguous())
    b = b.contiguous()
    pooled, idx = _pool_outputs(x, cout)
    fn = build.symbol("conv3x3_tf32x3", "st3d_conv3x3_relu_pool_tf32x3_f32",
                      6, 6)
    err = fn(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), b.data_ptr(),
             pooled.data_ptr(), idx.data_ptr(), bsz, h, wd, cin, cout,
             pool_tile(wd)[0], build.stream_handle(x.device))
    build.check(err, "conv3x3_relu_pool_tf32x3")
    LAUNCHES["conv3x3_relu_pool_tf32x3"] += 1
    return pooled, idx


def conv3x3_relu_pool_cuda_core(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C on the CUDA cores (``csrc/conv3x3_relu_pool.cu``), the route of
    the widths ``relu_pool_route`` keeps off the tensor cores; CUDA tensors
    only."""
    cin, cout = _conv_shapes(x, w, b)
    _pool_dims(x)
    bsz, h, wd, _ = x.shape
    x = x.contiguous()
    wf = w.reshape(9 * cin, cout).contiguous()
    b = b.contiguous()
    pooled, idx = _pool_outputs(x, cout)
    fn = build.symbol("conv3x3_relu_pool", "st3d_conv3x3_relu_pool_"
                      + build.DTYPE_SUFFIX[x.dtype], 5, 5)
    err = fn(x.data_ptr(), wf.data_ptr(), b.data_ptr(), pooled.data_ptr(),
             idx.data_ptr(), bsz, h, wd, cin, cout,
             build.stream_handle(x.device))
    build.check(err, "conv3x3_relu_pool")
    LAUNCHES["conv3x3_relu_pool"] += 1
    return pooled, idx


def _route_shapes(ct, pooled, idx, w):
    if ct.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3):
        raise ValueError(
            f"pool_route_conv3x3_bwd: want ct (B,H/2,W/2,C) and w "
            f"(3,3,Cin,C), got {tuple(ct.shape)} and {tuple(w.shape)}")
    if pooled.shape != ct.shape or idx.shape != ct.shape or (
            w.shape[3] != ct.shape[3]):
        raise ValueError(
            f"pool_route_conv3x3_bwd: shape mismatch ct {tuple(ct.shape)}, "
            f"pooled {tuple(pooled.shape)}, idx {tuple(idx.shape)}, w "
            f"{tuple(w.shape)}")
    if idx.dtype != torch.uint8:
        raise TypeError(f"pool_route_conv3x3_bwd: idx must be uint8, got "
                        f"{idx.dtype}")
    return w.shape[2], w.shape[3]


def route_pool_cotangent(ct: torch.Tensor, pooled: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """(B,H/2,W/2,C) pooled cotangent -> (B,H,W,C) in ``ct.dtype``: each
    value masked by ``pooled > 0`` and put at the window position ``idx``
    names, zeros elsewhere."""
    bsz, hp, wp, c = ct.shape
    d = ct * (pooled > 0).to(ct.dtype)
    parts = torch.stack([d * (idx == q).to(ct.dtype) for q in range(4)], 3)
    return (parts.reshape(bsz, hp, wp, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(bsz, 2 * hp, 2 * wp, c))


def pool_route_conv3x3_bwd_plain(ct: torch.Tensor, pooled: torch.Tensor,
                                 idx: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pool_route_conv3x3_bwd``: the routed cotangent
    through K2's plain transpose conv (float32 sum, one rounding)."""
    cin, _ = _route_shapes(ct, pooled, idx, w)
    zb = torch.zeros(cin, dtype=ct.dtype, device=ct.device)
    return conv3x3_nhwc_plain(route_pool_cotangent(ct, pooled, idx),
                              transpose_weights(w, ct.dtype), zb)


def pool_route_conv3x3_bwd(ct: torch.Tensor, pooled: torch.Tensor,
                           idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``conv3x3_relu_pool`` with forward weights ``w``
    (3,3,Cin,C): dz (B,H,W,Cin) in ``ct.dtype`` from the pooled cotangent
    ``ct``, the forward's ``pooled`` and ``idx``."""
    cin, c = _route_shapes(ct, pooled, idx, w)
    if ct.device.type == "cpu":
        return pool_route_conv3x3_bwd_plain(ct, pooled, idx, w)
    build.check_operands("pool_route_conv3x3_bwd", ct, pooled)
    if idx.device != ct.device:
        raise ValueError(f"pool_route_conv3x3_bwd: idx on {idx.device}, "
                         f"ct on {ct.device}")
    route = pool_route(ct.dtype, c, cin)
    if route == "wgmma":
        return _pool_route_wgmma(ct, pooled, idx, w)
    if route == "tf32x3":
        return _pool_route_tf32x3(ct, pooled, idx, w)
    return pool_route_cuda_core(ct, pooled, idx, w)


def _pool_route_wgmma(ct: torch.Tensor, pooled: torch.Tensor,
                      idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """D on the tensor cores (bf16): ct, pooled, idx (B,H/2,W/2,C), the
    flipped, IO-transposed weights laid out (Cin, 3, 3, C), tiles of
    ``conv_tile`` over the full-resolution dz."""
    bsz, hp, wp, c = ct.shape
    cin = w.shape[2]
    ct, pooled, idx = _tma_ready(ct), _tma_ready(pooled), _tma_ready(idx)
    wk = transpose_weights(w, ct.dtype).permute(3, 0, 1, 2).contiguous()
    dz = torch.empty((bsz, 2 * hp, 2 * wp, cin), dtype=ct.dtype,
                     device=ct.device)
    bw = conv_tile(2 * wp)[0]
    pw, ph = pool_footprint(2 * wp)
    fn = build.symbol("pool_route_wgmma", "st3d_pool_route_wgmma_bf16", 5, 8)
    err = fn(ct.data_ptr(), pooled.data_ptr(), idx.data_ptr(), wk.data_ptr(),
             dz.data_ptr(), bsz, 2 * hp, 2 * wp, c, cin, bw, pw, ph,
             build.stream_handle(ct.device))
    build.check(err, "pool_route_wgmma")
    LAUNCHES["pool_route_wgmma"] += 1
    return dz


def _pool_route_tf32x3(ct: torch.Tensor, pooled: torch.Tensor,
                       idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """D in float32 on the tensor cores by the 3xTF32 split: ct, pooled,
    idx (B,H/2,W/2,C), the flipped, IO-transposed weights laid out (Cin, 3,
    3, C) and split by ``split_tf32``, tiles of ``conv_tile`` over the
    full-resolution dz."""
    bsz, hp, wp, c = ct.shape
    cin = w.shape[2]
    ct, pooled, idx = _tma_ready(ct), _tma_ready(pooled), _tma_ready(idx)
    w_hi, w_lo = split_tf32(
        transpose_weights(w, ct.dtype).permute(3, 0, 1, 2).contiguous())
    dz = torch.empty((bsz, 2 * hp, 2 * wp, cin), dtype=ct.dtype,
                     device=ct.device)
    bw = conv_tile(2 * wp)[0]
    pw, ph = pool_footprint(2 * wp)
    fn = build.symbol("pool_route_tf32x3", "st3d_pool_route_tf32x3_f32", 6, 8)
    err = fn(ct.data_ptr(), pooled.data_ptr(), idx.data_ptr(),
             w_hi.data_ptr(), w_lo.data_ptr(), dz.data_ptr(), bsz, 2 * hp,
             2 * wp, c, cin, bw, pw, ph, build.stream_handle(ct.device))
    build.check(err, "pool_route_tf32x3")
    LAUNCHES["pool_route_tf32x3"] += 1
    return dz


def pool_route_cuda_core(ct: torch.Tensor, pooled: torch.Tensor,
                         idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """D on the CUDA cores (``csrc/pool_route_conv3x3_bwd.cu``), the route
    of the widths ``pool_route`` keeps off the tensor cores; CUDA tensors
    only."""
    cin, c = _route_shapes(ct, pooled, idx, w)
    bsz, hp, wp, _ = ct.shape
    ct, pooled, idx = ct.contiguous(), pooled.contiguous(), idx.contiguous()
    wt = transpose_weights(w, ct.dtype).reshape(9 * c, cin).contiguous()
    dz = torch.empty((bsz, 2 * hp, 2 * wp, cin), dtype=ct.dtype,
                     device=ct.device)
    fn = build.symbol("pool_route_conv3x3_bwd", "st3d_pool_route_conv3x3_bwd_"
                      + build.DTYPE_SUFFIX[ct.dtype], 5, 5)
    err = fn(ct.data_ptr(), pooled.data_ptr(), idx.data_ptr(), wt.data_ptr(),
             dz.data_ptr(), bsz, 2 * hp, 2 * wp, c, cin,
             build.stream_handle(ct.device))
    build.check(err, "pool_route_conv3x3_bwd")
    LAUNCHES["pool_route_conv3x3_bwd"] += 1
    return dz


class _Conv3x3BiasReluPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        pooled, idx = conv3x3_relu_pool(x, w, b)
        ctx.save_for_backward(w, pooled, idx)
        ctx.mark_non_differentiable(idx)
        return pooled, idx

    @staticmethod
    def backward(ctx, ct_p, _ct_idx):
        w, pooled, idx = ctx.saved_tensors
        return (pool_route_conv3x3_bwd(ct_p.to(pooled.dtype), pooled, idx, w),
                None, None)


def conv3x3_bias_relu_pool_packed(x: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pooled, idx)`` of maxpool2x2(relu(conv3x3_same(x) + b)), NHWC x
    with even H and W, differentiable in ``x`` (conv_pallas.py:897, K5):
    forward ``conv3x3_relu_pool``, backward ``pool_route_conv3x3_bwd``. The
    TPU's space-to-depth packing has no counterpart; the name is kept."""
    return _Conv3x3BiasReluPool.apply(x, w, b)


# K8 (conv_pallas.py:505 ``conv3x3_bias_relu_pool``, the route
# ``ST3D_FUSED_POOL``) computes the same function for the pre-pool convs of
# any width, its backward (``_brp``, :527) masking by ``pooled > 0`` and
# routing by idx before the transpose conv: kernels C and D, under the JAX
# name.
conv3x3_bias_relu_pool = conv3x3_bias_relu_pool_packed
