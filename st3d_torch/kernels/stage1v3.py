"""VGG stage 1, v3 (conv1_1, ReLU and the direct Gram of conv1_1's pre-ReLU
output; conv1_2, ReLU and pool1), counterpart of
``st3d/kernels/stage1v3_pallas.py`` (K10a-d), the route ``ST3D_STAGE1=v3``
of ``models.vgg.get_features``.

- ``conv1_1_relu_gram(x, w, b) -> (z, g64)``: z = relu(y) in x's dtype and
  per image the float32 Gram g64 = y_rᵀ y_r (64, 64) of y rounded to x's
  dtype, y = conv1_1(x) + b; differentiable in x through both. Forward:
  kernel E ``conv1_1_gram`` (replaces K10a). Backward: kernel F
  ``conv1_1_gram_bwd`` (replaces K10b). Each takes the tensor cores, the
  kernel chosen by ``v3_route``: bf16 (``csrc/conv1_1_gram_wgmma.cu``:
  kernel A's plan, ``c11_stats_blocks`` persistent blocks per image over
  ``C11_STATS_TILE`` tiles, y and the Gram by ``wgmma`` from one staged
  y_r tile; ``csrc/conv1_1_gram_bwd_wgmma.cu``: kernel B's plan,
  ``c11_bwd_blocks`` persistent blocks over ``C11_BWD_TILE`` tiles, dz by
  TMA, y recomputed and d and dP by ``wgmma`` with their A operands in
  registers, S split into bf16 hi + lo by ``split_bf16``) and float32 by
  the 3xTF32 split (``csrc/conv1_1_gram_tf32x3.cu``: the same plan, y by
  the A fragments split in registers, the Gram as HH + LH + LHᵀ from a
  transposed, split y tile; ``csrc/conv1_1_gram_bwd_tf32x3.cu``: the same
  plan with 32-channel dz slabs, dP = (dz·mask)·Wᵀ + y·M with M = S·Wᵀ
  formed in the kernel; y from one device function shared by the two, so
  F's mask is E's z > 0).
- ``conv1_2_relu_pool_v3``: K10c and K10d compute the function of v2's
  conv1_2 half, so they are kernels C and D (``kernels.stage1``).

The rounding points are the TPU kernels' (stage1v3_pallas.py:135-151,
264-275, 397-403, 603-628): weights and bias in the compute dtype, float32
accumulation; z and y_r each rounded once; the backward recomputes y in
float32, masks by y > 0, forms d = dz·mask + y_r·(dG + dGᵀ) in float32,
rounds d once and takes its transpose conv (64 -> 3) with float32
accumulation. This Gram is not kernel A's closed form: in bf16 the two
differ systematically by the rounding of y (ROADMAP "Parity hazards").
The TPU's phase-packed z5 is a reshape of NHWC; z stays NHWC.

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch version
(defined beside it) for a CPU tensor, and nothing else; ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from st3d_torch.kernels import build
from st3d_torch.kernels.conv import (_tma_ready, conv3x3_nhwc_plain,
                                     transpose_weights)
from st3d_torch.kernels.stage1 import (C11_STATS_BLOCKS_PER_SM,
                                       C11_TF32_STATS_BLOCKS_PER_SM, K27,
                                       c11_bwd_blocks, c11_stats_blocks,
                                       conv1_2_relu_pool, patches27)

LAUNCHES: Dict[str, int] = {"conv1_1_gram_wgmma": 0,
                            "conv1_1_gram_bwd_wgmma": 0,
                            "conv1_1_gram_tf32x3": 0,
                            "conv1_1_gram_bwd_tf32x3": 0}

COUT = 64

# K10c and K10d compute exactly the function of v2's conv1_2 + ReLU + pool
# and its routed backward: kernels C and D.
conv1_2_relu_pool_v3 = conv1_2_relu_pool


# The tensor-core E and F of each route: E's and F's launch keys (and
# libraries), the C symbols' dtype suffix, E's blocks per SM and its 64 x 64
# partials a block (one a warpgroup in bf16, folded in the block in
# float32).
_V3_TENSOR_CORES = {
    "wgmma": ("conv1_1_gram_wgmma", "conv1_1_gram_bwd_wgmma", "bf16",
              C11_STATS_BLOCKS_PER_SM, 2),
    "tf32x3": ("conv1_1_gram_tf32x3", "conv1_1_gram_bwd_tf32x3", "f32",
               C11_TF32_STATS_BLOCKS_PER_SM, 1),
}


def v3_route(dtype: torch.dtype) -> str:
    """The kernel E and F take for a CUDA tensor (Cout is always 64, one
    ``wgmma`` N tile): "wgmma" (``csrc/conv1_1_gram_wgmma.cu``,
    ``csrc/conv1_1_gram_bwd_wgmma.cu``) for bf16, "tf32x3"
    (``csrc/conv1_1_gram_tf32x3.cu``, ``csrc/conv1_1_gram_bwd_tf32x3.cu``)
    for float32. Raises ``ValueError`` for any other dtype, which the
    wrappers' ``build.check_operands`` has refused already."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "tf32x3"
    raise build.no_route("v3_route", dtype, "E and F take bf16 or float32",
                         cout=COUT)


def split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` as bf16 ``(hi, lo)``: hi = t rounded to bf16, lo =
    t - hi (exact in float32) rounded to bf16, so hi + lo is t to 2⁻¹⁶ of
    each value. F's tensor-core kernel takes S this way."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _operands(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks x (B,H,W,3), w (3,3,3,64), b (64,); returns w flattened to
    (27, 64) and b, both in x's dtype."""
    if x.dim() != 4 or x.shape[3] != 3 or tuple(w.shape) != (3, 3, 3, COUT) \
            or tuple(b.shape) != (COUT,):
        raise ValueError(
            f"conv1_1 v3: want x (B,H,W,3), w (3,3,3,{COUT}), b ({COUT},), "
            f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    return w.reshape(K27, COUT).to(x.dtype), b.to(x.dtype)


def _pre_relu(x: torch.Tensor, w27: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """float32 y = conv1_1(x) + b from the zero-padded patches."""
    return patches27(x) @ w27.float() + b.float()


# ---------------------------------------------------------------------------
# Kernel E: conv1_1 + bias + ReLU and the direct pre-ReLU Gram
# ---------------------------------------------------------------------------

def conv1_1_gram_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``conv1_1_gram``: z = relu(y) and y_r rounded once
    to ``x.dtype`` from the float32 y; g64 in float32 from y_r."""
    w27, b = _operands(x, w, b)
    y = _pre_relu(x, w27, b)
    yr = y.to(x.dtype).float().reshape(x.shape[0], -1, COUT)
    return torch.relu(y).to(x.dtype), yr.transpose(1, 2) @ yr


def conv1_1_gram(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E: (z (B,H,W,64) in ``x.dtype``, g64 (B,64,64) float32) for x
    (B,H,W,3), w HWIO (3,3,3,64), b (64,); w and b are cast to x's dtype."""
    w27, b = _operands(x, w, b)
    if x.device.type == "cpu":
        return conv1_1_gram_plain(x, w, b)
    build.check_operands("conv1_1_gram", x, w27, b)
    return _conv1_1_gram_tensor_cores(x, w27, b, v3_route(x.dtype))


def _conv1_1_gram_tensor_cores(x: torch.Tensor, w27: torch.Tensor,
                               b: torch.Tensor, route: str
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E on the tensor cores of ``route`` ("wgmma" or "tf32x3"):
    ``c11_stats_blocks`` persistent blocks per image, each writing one 64
    x 64 partial per warpgroup (bf16) or per block (float32, HH + LH + LHᵀ
    folded in the block) that a second pass adds in order."""
    key, _, suffix, per_sm, parts = _V3_TENSOR_CORES[route]
    bsz, h, wd, _ = x.shape
    x, w27, b = x.contiguous(), w27.contiguous(), b.contiguous()
    blocks = c11_stats_blocks(bsz, h, wd, per_sm)
    dev = x.device
    z = torch.empty((bsz, h, wd, COUT), dtype=x.dtype, device=dev)
    partial = torch.empty((bsz, blocks, parts, COUT, COUT),
                          dtype=torch.float32, device=dev)
    g64 = torch.empty((bsz, COUT, COUT), dtype=torch.float32, device=dev)
    fn = build.symbol(key, f"st3d_{key}_{suffix}", 6, 4)
    err = fn(x.data_ptr(), w27.data_ptr(), b.data_ptr(), z.data_ptr(),
             partial.data_ptr(), g64.data_ptr(), bsz, h, wd, blocks,
             build.stream_handle(dev))
    build.check(err, key)
    LAUNCHES[key] += 1
    return z, g64


# ---------------------------------------------------------------------------
# Kernel F: conv1_1's input gradient with the Gram cotangent folded in
# ---------------------------------------------------------------------------

def conv1_1_gram_bwd_plain(x: torch.Tensor, dz: torch.Tensor,
                           w: torch.Tensor, b: torch.Tensor,
                           sym: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version of ``conv1_1_gram_bwd``: d = dz·[y > 0] + y_r·sym in
    float32, rounded once to ``x.dtype``, then K2's plain transpose conv
    (float32 sum, one rounding). ``mask`` (B,H,W,64) bool, if given, stands
    for [y > 0]: a kernel's own forward's z > 0, which a check holds a
    kernel's dx against where its y and the plain y straddle 0."""
    w27, b = _operands(x, w, b)
    bsz = x.shape[0]
    y = _pre_relu(x, w27, b)
    yr = y.to(x.dtype).float().reshape(bsz, -1, COUT)
    keep = y > 0 if mask is None else mask
    d = (torch.where(keep, dz.float(), torch.zeros((), device=dz.device))
         + (yr @ sym.float()).reshape(y.shape)).to(x.dtype)
    zb = torch.zeros(3, dtype=x.dtype, device=x.device)
    return conv3x3_nhwc_plain(d, transpose_weights(w, x.dtype), zb)


def conv1_1_gram_bwd(x: torch.Tensor, dz: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Kernel F: dx (B,H,W,3) in ``x.dtype`` from the forward's x, w and b,
    the cotangent dz (B,H,W,64) of z and sym = dG + dGᵀ (B,64,64) float32
    of g64."""
    w27, b = _operands(x, w, b)
    bsz = x.shape[0]
    if dz.shape != x.shape[:3] + (COUT,):
        raise ValueError(f"conv1_1_gram_bwd: dz {tuple(dz.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if sym.shape != (bsz, COUT, COUT):
        raise ValueError(f"conv1_1_gram_bwd: sym {tuple(sym.shape)}, want "
                         f"{(bsz, COUT, COUT)}")
    if x.device.type == "cpu":
        return conv1_1_gram_bwd_plain(x, dz, w, b, sym)
    _check_bwd_operands(x, dz, w27, b, sym)
    return _conv1_1_gram_bwd_tensor_cores(x, dz, w27, b, sym,
                                          v3_route(x.dtype))


def _check_bwd_operands(x, dz, w27, b, sym) -> None:
    build.check_operands("conv1_1_gram_bwd", x, dz, w27, b)
    if sym.device != x.device or sym.dtype != torch.float32:
        raise ValueError(f"conv1_1_gram_bwd: sym must be float32 on "
                         f"{x.device}, got {sym.dtype} on {sym.device}")


def _conv1_1_gram_bwd_tensor_cores(x: torch.Tensor, dz: torch.Tensor,
                                   w27: torch.Tensor, b: torch.Tensor,
                                   sym: torch.Tensor, route: str
                                   ) -> torch.Tensor:
    """F on the tensor cores of ``route``: tiles of ``C11_BWD_TILE``,
    ``c11_bwd_blocks`` persistent blocks. In bf16 S goes in as Sᵀ split by
    ``split_bf16``, (B, 2, 64, 64), so that row o of each part is S[:, o],
    the K-major B tile of y_r·S; in float32 S goes in as it is, and the
    kernel forms M = S·Wᵀ and splits it."""
    _, key, suffix, _, _ = _V3_TENSOR_CORES[route]
    bsz, h, wd, _ = x.shape
    x, b = x.contiguous(), b.contiguous()
    dz, w27 = _tma_ready(dz), _tma_ready(w27)
    s = (torch.stack(split_bf16(sym.transpose(1, 2)), dim=1)
         if route == "wgmma" else _tma_ready(sym))
    dx = torch.empty_like(x)
    fn = build.symbol(key, f"st3d_{key}_{suffix}", 6, 4)
    err = fn(x.data_ptr(), dz.data_ptr(), w27.data_ptr(), b.data_ptr(),
             s.data_ptr(), dx.data_ptr(), bsz, h, wd,
             c11_bwd_blocks(bsz, h, wd), build.stream_handle(x.device))
    build.check(err, key)
    LAUNCHES[key] += 1
    return dx


# ---------------------------------------------------------------------------
# The autograd function
# ---------------------------------------------------------------------------

class _Conv11Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        z, g64 = conv1_1_gram(x, w, b)
        ctx.save_for_backward(x, w, b)
        return z, g64

    @staticmethod
    def backward(ctx, dz, dg):
        x, w, b = ctx.saved_tensors
        # d(yᵀy)/dy applied to dG is y·(dG + dGᵀ) (stage1v3_pallas.py:603).
        sym = (dg + dg.transpose(-1, -2)).float()
        return conv1_1_gram_bwd(x, dz.to(x.dtype), w, b, sym), None, None


def conv1_1_relu_gram(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, g64) of conv1_1, differentiable in ``x`` through both
    (stage1v3_pallas.py:541 ``conv1_1_packed_v3``, unpacked)."""
    return _Conv11Gram.apply(x, w, b)
