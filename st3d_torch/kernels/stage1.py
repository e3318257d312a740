"""VGG stage 1 (conv1_1, ReLU, conv1_2, ReLU, pool1 and conv1_1's Gram),
counterpart of ``st3d/kernels/stage1_pallas.py`` (K4a-d).

Two autograd functions:

- ``conv1_1_relu_stats(x, w, b) -> (z, ptp27, s27)``: z = relu(conv1_1(x)
  + b) in x's dtype, and per image the float32 statistics PᵀP (27, 27) and
  s27 (27,) of the zero-padded 3x3 patches. Forward: kernel A
  ``conv1_1_stats`` (replaces K4a). Backward: kernel B ``conv1_1_bwd``
  (replaces K4c), which folds the statistics' cotangents into dx. Each has
  two kernels, chosen by ``c11_route``: bf16 on the tensor cores
  (``csrc/conv1_1_stats_wgmma.cu``: ``c11_stats_blocks`` persistent
  blocks per image over ``C11_STATS_TILE`` tiles, the patch tile built in
  shared memory, z and PᵀP by ``wgmma``; ``csrc/conv1_1_bwd_wgmma.cu``:
  ``c11_bwd_blocks`` persistent blocks, dz and z by TMA on the halo of a
  ``C11_BWD_TILE`` dx tile in two stages, dP by ``wgmma`` with S split
  into bf16 hi + lo) and float32 on the tensor cores by the 3xTF32 split
  (``csrc/conv1_1_stats_tf32x3.cu``, ``csrc/conv1_1_bwd_tf32x3.cu``: the
  same plans, every operand split into tf32 hi + lo, the A operands of the
  products split in registers).
- ``conv1_2_relu_pool(z, w, b) -> (pooled, idx)``: conv1_2 + ReLU + 2x2
  max-pool. Forward ``conv3x3_relu_pool`` (replaces K4b), backward
  ``pool_route_conv3x3_bwd`` (replaces K4d); both kernels live in
  ``kernels/conv.py``, because they are K5 too.

The pre-ReLU conv1_1 Gram is ``models.vgg.gram1_closed_form(ptp27, s27, w,
b, H*W)``; autograd of that small closed form gives the cotangents of ptp27
and s27, as XLA did around ``fold_gram48`` outside the TPU kernels. The
TPU's 48-wide quad statistics and packed z5 layout are artifacts of its
matrix unit; the 27-wide statistics give the same Gram to within float
reassociation, and z stays NHWC.

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch version
(defined beside it) for a CPU tensor, and nothing else; ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from st3d_torch.kernels import build
from st3d_torch.kernels.conv import (SMS, _tma_ready,
                                     conv3x3_bias_relu_pool_packed)

LAUNCHES: Dict[str, int] = {"conv1_1_stats_wgmma": 0,
                            "conv1_1_bwd_wgmma": 0,
                            "conv1_1_stats_tf32x3": 0,
                            "conv1_1_bwd_tf32x3": 0}

K27 = 27
C11_MAX_COUT = 128                # the bf16 tensor-core kernels keep W resident
C11_TF32_MAX_COUT = 64            # B's float32 stages fill a block's 227 KB
C11_STATS_TILE = (32, 4)          # (TW, TH) pixels of a tensor-core A tile
C11_STATS_BLOCKS_PER_SM = 2
C11_TF32_STATS_BLOCKS_PER_SM = 1  # its registers allow one block to an SM
C11_BWD_TILE = (22, 14)           # (TW, TH) dx pixels of a tensor-core B tile
# The tensor-core A and B of each route: A's and B's launch keys (and
# libraries), the C symbols' dtype suffix, A's blocks per SM and its
# 28 x 28 partials a block (one a warpgroup in bf16, folded in the block
# in float32).
_C11_TENSOR_CORES = {
    "wgmma": ("conv1_1_stats_wgmma", "conv1_1_bwd_wgmma", "bf16",
              C11_STATS_BLOCKS_PER_SM, 2),
    "tf32x3": ("conv1_1_stats_tf32x3", "conv1_1_bwd_tf32x3", "f32",
               C11_TF32_STATS_BLOCKS_PER_SM, 1),
}


def c11_route(dtype: torch.dtype, cout: int) -> str:
    """The kernel A and B take for a CUDA tensor: "wgmma"
    (``csrc/conv1_1_stats_wgmma.cu``, ``csrc/conv1_1_bwd_wgmma.cu``) for
    bf16 with Cout a multiple of 8 (the pixel rows of z and dz are Cout * 2
    bytes apart, and TMA strides are multiples of 16 bytes) and at most
    ``C11_MAX_COUT`` (the weights stay in shared memory); "tf32x3"
    (``csrc/conv1_1_stats_tf32x3.cu``, ``csrc/conv1_1_bwd_tf32x3.cu``) for
    float32 with Cout a multiple of 4 (rows Cout * 4 bytes apart) and at
    most ``C11_TF32_MAX_COUT`` = 64 (B's two stages of 32-channel dz and z
    boxes, 192 KB, leave room for the weights of two slabs only). Raises
    ``ValueError`` for any other dtype or Cout."""
    if dtype == torch.bfloat16 and cout % 8 == 0 and cout <= C11_MAX_COUT:
        return "wgmma"
    if dtype == torch.float32 and cout % 4 == 0 \
            and cout <= C11_TF32_MAX_COUT:
        return "tf32x3"
    raise build.no_route(
        "c11_route", dtype, f"bf16 takes Cout a multiple of 8 up to "
        f"{C11_MAX_COUT}, float32 a multiple of 4 up to {C11_TF32_MAX_COUT}",
        cout=cout)


def c11_stats_tiles(h: int, w: int) -> Tuple[int, int]:
    """(tiles_x, tiles_y) of the tensor-core A over an h x w image; tile t
    of an image is (t % tiles_x, t // tiles_x)."""
    tw, th = C11_STATS_TILE
    return -(-w // tw), -(-h // th)


def c11_stats_blocks(bsz: int, h: int, w: int,
                     per_sm: int = C11_STATS_BLOCKS_PER_SM) -> int:
    """Persistent blocks per image of the tensor-core A: about ``per_sm``
    blocks on each SM over the batch (``C11_STATS_BLOCKS_PER_SM`` in bf16,
    ``C11_TF32_STATS_BLOCKS_PER_SM`` in float32), never more than the
    image's tiles. Block c walks tiles c, c + blocks, ... of its image."""
    tiles_x, tiles_y = c11_stats_tiles(h, w)
    return max(1, min(tiles_x * tiles_y, -(-per_sm * SMS // bsz)))


def c11_bwd_tiles(h: int, w: int) -> Tuple[int, int]:
    """(tiles_x, tiles_y) of the tensor-core B over an h x w image."""
    tw, th = C11_BWD_TILE
    return -(-w // tw), -(-h // th)


def c11_bwd_blocks(bsz: int, h: int, w: int) -> int:
    """Persistent blocks of the tensor-core B: one on each SM (its two
    stages take most of an SM's shared memory), never more than the
    tiles. Block c walks tiles c, c + blocks, ... in raster order over
    (image, tile row, tile column)."""
    tiles_x, tiles_y = c11_bwd_tiles(h, w)
    return max(1, min(bsz * tiles_x * tiles_y, SMS))


def _c11_shapes(x: torch.Tensor, w: torch.Tensor) -> int:
    if x.dim() != 4 or x.shape[3] != 3 or w.shape[:3] != (3, 3, 3) \
            or w.dim() != 4:
        raise ValueError(
            f"conv1_1: want x (B,H,W,3) and w (3,3,3,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    return w.shape[3]


def patches27(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 27) float32 zero-padded 3x3 patches, order
    (dy, dx, c) as in the HWIO flatten of the weights."""
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                      for dy in range(3) for dx in range(3)], dim=-1)


# ---------------------------------------------------------------------------
# Kernel A: conv1_1 + bias + ReLU and the patch statistics
# ---------------------------------------------------------------------------

def conv1_1_stats_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``conv1_1_stats``: float32 patches, one rounding of
    z into ``x.dtype``, float32 statistics."""
    cout = _c11_shapes(x, w)
    p = patches27(x)
    z = torch.relu(p @ w.reshape(K27, cout).float() + b.float()).to(x.dtype)
    flat = p.reshape(x.shape[0], -1, K27)
    return z, flat.transpose(1, 2) @ flat, flat.sum(dim=1)


def conv1_1_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A: (z (B,H,W,Cout) in ``x.dtype``, PᵀP (B,27,27) float32, s27
    (B,27) float32) for x (B,H,W,3), w HWIO (3,3,3,Cout), b (Cout,)."""
    cout = _c11_shapes(x, w)
    if b.shape != (cout,):
        raise ValueError(f"conv1_1: bias {tuple(b.shape)}, want ({cout},)")
    if x.device.type == "cpu":
        return conv1_1_stats_plain(x, w, b)
    build.check_operands("conv1_1_stats", x, w, b)
    return _conv1_1_stats_tensor_cores(x, w, b, c11_route(x.dtype, cout))


def _conv1_1_stats_tensor_cores(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor, route: str
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """A on the tensor cores (``route`` "wgmma" or "tf32x3"):
    ``c11_stats_blocks`` persistent blocks per image; each lays out the
    weights with the bias as their row 27 (the patch tile's ones column)
    itself, in float32 split into tf32 hi + lo."""
    key, _, suffix, per_sm, parts = _C11_TENSOR_CORES[route]
    bsz, h, wd, _ = x.shape
    cout = w.shape[3]
    x = x.contiguous()
    w27, b = w.reshape(K27, cout).contiguous(), b.contiguous()
    blocks = c11_stats_blocks(bsz, h, wd, per_sm)
    dev = x.device
    z = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=dev)
    partial = torch.empty((bsz, blocks, parts, 28, 28), dtype=torch.float32,
                          device=dev)
    ptp = torch.empty((bsz, K27, K27), dtype=torch.float32, device=dev)
    s27 = torch.empty((bsz, K27), dtype=torch.float32, device=dev)
    fn = build.symbol(key, f"st3d_{key}_{suffix}", 7, 5)
    err = fn(x.data_ptr(), w27.data_ptr(), b.data_ptr(), z.data_ptr(),
             partial.data_ptr(), ptp.data_ptr(), s27.data_ptr(), bsz, h, wd,
             cout, blocks, build.stream_handle(dev))
    build.check(err, key)
    LAUNCHES[key] += 1
    return z, ptp, s27


# ---------------------------------------------------------------------------
# Kernel B: conv1_1's input gradient with the statistics' cotangents folded
# ---------------------------------------------------------------------------

def conv1_1_bwd_plain(x: torch.Tensor, dz: torch.Tensor, z: torch.Tensor,
                      w: torch.Tensor, sym: torch.Tensor,
                      ds27: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv1_1_bwd``: the float32 patch cotangent
    dP = (dz·[z>0]) W27ᵀ + P·sym + ds27, scattered back onto the padded
    image, one rounding into ``x.dtype``."""
    cout = _c11_shapes(x, w)
    bsz, h, wd, _ = x.shape
    p = patches27(x)
    d = torch.where(z > 0, dz.float(), torch.zeros((), device=dz.device))
    dp = (d @ w.reshape(K27, cout).float().T
          + (p.reshape(bsz, -1, K27) @ sym.float()).reshape(p.shape)
          + ds27.float()[:, None, None, :])
    dxp = torch.zeros((bsz, h + 2, wd + 2, 3), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            k = (dy * 3 + dx) * 3
            dxp[:, dy:dy + h, dx:dx + wd, :] += dp[..., k:k + 3]
    return dxp[:, 1:h + 1, 1:wd + 1, :].to(x.dtype)


def conv1_1_bwd(x: torch.Tensor, dz: torch.Tensor, z: torch.Tensor,
                w: torch.Tensor, sym: torch.Tensor,
                ds27: torch.Tensor) -> torch.Tensor:
    """Kernel B: dx (B,H,W,3) in ``x.dtype`` from the forward's x, z and w,
    the cotangent dz of z, sym = dPᵀP + dPᵀPᵀ (B,27,27) and ds27 (B,27)."""
    cout = _c11_shapes(x, w)
    bsz = x.shape[0]
    if dz.shape != z.shape or z.shape != x.shape[:3] + (cout,):
        raise ValueError(f"conv1_1_bwd: dz {tuple(dz.shape)} / z "
                         f"{tuple(z.shape)} do not match x {tuple(x.shape)}")
    if sym.shape != (bsz, K27, K27) or ds27.shape != (bsz, K27):
        raise ValueError(f"conv1_1_bwd: sym {tuple(sym.shape)}, ds27 "
                         f"{tuple(ds27.shape)}")
    if x.device.type == "cpu":
        return conv1_1_bwd_plain(x, dz, z, w, sym, ds27)
    _check_bwd_operands(x, dz, z, w, sym, ds27)
    return _conv1_1_bwd_tensor_cores(x, dz, z, w, sym, ds27,
                                     c11_route(x.dtype, cout))


def _check_bwd_operands(x, dz, z, w, sym, ds27) -> None:
    build.check_operands("conv1_1_bwd", x, dz, z, w)
    for t in (sym, ds27):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"conv1_1_bwd: sym and ds27 must be float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")


def _conv1_1_bwd_tensor_cores(x: torch.Tensor, dz: torch.Tensor,
                              z: torch.Tensor, w: torch.Tensor,
                              sym: torch.Tensor, ds27: torch.Tensor,
                              route: str) -> torch.Tensor:
    """B on the tensor cores (``route`` "wgmma" or "tf32x3"): tiles of
    ``C11_BWD_TILE``, ``c11_bwd_blocks`` persistent blocks; each reads the
    (27, Cout) weights as Wᵀ's K-major tile and splits S (with ds27 as its
    row 27) into hi + lo itself (bf16 parts, or tf32 parts with the
    weights split too)."""
    _, key, suffix, _, _ = _C11_TENSOR_CORES[route]
    bsz, h, wd, _ = x.shape
    cout = w.shape[3]
    x, sym, ds27 = x.contiguous(), sym.contiguous(), ds27.contiguous()
    dz, z = _tma_ready(dz), _tma_ready(z)
    w27 = _tma_ready(w.reshape(K27, cout))
    dx = torch.empty_like(x)
    fn = build.symbol(key, f"st3d_{key}_{suffix}", 7, 5)
    err = fn(x.data_ptr(), dz.data_ptr(), z.data_ptr(), w27.data_ptr(),
             sym.data_ptr(), ds27.data_ptr(), dx.data_ptr(), bsz, h, wd, cout,
             c11_bwd_blocks(bsz, h, wd), build.stream_handle(x.device))
    build.check(err, key)
    LAUNCHES[key] += 1
    return dx


# ---------------------------------------------------------------------------
# The autograd functions
# ---------------------------------------------------------------------------

class _Conv11ReluStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        z, ptp, s27 = conv1_1_stats(x, w, b)
        ctx.save_for_backward(x, z, w)
        return z, ptp, s27

    @staticmethod
    def backward(ctx, dz, dptp, ds27):
        x, z, w = ctx.saved_tensors
        # d(PᵀP)/dP applied to dPᵀP is P·(dPᵀP + dPᵀPᵀ) (stage1_pallas.py:640).
        sym = (dptp + dptp.transpose(-1, -2)).float()
        return conv1_1_bwd(x, dz.to(z.dtype), z, w, sym, ds27.float()), \
            None, None


def conv1_1_relu_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z, PᵀP, s27) of conv1_1, differentiable in ``x`` through all three
    (stage1_pallas.py:749 ``conv1_1_packed``, unpacked)."""
    return _Conv11ReluStats.apply(x, w, b)


def conv1_2_relu_pool(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, idx) of maxpool2x2(relu(conv1_2(z) + b)) from the NHWC
    conv1_1 activation, differentiable in ``z`` (stage1_pallas.py:801
    ``conv1_2_packed_pool``): kernels ``conv3x3_relu_pool`` and
    ``pool_route_conv3x3_bwd``."""
    return conv3x3_bias_relu_pool_packed(z, w, b)
