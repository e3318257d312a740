"""Which K2, K3, C and D kernel a CUDA tensor takes, and the tensor-core
kernels' tile plans, as the pure functions of ``st3d_torch.kernels.conv``
(no GPU): ``conv_route`` (bf16 with channel counts that are multiples of 8
and float32 with multiples of 4 take the TMA-fed tensor-core kernels, the
latter by 3xTF32; the other widths of both dtypes the narrow tensor-core
kernels wherever ``narrow_nb`` finds a plan), ``narrow_nb`` and
``narrow_smem`` (the narrow kernels' plan), ``gram_route`` (bf16, multiples
of 8; float32, multiples of 4, by 3xTF32; the other widths up to 32 of
both dtypes the narrow tensor-core kernel), ``relu_pool_route``
(``conv_route``'s TMA rules), ``pool_route`` (bf16 with C a multiple of 16
and Cin of 8; float32 with C a multiple of 16 and Cin of 4, by 3xTF32);
every route function refuses any other dtype or width with a
``ValueError`` that names them, and every width VGG meets has a route;
``conv_tile`` (the 128-pixel output box per image
width), ``pool_tile`` (the same box holding whole 2x2 windows),
``pool_footprint`` (the pooled box D loads per tile) and ``gram_split``
(slices that cover the pixels exactly, in whole steps, with enough blocks
for the card)."""

import re

import pytest
import torch

from st3d_torch.kernels import conv as kconv
from st3d_torch.kernels import stage1 as ks1
from st3d_torch.kernels import stage1v3 as ks3
from st3d_torch.models import vgg

BF16, F32 = torch.bfloat16, torch.float32
REFUSED = None      # no kernel takes the dtype or widths: the route raises


def assert_route(fn, want, dtype, **widths):
    """``fn(dtype, *widths)`` returns ``want``, or, where ``want`` is
    ``REFUSED``, raises ``ValueError`` naming the function, the dtype and
    the widths."""
    if want is not REFUSED:
        assert fn(dtype, *widths.values()) == want
        return
    shown = ", ".join(f"{k}={v}" for k, v in widths.items())
    with pytest.raises(ValueError, match=re.escape(
            f"{fn.__name__}: no kernel takes {dtype} at {shown}: ")):
        fn(dtype, *widths.values())


@pytest.mark.parametrize("dtype,cin,cout,route", [
    (BF16, 64, 64, "wgmma"), (BF16, 512, 512, "wgmma"),
    (BF16, 128, 64, "wgmma"), (BF16, 8, 16, "wgmma"), (BF16, 40, 24, "wgmma"),
    (BF16, 3, 64, "narrow_wgmma"), (BF16, 64, 27, "narrow_wgmma"),
    (BF16, 12, 64, "narrow_wgmma"), (F32, 64, 64, "tf32x3"),
    (F32, 512, 512, "tf32x3"), (torch.float16, 64, 64, REFUSED),
    (F32, 4, 8, "tf32x3"), (F32, 40, 24, "tf32x3"),
    (F32, 3, 64, "narrow_tf32x3"), (F32, 64, 27, "narrow_tf32x3"),
    (F32, 64, 3, "narrow_tf32x3"), (F32, 6, 64, "narrow_tf32x3"),
    (BF16, 64, 3, "narrow_wgmma"), (torch.float16, 3, 64, REFUSED),
    (F32, 256, 3, REFUSED), (BF16, 512, 3, "narrow_wgmma")])
def test_conv_route(dtype, cin, cout, route):
    assert_route(kconv.conv_route, route, dtype, cin=cin, cout=cout)


@pytest.mark.parametrize("dtype,cin,cout,nb", [
    (BF16, 3, 64, 64), (BF16, 64, 3, 8), (BF16, 5, 12, 16), (BF16, 12, 5, 8),
    (BF16, 3, 96, 64), (F32, 3, 64, 64), (F32, 64, 3, 8), (F32, 12, 5, 8),
    (F32, 3, 30, 32), (F32, 256, 3, None)])
def test_narrow_plan_fits_a_block(dtype, cin, cout, nb):
    """The narrow K2's output channels a block, and its shared memory at
    every tile width within a block's (two blocks an SM at conv1_1's
    3 -> 64 and, in bf16, its 64 -> 3 input gradient); None (no route)
    where 8 channels overflow."""
    assert kconv.narrow_nb(dtype, cin, cout) == nb
    if nb is None:
        return
    esize = torch.tensor([], dtype=dtype).element_size()
    widths = [2 ** i for i in range(kconv.NARROW_MAX_BW.bit_length())]
    smem = [kconv.narrow_smem(esize, cin, cout, nb, bw) for bw in widths]
    assert max(smem) <= kconv.SMEM_LIMIT
    if (cin, cout) == (3, 64) or (dtype == BF16 and (cin, cout) == (64, 3)):
        assert 2 * (smem[-1] + 1024) <= 233472


# (dtype, C pooled channels, Cin input channels of the conv, route).
@pytest.mark.parametrize("dtype,c,cin,route", [
    (BF16, 64, 64, "wgmma"), (BF16, 128, 128, "wgmma"),
    (BF16, 512, 512, "wgmma"), (BF16, 16, 8, "wgmma"), (BF16, 48, 24, "wgmma"),
    (BF16, 40, 24, REFUSED), (BF16, 8, 64, REFUSED),
    (BF16, 64, 3, REFUSED), (BF16, 64, 12, REFUSED),
    (F32, 64, 64, "tf32x3"), (F32, 512, 512, "tf32x3"),
    (torch.float16, 64, 64, REFUSED), (F32, 128, 128, "tf32x3"),
    (F32, 16, 4, "tf32x3"), (F32, 48, 24, "tf32x3"), (F32, 8, 64, REFUSED),
    (F32, 40, 24, REFUSED), (F32, 64, 6, REFUSED),
    (F32, 64, 3, REFUSED)])
def test_pool_route(dtype, c, cin, route):
    assert_route(kconv.pool_route, route, dtype, c=c, cin=cin)


# (dtype, Cin, Cout, route) of the forward C.
@pytest.mark.parametrize("dtype,cin,cout,route", [
    (BF16, 64, 64, "wgmma"), (BF16, 128, 128, "wgmma"),
    (BF16, 512, 512, "wgmma"), (BF16, 24, 40, "wgmma"),
    (BF16, 3, 64, REFUSED), (BF16, 64, 12, REFUSED),
    (F32, 64, 64, "tf32x3"), (F32, 512, 512, "tf32x3"),
    (torch.float16, 64, 64, REFUSED), (F32, 128, 128, "tf32x3"),
    (F32, 24, 40, "tf32x3"), (F32, 4, 8, "tf32x3"), (F32, 3, 64, REFUSED),
    (F32, 64, 6, REFUSED), (F32, 6, 64, REFUSED),
    (F32, 64, 27, REFUSED)])
def test_relu_pool_route(dtype, cin, cout, route):
    assert_route(kconv.relu_pool_route, route, dtype, cin=cin, cout=cout)


def test_pool_tile_holds_whole_windows():
    """At every even width from 2 to 1024: a 128-pixel box with both sides
    even, BW a power of two covering the width up to 64, and boxes at even
    origins that tile the image (each pixel in exactly one box, each 2x2
    window inside one box)."""
    for width in range(2, 1025, 2):
        bw, bh = kconv.pool_tile(width)
        assert bw * bh == kconv.CONV_TILE_PIXELS
        assert bw % 2 == 0 and bh % 2 == 0 and bw & (bw - 1) == 0
        assert bw == min(kconv.conv_tile(width)[0], kconv.POOL_TILE_WIDTH)
        assert bw >= width or bw == kconv.POOL_TILE_WIDTH
        # Box origins along x; the same holds along y with bh.
        for side, n in ((bw, width), (bh, width)):
            starts = range(0, n, side)
            covered = [x for x0 in starts for x in range(x0, min(x0 + side, n))]
            assert covered == list(range(n))
            assert all(x0 % 2 == 0 for x0 in starts)


@pytest.mark.parametrize("width,box", [(2, (2, 64)), (4, (4, 32)),
                                       (20, (32, 4)), (64, (64, 2)),
                                       (128, (64, 2)), (512, (64, 2))])
def test_pool_tile(width, box):
    assert kconv.pool_tile(width) == box


@pytest.mark.parametrize("width", [8, 10, 16, 20, 24, 32, 40, 64, 100, 128,
                                   256, 500, 512])
def test_pool_footprint_covers_every_tap(width):
    """Every full-resolution pixel a tile's taps read (the box plus its
    one-pixel halo) falls in the pooled box at ((x0 - 1) >> 1, (y0 - 1) >> 1)
    of ``pool_footprint``'s size, for every tile of a width x width image,
    and the box fits the kernel's 132-pixel buffer."""
    bw, bh = kconv.conv_tile(width)
    pw, ph = kconv.pool_footprint(width)
    assert pw * ph <= 132
    for x0 in range(0, width, bw):
        for y0 in range(0, width, bh):
            px0, py0 = (x0 - 1) >> 1, (y0 - 1) >> 1
            cols = {(x >> 1) - px0 for x in range(x0 - 1, x0 + bw + 1)}
            rows = {(y >> 1) - py0 for y in range(y0 - 1, y0 + bh + 1)}
            assert cols == set(range(pw)) and rows == set(range(ph))


@pytest.mark.parametrize("dtype,c,route", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 512, "wgmma"),
    (BF16, 136, "wgmma"), (BF16, 27, "narrow"), (BF16, 4, "narrow"),
    (F32, 128, "tf32x3"), (F32, 27, "narrow"), (F32, 64, "tf32x3"),
    (F32, 512, "tf32x3"), (F32, 4, "tf32x3"), (F32, 136, "tf32x3"),
    (F32, 6, "narrow"), (F32, 30, "narrow"), (BF16, 33, REFUSED),
    (F32, 33, REFUSED), (torch.float16, 128, REFUSED),
    (torch.float16, 27, REFUSED)])
def test_gram_route(dtype, c, route):
    assert_route(kconv.gram_route, route, dtype, c=c)


@pytest.mark.parametrize("width,box", [
    (1, (1, 128)), (3, (4, 32)), (4, (4, 32)), (8, (8, 16)), (12, (16, 8)),
    (20, (32, 4)), (32, (32, 4)), (64, (64, 2)), (100, (128, 1)),
    (128, (128, 1)), (512, (128, 1))])
def test_conv_tile(width, box):
    bw, bh = kconv.conv_tile(width)
    assert (bw, bh) == box
    assert bw * bh == kconv.CONV_TILE_PIXELS and bw & (bw - 1) == 0
    # The box covers the width, or is as wide as a tile can be.
    assert bw >= width or bw == kconv.CONV_TILE_PIXELS
    assert bw < 2 * width


# (batch, pixels, C): the style Grams at 512² (conv2_1 .. conv5_1), the 64²
# ones, pixel counts off the 64-pixel box, conv1_1's 27-wide patch Gram;
# then the cells' own at 768² (batches of 4 and 12 views, the NNFM cell's
# 6 style images, its 27-wide patch Gram with stage 1 off).
SPLITS = [(4, 256 * 256, 128), (4, 128 * 128, 256), (4, 64 * 64, 512),
          (4, 32 * 32, 512), (4, 512 * 512, 64), (2, 32 * 32, 128),
          (2, 4 * 4, 512), (3, 37 * 29, 64), (3, 4113, 512), (1, 7, 3),
          (4, 512 * 512, 27), (4, 384 * 384, 128), (12, 384 * 384, 128),
          (4, 192 * 192, 256), (12, 96 * 96, 512), (6, 48 * 48, 512),
          (4, 768 * 768, 27)]


@pytest.mark.parametrize("route", ["wgmma", "tf32x3", "narrow"])
@pytest.mark.parametrize("bsz,pixels,c", SPLITS)
def test_gram_split_covers_pixels(route, bsz, pixels, c):
    edge, triangle, step, min_slice, _ = kconv.GRAM_PLAN[route]
    slices, slice_len = kconv.gram_split(bsz, pixels, c, route)
    assert slice_len % step == 0 and bsz * slices <= 65535
    assert (slices - 1) * slice_len < pixels <= slices * slice_len
    assert slices == 1 or slice_len >= min_slice
    # Blocks: one per SM at least, where the shortest slice allows it.
    t = -(-c // edge)
    assert kconv.gram_tiles(c, route) == (t * (t + 1) // 2 if triangle
                                          else t * t)
    blocks = bsz * slices * kconv.gram_tiles(c, route)
    most = bsz * max(1, pixels // min_slice) * kconv.gram_tiles(c, route)
    assert blocks >= min(kconv.SMS, most)


@pytest.mark.parametrize("h,c", [(256, 128), (128, 256), (64, 512),
                                 (32, 512)])
def test_gram_split_fills_the_card_at_the_style_taps(h, c):
    """At 512² x 4 views every style Gram runs at least one block per SM."""
    slices, _ = kconv.gram_split(4, h * h, c)
    assert 4 * slices * kconv.gram_tiles(c) >= kconv.SMS


@pytest.mark.parametrize("h,c", [(256, 128), (128, 256), (64, 512),
                                 (32, 512)])
def test_gram_split_fills_the_card_at_the_style_taps_tf32x3(h, c):
    """The float32 route at 512² x 4 views: at least one block per SM at
    every style Gram, slices of whole 32-pixel boxes."""
    slices, slice_len = kconv.gram_split(4, h * h, c, "tf32x3")
    assert slice_len % 32 == 0
    assert 4 * slices * kconv.gram_tiles(c, "tf32x3") >= kconv.SMS


# The float32 K2's tile: a 128-pixel box that pads the image least,
# ``conv_tile``'s where it is one (at 768², 384², every VGG layer at 512²
# and every image narrower than a box), else the widest; at 768² VGG's
# 192-, 96- and 48-wide layers get boxes that fit them exactly, and images
# that no box fits (100 x 60, 300 x 200, 3 x 1000) the one that pads least.
@pytest.mark.parametrize("width,height,box", [
    (768, 768, (128, 1)), (384, 384, (128, 1)), (192, 192, (64, 2)),
    (96, 96, (32, 4)), (48, 48, (16, 8)), (64, 64, (64, 2)),
    (20, 24, (4, 32)), (1, 7, (1, 128)), (2, 5, (2, 64)), (8, 8, (8, 16)),
    (512, 512, (128, 1)), (256, 256, (128, 1)), (128, 128, (128, 1)),
    (32, 32, (32, 4)), (16, 16, (16, 8)), (24, 24, (32, 4)),
    (100, 60, (4, 32)), (300, 200, (16, 8)), (1000, 3, (128, 1)),
    (3, 1000, (1, 128))])
def test_tf32x3_tile_pads_least(width, height, box):
    def padded(bw):
        bh = 128 // bw
        return -(-width // bw) * bw * (-(-height // bh) * bh)

    least = min(padded(1 << k) for k in range(8))
    first = kconv.conv_tile(width)[0]
    assert kconv.tf32x3_tile(width, height) == box
    assert padded(box[0]) == least
    assert box[0] == first or (padded(first) > least and all(
        padded(1 << k) > least for k in range(8) if (1 << k) > box[0]))


# The bf16 K2's plan (``k2_plan``, what ``_conv3x3_wgmma`` launches with):
# at VGG's widths at 768² (768 .. 48) its box is the least-padding box of
# ``tf32x3_tile``, which covers each image exactly, so the counter
# ``k2.pad_pixels`` reads 0 and ``k2.pixels`` the image's pixels.
@pytest.mark.parametrize("bsz", [12, 6, 4, 2])
@pytest.mark.parametrize("width,bw", [(768, 128), (384, 128), (192, 64),
                                      (96, 32), (48, 16)])
def test_k2_plan_box_pads_nothing_at_768(bsz, width, bw):
    for cout in (64, 128, 256, 512):
        box, _, pixels, pad = kconv.k2_plan(bsz, width, width, cout)
        assert box == bw == kconv.tf32x3_tile(width, width)[0]
        assert (pixels, pad) == (bsz * width * width, 0)


@pytest.mark.parametrize("bsz,h,wd,box,pixels", [
    # 20 x 20: the 32 x 4 box, 32 x 20 pixels an image, 12 x 20 past it.
    (2, 20, 20, 32, 2 * 32 * 20),
    # 100 x 60: 4 x 32 boxes, 100 x 64 pixels an image.
    (1, 60, 100, 4, 100 * 64),
    # 24 wide, 20 high: 32 x 4 (32 x 20) pads less than 8 x 16 (24 x 32).
    (3, 20, 24, 32, 3 * 32 * 20)])
def test_k2_plan_counts_pad_pixels_at_ragged_widths(bsz, h, wd, box, pixels):
    bw, _, got, pad = kconv.k2_plan(bsz, h, wd, 64)
    assert bw == box == kconv.tf32x3_tile(wd, h)[0]
    assert (got, pad) == (pixels, pixels - bsz * h * wd)
    assert got % kconv.CONV_TILE_PIXELS == 0


@pytest.mark.parametrize("tiles_m,cout,bn", [
    # Cout up to 64 and 128: the parent kernel's BN.
    (1, 8, 64), (5000, 64, 64), (1, 72, 128), (5000, 128, 128),
    # Past 128, many waves: the 128 x 256 tile.
    (5000, 256, 256), (864, 512, 256), (3456, 256, 256),
    # 384 channels: the second 256-wide tile computes 128 channels past Cout.
    (5000, 384, 128),
    # Every 128-wide tile in one wave, as few 256-wide ones: 128 ends first.
    (10, 512, 128), (66, 256, 128), (30, 384, 128)])
def test_k2_bn(tiles_m, cout, bn):
    assert kconv.k2_bn(tiles_m, cout) == bn


# The (Cin, Cout) of VGG-19's 16 convs (VGG-16's first seven, which the
# NNFM block runs, are among them), the pre-pool convs that C and D take,
# and the style Grams ``get_features`` takes: the taps' widths and conv1_1's
# 27-wide patch Gram with stage 1 off.
VGG_CONVS = vgg.conv_shapes()
_CFG_CONVS = [i for i, v in enumerate(vgg.VGG19_CFG) if v != "M"]
VGG_POOLED = [VGG_CONVS[n] for n, i in enumerate(_CFG_CONVS)
              if vgg.VGG19_CFG[i + 1:i + 2] == ("M",)]
VGG_GRAMS = sorted({VGG_CONVS[i][1] for i in vgg.TAP_CONV_INDEX.values()}
                   | {ks1.K27})
# Each route function with the argument tuples VGG gives it: forward and
# input gradient (the transposed conv) for K2, C forward and D backward
# (pooled C, Cin), the Grams, conv1_1's Cout for A/B, and E/F's dtype alone.
VGG_CALLS = {
    "conv_route": (kconv.conv_route,
                   VGG_CONVS + [(co, ci) for ci, co in VGG_CONVS]),
    "relu_pool_route": (kconv.relu_pool_route, VGG_POOLED),
    "pool_route": (kconv.pool_route, [(co, ci) for ci, co in VGG_POOLED]),
    "gram_route": (kconv.gram_route, [(c,) for c in VGG_GRAMS]),
    "c11_route": (ks1.c11_route, [(VGG_CONVS[0][1],)]),
    "v3_route": (ks3.v3_route, [()]),
}
TENSOR_CORE_ROUTES = {BF16: {"wgmma", "narrow_wgmma", "narrow"},
                      F32: {"tf32x3", "narrow_tf32x3", "narrow"}}


@pytest.mark.parametrize("fn", sorted(VGG_CALLS))
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_every_vgg_width_has_a_tensor_core_route(fn, dtype):
    """Every width VGG meets, in both compute dtypes, takes a tensor-core
    kernel of that dtype: no route function refuses one."""
    route, calls = VGG_CALLS[fn]
    assert VGG_POOLED == [(64, 64), (128, 128), (256, 256), (512, 512),
                          (512, 512)]
    assert VGG_GRAMS == [27, 64, 128, 256, 512]
    for args in calls:
        assert route(dtype, *args) in TENSOR_CORE_ROUTES[dtype], (fn, args)
