"""Which K2, K3 and D kernel a CUDA tensor takes, and the tensor-core
kernels' tile plans, as the pure functions of ``st3d_torch.kernels.conv``
(no GPU): ``conv_route`` (bf16 with channel counts that are multiples of 8
and float32 with multiples of 4 take the TMA-fed tensor-core kernels, the
latter by 3xTF32; the other widths of both dtypes the narrow tensor-core
kernels wherever ``narrow_nb`` finds a plan; anything else the CUDA
cores), ``narrow_nb`` and ``narrow_smem`` (the narrow kernels' plan),
``gram_route`` (bf16, multiples of
8; float32, multiples of 4, by 3xTF32), ``relu_pool_route`` (``conv_route``'s
rules), ``pool_route`` (bf16
with C a multiple of 16 and Cin of 8; float32 with C a multiple of 16 and
Cin of 4, by 3xTF32), ``conv_tile`` (the 128-pixel output box per image
width), ``pool_tile`` (the same box holding whole 2x2 windows),
``pool_footprint`` (the pooled box D loads per tile) and ``gram_split``
(slices that cover the pixels exactly, in whole steps, with enough blocks
for the card)."""

import pytest
import torch

from st3d_torch.kernels import conv as kconv

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,cin,cout,route", [
    (BF16, 64, 64, "wgmma"), (BF16, 512, 512, "wgmma"),
    (BF16, 128, 64, "wgmma"), (BF16, 8, 16, "wgmma"), (BF16, 40, 24, "wgmma"),
    (BF16, 3, 64, "narrow_wgmma"), (BF16, 64, 27, "narrow_wgmma"),
    (BF16, 12, 64, "narrow_wgmma"), (F32, 64, 64, "tf32x3"),
    (F32, 512, 512, "tf32x3"), (torch.float16, 64, 64, "cuda_core"),
    (F32, 4, 8, "tf32x3"), (F32, 40, 24, "tf32x3"),
    (F32, 3, 64, "narrow_tf32x3"), (F32, 64, 27, "narrow_tf32x3"),
    (F32, 64, 3, "narrow_tf32x3"), (F32, 6, 64, "narrow_tf32x3"),
    (BF16, 64, 3, "narrow_wgmma"), (torch.float16, 3, 64, "cuda_core"),
    (F32, 256, 3, "cuda_core"), (BF16, 512, 3, "narrow_wgmma")])
def test_conv_route(dtype, cin, cout, route):
    assert kconv.conv_route(dtype, cin, cout) == route


@pytest.mark.parametrize("dtype,cin,cout,nb", [
    (BF16, 3, 64, 64), (BF16, 64, 3, 8), (BF16, 5, 12, 16), (BF16, 12, 5, 8),
    (BF16, 3, 96, 64), (F32, 3, 64, 64), (F32, 64, 3, 8), (F32, 12, 5, 8),
    (F32, 3, 30, 32), (F32, 256, 3, None)])
def test_narrow_plan_fits_a_block(dtype, cin, cout, nb):
    """The narrow K2's output channels a block, and its shared memory at
    every tile width within a block's (two blocks an SM at conv1_1's
    3 -> 64 and, in bf16, its 64 -> 3 input gradient); None (the CUDA
    cores) where 8 channels overflow."""
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
    (BF16, 40, 24, "cuda_core"), (BF16, 8, 64, "cuda_core"),
    (BF16, 64, 3, "cuda_core"), (BF16, 64, 12, "cuda_core"),
    (F32, 64, 64, "tf32x3"), (F32, 512, 512, "tf32x3"),
    (torch.float16, 64, 64, "cuda_core"), (F32, 128, 128, "tf32x3"),
    (F32, 16, 4, "tf32x3"), (F32, 48, 24, "tf32x3"), (F32, 8, 64, "cuda_core"),
    (F32, 40, 24, "cuda_core"), (F32, 64, 6, "cuda_core"),
    (F32, 64, 3, "cuda_core")])
def test_pool_route(dtype, c, cin, route):
    assert kconv.pool_route(dtype, c, cin) == route


# (dtype, Cin, Cout, route) of the forward C.
@pytest.mark.parametrize("dtype,cin,cout,route", [
    (BF16, 64, 64, "wgmma"), (BF16, 128, 128, "wgmma"),
    (BF16, 512, 512, "wgmma"), (BF16, 24, 40, "wgmma"),
    (BF16, 3, 64, "cuda_core"), (BF16, 64, 12, "cuda_core"),
    (F32, 64, 64, "tf32x3"), (F32, 512, 512, "tf32x3"),
    (torch.float16, 64, 64, "cuda_core"), (F32, 128, 128, "tf32x3"),
    (F32, 24, 40, "tf32x3"), (F32, 4, 8, "tf32x3"), (F32, 3, 64, "cuda_core"),
    (F32, 64, 6, "cuda_core"), (F32, 6, 64, "cuda_core"),
    (F32, 64, 27, "cuda_core")])
def test_relu_pool_route(dtype, cin, cout, route):
    assert kconv.relu_pool_route(dtype, cin, cout) == route


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
    (BF16, 136, "wgmma"), (BF16, 27, "cuda_core"), (BF16, 4, "cuda_core"),
    (F32, 128, "tf32x3"), (F32, 27, "cuda_core"), (F32, 64, "tf32x3"),
    (F32, 512, "tf32x3"), (F32, 4, "tf32x3"), (F32, 136, "tf32x3"),
    (F32, 6, "cuda_core"), (F32, 30, "cuda_core"),
    (torch.float16, 128, "cuda_core")])
def test_gram_route(dtype, c, route):
    assert kconv.gram_route(dtype, c) == route


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
# ones, pixel counts off the 64-pixel box, conv1_1's 27-wide patch Gram.
SPLITS = [(4, 256 * 256, 128), (4, 128 * 128, 256), (4, 64 * 64, 512),
          (4, 32 * 32, 512), (4, 512 * 512, 64), (2, 32 * 32, 128),
          (2, 4 * 4, 512), (3, 37 * 29, 64), (3, 4113, 512), (1, 7, 3),
          (4, 512 * 512, 27)]


@pytest.mark.parametrize("route", ["wgmma", "cuda_core", "tf32x3"])
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
