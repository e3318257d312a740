"""The arithmetic of kernels A and B on their bf16 tensor-core route
(``csrc/conv1_1_stats_wgmma.cu``, ``csrc/conv1_1_bwd_wgmma.cu``) on the
CPU, with the route rule and the tile plans of ``kernels/stage1.py``.

A's emulation extends the patch matrix P with the ones column and the
weights with the bias as row 27, so z = relu(P'W') rounds once into bf16
with the bias inside the product; PᵀP and s27 are P'ᵀP' summed as the
kernel sums them: per warpgroup over its 64 rows (two pixel rows) of each
``C11_STATS_TILE`` tile, rows past the image zero, tile by tile in the
order of ``c11_stats_blocks``'s persistent blocks, then the (block,
warpgroup) partials in order. bf16 products are exact in
float32, so the emulation differs from the tensor core only in the order
of float32 additions.

B's emulation follows the kernel tile by tile (``C11_BWD_TILE`` and its
halo box, zero outside the image as TMA fills it): dz masked by z > 0 in
bf16, d Wᵀ in bf16 products, then P'S' with S' (sym with ds27 as row 27)
split into bf16 hi + lo (``split_bf16``) as the kernel's K-major operand
tiles (``stats_operand``), each halo pixel's dP summed in that order in
float32; col2im over the halo in the kernel's tap order and one rounding.

Tolerances. Against float64: z and dx within one bf16 rounding, 2⁻⁸ of the
reference value (the rounding is at most 2⁻⁹ relative, the float32 sums
add ~1e-7), plus 1e-5 of the largest value for sums that cancel; PᵀP and
s27 within 1e-6 relative Frobenius (float32 sums of exact products over
≤ 4096 pixels). The bf16 split of S: hi + lo within 2⁻¹⁶ of S (each
rounding keeps 8 bits, so the remainder is under 2⁻¹⁷). Against the JAX
package's K4a and K4c in bf16, interpret mode: z and dx within one bf16
step, 2⁻⁷ of the value (both sides round float32 sums taken in different
orders, so a value on a rounding boundary may land one step apart), plus
1e-4 of the largest value, and for dx 2⁻⁸ of its nine taps' absolute sum
(K4c rounds each tap into bf16 before its fold); PᵀP and s27 within 1e-6
relative Frobenius.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import st3d.kernels.stage1_pallas as s1

from st3d_torch.kernels import stage1 as ks1
from st3d_torch.models import vgg as tvgg

K27 = 27
SHAPES = [(2, 16, 16), (1, 24, 40), (1, 37, 29)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, shape, cout=64):
    """x in [0, 1) (an image), He-scaled weights, a bias, all bf16."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.rand(*shape, 3).astype(np.float32))
    w = torch.tensor((rng.randn(3, 3, 3, cout) * (2.0 / 27) ** 0.5)
                     .astype(np.float32))
    b = torch.tensor((rng.randn(cout) * 0.1).astype(np.float32))
    return (x.to(torch.bfloat16), w.to(torch.bfloat16),
            b.to(torch.bfloat16))


def _patches1(x):
    """(B, H*W, 28) float32: the patch rows with the ones column."""
    p = ks1.patches27(x).reshape(x.shape[0], -1, K27)
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def emulate_stats_wgmma(x, w, b):
    """A's bf16 route: (z, PᵀP, s27) as the kernel sums them."""
    bsz, h, wd, _ = x.shape
    cout = w.shape[3]
    p = _patches1(x)
    wb = torch.cat([w.reshape(K27, cout), b[None]]).float()
    z = torch.relu(p @ wb).to(torch.bfloat16).reshape(bsz, h, wd, cout)
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(h, wd)
    blocks = ks1.c11_stats_blocks(bsz, h, wd)
    p = F.pad(p.reshape(bsz, h, wd, 28),
              (0, 0, 0, tiles_x * tw - wd, 0, tiles_y * th - h))
    stats = torch.zeros((bsz, 28, 28))
    for bi in range(bsz):
        total = torch.zeros((28, 28))
        for blk in range(blocks):
            for wg in range(2):
                acc = torch.zeros((28, 28))
                for t in range(blk, tiles_x * tiles_y, blocks):
                    y0 = (t // tiles_x) * th + wg * th // 2
                    x0 = (t % tiles_x) * tw
                    rows = p[bi, y0:y0 + th // 2, x0:x0 + tw].reshape(-1, 28)
                    acc = acc + rows.T @ rows
                total = total + acc
        stats[bi] = total
    return z, stats[:, :K27, :K27].contiguous(), stats[:, K27, :K27]


def _col2im(dp, h, wd):
    """(B, H, W, 27) patch cotangents onto the (B, H, W, 3) image."""
    bsz = dp.shape[0]
    dxp = torch.zeros((bsz, h + 2, wd + 2, 3), dtype=dp.dtype)
    for dy in range(3):
        for dx in range(3):
            k = (dy * 3 + dx) * 3
            dxp[:, dy:dy + h, dx:dx + wd, :] += dp[..., k:k + 3]
    return dxp[:, 1:h + 1, 1:wd + 1, :]


def split_bf16(t):
    """float32 ``t`` as bf16 ``(hi, lo)``: hi = t rounded to bf16, lo =
    t - hi (exact in float32) rounded to bf16, as B's kernel splits S'."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def stats_operand(sym, ds27):
    """(B, 2, 32, 32) bf16: B's S' tiles, hi and lo, K-major: row n holds
    S'[:, n] with S' (28, 27) = sym with ds27 as its row 27; zeros past
    column 27 and row 26."""
    bsz = sym.shape[0]
    sp = torch.zeros((bsz, 32, 32))
    sp[:, :K27, :K27] = sym.transpose(1, 2)
    sp[:, :K27, K27] = ds27
    return torch.stack(split_bf16(sp), dim=1)


def _bwd_halo():
    """(HX, HY) of B's dP box: the dx tile and its one-pixel ring, the box
    in which the kernel loads dz and z."""
    tw, th = ks1.C11_BWD_TILE
    return tw + 2, th + 2


def emulate_bwd_wgmma(x, dz, z, w, sym, ds27):
    """B's bf16 route: dx as the kernel computes it, tile by tile of
    ``C11_BWD_TILE`` over its halo box, where pixels outside the image
    have d = 0 (TMA's zero fill) and a zero patch row."""
    bsz, h, wd, _ = x.shape
    cout = w.shape[3]
    tw, th = ks1.C11_BWD_TILE
    hx, hy = _bwd_halo()
    tiles_x, tiles_y = ks1.c11_bwd_tiles(h, wd)
    d = torch.where(z > 0, dz, torch.zeros((), dtype=dz.dtype)).float()
    ring = (0, 0, 1, tiles_x * tw + 1 - wd, 1, tiles_y * th + 1 - h)
    d = F.pad(d, ring)
    p = F.pad(F.pad(_patches1(x), (0, 4)).reshape(bsz, h, wd, 32), ring)
    s2 = stats_operand(sym, ds27).float()               # rows n, columns k
    wt = w.reshape(K27, cout).float().T
    dx = torch.zeros((bsz, tiles_y * th, tiles_x * tw, 3))
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            y0, x0 = ty * th, tx * tw                   # halo box origin + 1
            box = (slice(None), slice(y0, y0 + hy), slice(x0, x0 + hx))
            pb = p[box].reshape(bsz, -1, 32)
            dp = d[box].reshape(bsz, -1, cout) @ wt
            dp = dp + (pb @ s2[:, 0].transpose(1, 2))[..., :K27]
            dp = dp + (pb @ s2[:, 1].transpose(1, 2))[..., :K27]
            dp = dp.reshape(bsz, hy, hx, K27)
            out = torch.zeros((bsz, th, tw, 3))
            for dy in range(3):
                for ddx in range(3):
                    k = (dy * 3 + ddx) * 3
                    out = out + dp[:, 2 - dy:2 - dy + th,
                                   2 - ddx:2 - ddx + tw, k:k + 3]
            dx[:, y0:y0 + th, x0:x0 + tw] = out
    return dx[:, :h, :wd].to(torch.bfloat16)


def _bwd_operands(seed, x, w, b):
    rng = np.random.RandomState(seed)
    z = ks1.conv1_1_stats_plain(x, w, b)[0]
    dz = torch.tensor(rng.randn(*z.shape).astype(np.float32)).to(z.dtype)
    dg = torch.tensor((rng.randn(x.shape[0], K27, K27) * 1e-2)
                      .astype(np.float32))
    ds = torch.tensor((rng.randn(x.shape[0], K27) * 1e-2).astype(np.float32))
    return z, dz, dg + dg.transpose(1, 2), ds


def _within_bf16(got, ref, rtol, atol_share):
    ref = ref.double()
    err = (got.double() - ref).abs()
    bound = rtol * ref.abs() + atol_share * float(ref.abs().max())
    assert bool((err <= bound).all()), float((err - bound).max())


def _rel_fro(got, ref):
    return float(torch.linalg.norm((got.double() - ref.double()).flatten())
                 / torch.linalg.norm(ref.double().flatten()))


# ---------------------------------------------------------------------------
# The route rule and the tile plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,cout,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 60, None),
    (torch.bfloat16, 136, None), (torch.float32, 64, "tf32x3"),
    (torch.float32, 6, None)])
def test_c11_route(dtype, cout, want):
    """A and B take the tensor cores; any other dtype or Cout (None) is
    refused with a ``ValueError`` naming it."""
    if want is None:
        with pytest.raises(ValueError, match=f"c11_route: .*cout={cout}"):
            ks1.c11_route(dtype, cout)
    else:
        assert ks1.c11_route(dtype, cout) == want


@pytest.mark.parametrize("bsz,size", [(4, 512), (4, 768), (4, 1024),
                                      (1, 16), (12, 512)])
def test_stats_blocks_cover_every_tile_once(bsz, size):
    """Every tile of an image is walked by exactly one block, every pixel
    lies in exactly one tile, and the blocks fill the card about twice
    over."""
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(size, size)
    tiles = tiles_x * tiles_y
    blocks = ks1.c11_stats_blocks(bsz, size, size)
    walked = sorted(t for blk in range(blocks)
                    for t in range(blk, tiles, blocks))
    assert walked == list(range(tiles))
    count = np.zeros((size, size), np.int32)
    for t in walked:
        y0, x0 = (t // tiles_x) * th, (t % tiles_x) * tw
        assert y0 < size and x0 < size
        count[y0:y0 + th, x0:x0 + tw] += 1
    assert (count == 1).all()
    assert tw * th == 128 and blocks <= tiles
    if tiles >= 2 * ks1.SMS:
        assert bsz * blocks >= ks1.C11_STATS_BLOCKS_PER_SM * ks1.SMS


@pytest.mark.parametrize("h,wd", [(512, 512), (768, 768), (1024, 1024),
                                  (16, 16), (24, 40), (37, 29)])
def test_bwd_tiles_cover_every_pixel_once(h, wd):
    """Every dx pixel lies in exactly one tile; each tile's halo box starts
    one pixel before the tile, inside the image or on its zero-filled
    ring, and holds the tile's in-image one-pixel neighbourhood."""
    tw, th = ks1.C11_BWD_TILE
    hx, hy = _bwd_halo()
    tiles_x, tiles_y = ks1.c11_bwd_tiles(h, wd)
    count = np.zeros((h, wd), np.int32)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            x0, y0 = tx * tw, ty * th
            assert x0 < wd and y0 < h
            assert x0 - 1 >= -1 and y0 - 1 >= -1
            count[y0:y0 + th, x0:x0 + tw] += 1
            need = (min(wd, x0 + tw + 1) - max(0, x0 - 1),
                    min(h, y0 + th + 1) - max(0, y0 - 1))
            assert need[0] <= hx and need[1] <= hy
    assert (count == 1).all()
    assert (hx * hy) % 128 == 0                   # whole warpgroup row groups
    assert hx * hy / (tw * th) <= 1.25
    blocks = ks1.c11_bwd_blocks(4, h, wd)
    assert blocks == min(4 * tiles_x * tiles_y, ks1.SMS)


@pytest.mark.parametrize("source,tile", [
    ("conv1_1_stats_wgmma.cu", ks1.C11_STATS_TILE),
    ("conv1_1_bwd_wgmma.cu", ks1.C11_BWD_TILE)])
def test_plans_match_the_kernel_sources(source, tile):
    """The tile plans and the route's Cout cap are the kernels' own: each
    source's (TW, TH) and MAX_COUT are the plan's, and it asserts its
    shared memory at MAX_COUT against a block's 227 KB when it compiles."""
    text = (Path(ks1.__file__).resolve().parents[1] / "csrc"
            / source).read_text()
    found = re.search(r"constexpr int TW = (\d+), TH = (\d+);", text)
    assert found and tuple(map(int, found.groups())) == tile
    found = re.search(r"constexpr int MAX_COUT = (\d+);", text)
    assert found and int(found.group(1)) == ks1.C11_MAX_COUT
    assert "static_assert(smem_bytes(MAX_COUT / 64) <= 232448" in text


# ---------------------------------------------------------------------------
# A: z with the bias in the product, the statistics in the kernel's order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_stats_emulation_meets_float64(shape):
    x, w, b = _operands(1, shape)
    z, ptp, s27 = emulate_stats_wgmma(x, w, b)
    p = ks1.patches27(x).double()
    ref = torch.relu(p @ w.reshape(K27, -1).double() + b.double())
    _within_bf16(z, ref, 2 ** -8, 1e-5)
    flat = p.reshape(shape[0], -1, K27)
    assert _rel_fro(ptp, flat.transpose(1, 2) @ flat) <= 1e-6
    assert _rel_fro(s27, flat.sum(dim=1)) <= 1e-6
    assert bool((z == 0).any()) and bool((z > 0).any())   # both ReLU sides


@pytest.mark.parametrize("shape", SHAPES)
def test_stats_emulation_matches_plain(shape):
    """The emulation against the plain version the wrapper takes on the
    CPU (which the card's kernel is held to): z within one bf16 step,
    the statistics within 1e-6."""
    x, w, b = _operands(2, shape)
    z, ptp, s27 = emulate_stats_wgmma(x, w, b)
    z_p, ptp_p, s27_p = ks1.conv1_1_stats(x, w, b)
    _within_bf16(z, z_p, 2 ** -7, 1e-5)
    assert _rel_fro(ptp, ptp_p) <= 1e-6 and _rel_fro(s27, s27_p) <= 1e-6


def test_ragged_tile_rows_add_nothing():
    """Tile rows past the image are zero, ones column included: s27 and
    PᵀP count only the image's pixels (37 x 29 leaves the last tile column
    3 pixels wide and the last tile row 1 pixel high)."""
    x, w, b = _operands(3, (1, 37, 29))
    _, ptp, s27 = emulate_stats_wgmma(x, w, b)
    p = _patches1(x)[0].double()
    tw, th = ks1.C11_STATS_TILE
    assert 29 % tw and 37 % th
    assert _rel_fro(s27[0], p[:, :K27].sum(0)) <= 1e-6
    assert _rel_fro(ptp[0], p[:, :K27].T @ p[:, :K27]) <= 1e-6


@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 32, 16)])
def test_stats_emulation_matches_pallas_interpret(shape):
    """K4a in bf16 (interpret mode): z, and PᵀP and s27 folded from its
    48-wide quad statistics by the JAX package's selection matrices."""
    x, w, b = _operands(4, shape)
    xj, wj, bj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (x, w, b))
    z5, g48, s48 = s1.conv1_1_packed(xj, wj, bj, True)
    z_j = torch.tensor(np.asarray(s1.unpack_output5(z5).astype(jnp.float32)))
    sel = np.asarray(s1._selection_matrices(3), np.float64)   # (4, 27, 48)
    ptp_j = np.einsum("ikl,blm,inm->bkn", sel, np.asarray(g48, np.float64),
                      sel)
    s27_j = np.einsum("ikl,bl->bk", sel,
                      np.asarray(s48, np.float64).reshape(shape[0], -1))
    z, ptp, s27 = emulate_stats_wgmma(x, w, b)
    _within_bf16(z, z_j, 2 ** -7, 1e-4)
    assert _rel_fro(ptp, torch.tensor(ptp_j)) <= 1e-6
    assert _rel_fro(s27, torch.tensor(s27_j)) <= 1e-6


# ---------------------------------------------------------------------------
# B: d Wᵀ in bf16, P S by the bf16 split, col2im
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e5])
def test_split_bf16_is_within_2_16(scale):
    rng = np.random.RandomState(5)
    t = torch.tensor((rng.randn(4, 27, 27) * scale).astype(np.float32))
    hi, lo = split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2 ** -16 * t.double().abs()).all())
    assert float((hi.double() - t.double()).abs().max()) > 0


def test_emulated_stats_operand_layout():
    """Row n of each part holds S'[:, n]: sym[:, n] then ds27[n]; zeros
    past column 27 and row 26; hi + lo gives S'ᵀ."""
    rng = np.random.RandomState(6)
    g = torch.tensor(rng.randn(2, K27, K27).astype(np.float32))
    sym, ds = g + g.transpose(1, 2), torch.tensor(
        rng.randn(2, K27).astype(np.float32))
    s2 = stats_operand(sym, ds)
    assert s2.shape == (2, 2, 32, 32) and s2.dtype == torch.bfloat16
    both = s2[:, 0].double() + s2[:, 1].double()
    torch.testing.assert_close(both[:, :K27, :K27], sym.double().transpose(
        1, 2), rtol=2 ** -16, atol=0)
    torch.testing.assert_close(both[:, :K27, K27], ds.double(),
                               rtol=2 ** -16, atol=0)
    assert not bool(s2[:, :, K27:].any()) and not bool(s2[:, :, :, 28:].any())


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_emulation_meets_float64(shape):
    x, w, b = _operands(7, shape)
    z, dz, sym, ds = _bwd_operands(8, x, w, b)
    got = emulate_bwd_wgmma(x, dz, z, w, sym, ds)
    d = torch.where(z > 0, dz, torch.zeros((), dtype=dz.dtype)).double()
    p = ks1.patches27(x).double()
    dp = (d @ w.reshape(K27, -1).double().T
          + (p.reshape(shape[0], -1, K27) @ sym.double()).reshape(p.shape)
          + ds.double()[:, None, None, :])
    _within_bf16(got, _col2im(dp, shape[1], shape[2]), 2 ** -8, 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_emulation_matches_plain(shape):
    """Against the plain version the card's kernel is held to: one bf16
    step; the S term is large enough to matter (dropping it moves dx by
    more than the tolerance)."""
    x, w, b = _operands(9, shape)
    z, dz, sym, ds = _bwd_operands(10, x, w, b)
    got = emulate_bwd_wgmma(x, dz, z, w, sym, ds)
    ref = ks1.conv1_1_bwd(x, dz, z, w, sym, ds)
    _within_bf16(got, ref, 2 ** -7, 1e-5)
    no_s = ks1.conv1_1_bwd(x, dz, z, w, torch.zeros_like(sym), ds)
    assert float((no_s.float() - ref.float()).abs().max()) > 1e-2 * float(
        ref.float().abs().max())


@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 32, 16)])
def test_bwd_emulation_matches_pallas_interpret(shape):
    """K4c in bf16 (interpret mode) through the VJP of ``conv1_1_packed``
    and the JAX package's fold of the Gram: the same cotangents (z's and
    the closed-form Gram's) give the emulation's dx, which takes JAX's z for
    its ReLU mask and sym and ds27 from the port's closed form."""
    x, w, b = _operands(13, shape)
    bsz, h, wd = shape
    rng = np.random.RandomState(14)
    ct_z = rng.randn(bsz, h, wd, 64).astype(np.float32)
    ct_g = (rng.randn(bsz, 64, 64) * 1e-3).astype(np.float32)
    xj, wj, bj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (x, w, b))

    def jfn(xx):
        z5, g48, s48 = s1.conv1_1_packed(xx, wj, bj, True)
        return s1.unpack_output5(z5), s1.fold_gram48(g48, s48, wj, bj,
                                                     h * wd)

    (z_j, _), vjp = jax.vjp(jfn, xj)
    (dx_j,) = vjp((jnp.asarray(ct_z).astype(jnp.bfloat16),
                   jnp.asarray(ct_g)))
    dx_j = torch.tensor(np.asarray(dx_j.astype(jnp.float32)))

    ptp = torch.zeros((bsz, K27, K27), requires_grad=True)
    s27 = torch.zeros((bsz, K27), requires_grad=True)
    g = tvgg.gram1_closed_form(ptp, s27, w, b, h * wd)
    dptp, ds = torch.autograd.grad(g, (ptp, s27), torch.tensor(ct_g))
    z = torch.tensor(np.asarray(z_j.astype(jnp.float32))).to(torch.bfloat16)
    dz = torch.tensor(ct_z).to(torch.bfloat16)
    sym = dptp + dptp.transpose(1, 2)
    got = emulate_bwd_wgmma(x, dz, z, w, sym, ds)
    # K4c stages dP in a bf16 scratch before its fold (stage1_pallas.py:624),
    # so each of a dx value's nine taps carries a rounding of its own, up
    # to 2⁻⁹ of the tap: the bound adds 2⁻⁸ of the taps' absolute sum.
    d = torch.where(z > 0, dz, torch.zeros((), dtype=dz.dtype)).double()
    p = ks1.patches27(x).double()
    dp = (d @ w.reshape(K27, -1).double().T
          + (p.reshape(bsz, -1, K27) @ sym.double()).reshape(p.shape)
          + ds.double()[:, None, None, :])
    taps = _col2im(dp.abs(), h, wd)
    err = (got.double() - dx_j.double()).abs()
    bound = (2 ** -7 * dx_j.double().abs() + 2 ** -8 * taps
             + 1e-4 * float(dx_j.abs().max()))
    assert bool((err <= bound).all()), float((err - bound).max())
    assert float(dx_j.abs().max()) > 0
