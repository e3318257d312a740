"""The arithmetic of kernels E and F on their bf16 tensor-core route
(``csrc/conv1_1_gram_wgmma.cu``, ``csrc/conv1_1_gram_bwd_wgmma.cu``) on
the CPU, with the route rule of ``kernels/stage1v3.py`` and the tile plans
they take from ``kernels/stage1.py`` (kernel A's for E, kernel B's for F).

E's emulation extends the patch matrix P with the ones column and the
weights with the bias as row 27 (W'), so y = P'W' in float32 carries the
bias inside the product; y_r is y rounded once to bf16 and z = relu(y_r);
the Gram is summed as the kernel sums it: per warpgroup over its 64 rows
(two pixel rows) of each ``C11_STATS_TILE`` tile, each tile's product
added to a float32 sum, tile by tile in the order of ``c11_stats_blocks``'s
persistent blocks, then the (block, warpgroup) partials in order. Rows
past the image are zero, ones column included, so they add nothing. bf16
products are exact in float32, so the emulation differs from the tensor
core only in the order of float32 additions.

F's emulation follows the kernel tile by tile (``C11_BWD_TILE`` and its
halo box; dz zero outside the image as TMA fills it, P' rows zero there):
y recomputed as E computes it, the mask [y > 0] on the float32 y, d =
dz·mask + y_r·S_hi + y_r·S_lo in float32 with S split by the wrapper's
``split_bf16``, rounded once to bf16; dP = d Wᵀ in float32; col2im over
the halo in the kernel's tap order and one rounding. Halo pixels outside
the image carry d = 0 (asserted).

Tolerances. Against float64: z within one bf16 rounding, 2⁻⁸ of the
reference value, plus 1e-5 of the largest value; g64 within 1e-5 relative
Frobenius of the float64 Gram of the float64 y rounded to bf16 (a y on a
bf16 rounding boundary may round the other way from its float32 sum);
F's d within one bf16 step, 2⁻⁷ of the float64 d (d rounds a float32 sum
whose S is S_hi + S_lo, 2⁻¹⁶ of each term off), plus 1e-5 of the largest
d; F's dx within 2⁻⁸ of the float64 col2im of the emulation's own d plus
1e-6 of the largest value. The split: hi + lo within 2⁻¹⁶ of S. Against
the plain versions (which the card's kernels are held to) and the JAX
package's K10a and K10b in bf16, interpret mode: z within one bf16 step,
2⁻⁷ of the value, plus 1e-4 of the largest value; g64 within 1e-5
relative Frobenius; dx within 2⁻⁷ of the value plus 4e-3 of the largest
value (a d that lands one bf16 step apart moves the dx values it reaches
by up to 2⁻⁷ of that d's share), and dropping the Gram cotangent, or
taking S of another image, moves the plain dx by more than that.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import st3d.kernels.stage1v3_pallas as s3
from st3d.kernels.stage1_pallas import pack_input5, unpack_output5

from st3d_torch.kernels import stage1 as ks1
from st3d_torch.kernels import stage1v3 as ks3

K27 = 27
C = 64
SHAPES = [(2, 16, 16), (1, 24, 40), (1, 37, 29)]
JAX_SHAPES = [(2, 16, 24), (1, 32, 16)]     # tests/test_torch_stage1v3.py's
CSRC = Path(ks3.__file__).resolve().parents[1] / "csrc"
SOURCES = {"E": "conv1_1_gram_wgmma.cu", "F": "conv1_1_gram_bwd_wgmma.cu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, shape):
    """x in [0, 1) (an image), He-scaled weights, a bias, all bf16."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.rand(*shape, 3).astype(np.float32))
    w = torch.tensor((rng.randn(3, 3, 3, C) * (2.0 / 27) ** 0.5)
                     .astype(np.float32))
    b = torch.tensor((rng.randn(C) * 0.1).astype(np.float32))
    return (x.to(torch.bfloat16), w.to(torch.bfloat16),
            b.to(torch.bfloat16))


def _bwd_operands(seed, shape, scale=3e-2):
    """dz (bf16) and sym = dG + dGᵀ (float32), dG at ``scale``: y_r·S is
    then a large share of d, as in ``chip_smoke.py``'s check."""
    rng = np.random.RandomState(seed)
    dz = torch.tensor(rng.randn(*shape, C).astype(np.float32))
    dg = torch.tensor((rng.randn(shape[0], C, C) * scale).astype(np.float32))
    return dz.to(torch.bfloat16), dg + dg.transpose(1, 2)


def _patches1(x):
    """(B, H, W, 28) float32: the patch rows with the ones column (P')."""
    p = ks1.patches27(x)
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _w_bias(w, b):
    """(28, 64) float32 W': the weights with the bias as row 27."""
    return torch.cat([w.reshape(K27, C), b.reshape(1, C)]).float()


def _y(rows, wb):
    """E's and F's y of P' rows: one float32 product, the bias inside."""
    return rows @ wb


def emulate_gram_wgmma(x, w, b):
    """E's bf16 route: (z, g64) as the kernel sums them."""
    bsz, h, wd, _ = x.shape
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(h, wd)
    blocks = ks1.c11_stats_blocks(bsz, h, wd)
    # Tile rows past the image: zero P' rows, ones column included.
    p = F.pad(_patches1(x), (0, 0, 0, tiles_x * tw - wd, 0, tiles_y * th - h))
    yr = _y(p, _w_bias(w, b)).to(torch.bfloat16)
    z = torch.relu(yr)[:, :h, :wd].contiguous()
    yr = yr.float()
    g64 = torch.zeros((bsz, C, C))
    for bi in range(bsz):
        total = torch.zeros((C, C))
        for blk in range(blocks):
            for wg in range(2):
                acc = torch.zeros((C, C))
                for t in range(blk, tiles_x * tiles_y, blocks):
                    y0 = (t // tiles_x) * th + wg * th // 2
                    x0 = (t % tiles_x) * tw
                    rows = yr[bi, y0:y0 + th // 2, x0:x0 + tw].reshape(-1, C)
                    acc = acc + rows.T @ rows
                total = total + acc
        g64[bi] = total
    return z, g64


def s_operand(sym):
    """(B, 2, 64, 64) bf16: F's S tiles as the wrapper makes them, Sᵀ split
    by ``split_bf16`` (row o of each part holds S[:, o])."""
    return torch.stack(ks3.split_bf16(sym.transpose(1, 2)), dim=1)


def _halo():
    tw, th = ks1.C11_BWD_TILE
    return tw + 2, th + 2


def emulate_gram_bwd_wgmma(x, dz, w, b, sym):
    """F's bf16 route: (dx, d) as the kernel computes them, tile by tile
    of ``C11_BWD_TILE`` over its halo box; d (B, H, W, 64) bf16 is each
    in-image pixel's rounded cotangent."""
    bsz, h, wd, _ = x.shape
    tw, th = ks1.C11_BWD_TILE
    hx, hy = _halo()
    tiles_x, tiles_y = ks1.c11_bwd_tiles(h, wd)
    ring = (0, 0, 1, tiles_x * tw + 1 - wd, 1, tiles_y * th + 1 - h)
    p = F.pad(_patches1(x), ring)
    dzp = F.pad(dz.float(), ring)
    inside = F.pad(torch.ones((bsz, h, wd, 1)), ring) > 0
    wb = _w_bias(w, b)
    s_hi, s_lo = (s.float().transpose(1, 2) for s in s_operand(sym).unbind(1))
    wt = w.reshape(K27, C).float().T
    d_all = torch.zeros((bsz, tiles_y * th + 2, tiles_x * tw + 2, C))
    dx = torch.zeros((bsz, tiles_y * th, tiles_x * tw, 3))
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            y0, x0 = ty * th, tx * tw                   # halo box origin + 1
            box = (slice(None), slice(y0, y0 + hy), slice(x0, x0 + hx))
            y = _y(p[box].reshape(bsz, -1, 28), wb)
            yr = y.to(torch.bfloat16).float()
            d = torch.where(y > 0, dzp[box].reshape(bsz, -1, C),
                            torch.zeros(()))
            d = (d + yr @ s_hi) + yr @ s_lo
            d = d.to(torch.bfloat16).float().reshape(bsz, hy, hx, C)
            assert not bool(d[~inside[box].expand_as(d)].any())
            d_all[box] = d
            dp = (d.reshape(bsz, -1, C) @ wt).reshape(bsz, hy, hx, K27)
            out = torch.zeros((bsz, th, tw, 3))
            for dy in range(3):
                for ddx in range(3):
                    k = (dy * 3 + ddx) * 3
                    out = out + dp[:, 2 - dy:2 - dy + th,
                                   2 - ddx:2 - ddx + tw, k:k + 3]
            dx[:, y0:y0 + th, x0:x0 + tw] = out
    return (dx[:, :h, :wd].to(torch.bfloat16),
            d_all[:, 1:h + 1, 1:wd + 1].to(torch.bfloat16))


def _col2im(dp, h, wd):
    """(B, H, W, 27) patch cotangents onto the (B, H, W, 3) image."""
    bsz = dp.shape[0]
    dxp = torch.zeros((bsz, h + 2, wd + 2, 3), dtype=dp.dtype)
    for dy in range(3):
        for dx in range(3):
            k = (dy * 3 + dx) * 3
            dxp[:, dy:dy + h, dx:dx + wd, :] += dp[..., k:k + 3]
    return dxp[:, 1:h + 1, 1:wd + 1, :]


def _y64(x, w, b):
    """(B, H, W, 64) float64 pre-ReLU y."""
    return ks1.patches27(x).double() @ w.reshape(K27, C).double() \
        + b.double()


def _within(got, ref, rtol, atol_share):
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

@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "tf32x3"),
                                        (torch.float16, None),
                                        (torch.float64, None)])
def test_v3_route(dtype, want):
    """E and F take the tensor cores in bf16 and float32; any other dtype
    (None) is refused with a ``ValueError`` naming it."""
    if want is None:
        with pytest.raises(ValueError, match=f"v3_route: .*{dtype}"):
            ks3.v3_route(dtype)
    else:
        assert ks3.v3_route(dtype) == want


@pytest.mark.parametrize("bsz,h,wd", [(4, 512, 512), (4, 768, 768),
                                      (1, 16, 16), (2, 24, 40), (1, 37, 29),
                                      (12, 512, 512)])
def test_gram_plan_covers_every_pixel_once(bsz, h, wd):
    """E's persistent blocks walk every tile of an image once, every pixel
    lies in one tile, and each warpgroup's 64 rows are two whole pixel
    rows of its tile."""
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(h, wd)
    blocks = ks1.c11_stats_blocks(bsz, h, wd)
    walked = sorted(t for blk in range(blocks)
                    for t in range(blk, tiles_x * tiles_y, blocks))
    assert walked == list(range(tiles_x * tiles_y))
    count = np.zeros((h, wd), np.int32)
    for t in walked:
        for wg in range(2):
            y0 = (t // tiles_x) * th + wg * th // 2
            x0 = (t % tiles_x) * tw
            count[y0:y0 + th // 2, x0:x0 + tw] += 1
    assert (count == 1).all()
    assert tw * (th // 2) == 64


@pytest.mark.parametrize("bsz,h,wd", [(4, 512, 512), (4, 1024, 1024),
                                      (1, 14, 22), (2, 24, 40), (1, 37, 19),
                                      (4, 128, 136)])
def test_gram_bwd_plan_covers_every_pixel_once(bsz, h, wd):
    """F's persistent blocks walk every (image, tile) once in raster
    order; each tile's halo box is one 64-row group per thread row of its
    three warpgroups."""
    tw, th = ks1.C11_BWD_TILE
    hx, hy = _halo()
    tiles_x, tiles_y = ks1.c11_bwd_tiles(h, wd)
    tiles = bsz * tiles_x * tiles_y
    blocks = ks1.c11_bwd_blocks(bsz, h, wd)
    walked = sorted(t for blk in range(blocks)
                    for t in range(blk, tiles, blocks))
    assert walked == list(range(tiles))
    count = np.zeros((bsz, h, wd), np.int32)
    for t in walked:
        tx, rest = t % tiles_x, t // tiles_x
        ty, bi = rest % tiles_y, rest // tiles_y
        count[bi, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
    assert (count == 1).all()
    assert hx * hy == 3 * 2 * 64
    assert blocks <= ks1.SMS


@pytest.mark.parametrize("kernel,tile", [("E", ks1.C11_STATS_TILE),
                                         ("F", ks1.C11_BWD_TILE)])
def test_plans_match_the_kernel_sources(kernel, tile):
    """The plans are the kernels' own: each source's (TW, TH) is the
    plan's; E runs two 128-thread warpgroups with two blocks to an SM
    (``C11_STATS_BLOCKS_PER_SM``, the wrapper's two partials a block); F
    three warpgroups of two 64-row groups, one thread a halo pixel; both
    assert their shared memory when they compile."""
    text = (CSRC / SOURCES[kernel]).read_text()
    found = re.search(r"constexpr int TW = (\d+), TH = (\d+);", text)
    assert found and tuple(map(int, found.groups())) == tile
    if kernel == "E":
        assert "constexpr int THREADS = 256;" in text
        assert (f"__launch_bounds__(THREADS, {ks1.C11_STATS_BLOCKS_PER_SM})"
                in text)
        assert "static_assert(2 * (SMEM_BYTES + 1024) <= 233472" in text
    else:
        assert "constexpr int WGS = 3;" in text
        assert "M == 64 * GROUPS * WGS && M == THREADS" in text
        assert "static_assert(SMEM_BYTES <= 232448" in text
    # Both take y from the one shared sequence of instructions.
    assert "conv1_1_y(" in text and "load_conv1_1_wb<THREADS>" in text


# ---------------------------------------------------------------------------
# E: y with the bias in the product, y_r staged once, the Gram in order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_gram_emulation_meets_float64(shape):
    x, w, b = _operands(1, shape)
    z, g64 = emulate_gram_wgmma(x, w, b)
    y = _y64(x, w, b)
    _within(z, torch.relu(y), 2 ** -8, 1e-5)
    yr = y.to(torch.bfloat16).double().reshape(shape[0], -1, C)
    assert _rel_fro(g64, yr.transpose(1, 2) @ yr) <= 1e-5
    assert bool((z == 0).any()) and bool((z > 0).any())   # both ReLU sides


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_emulation_matches_plain(shape):
    x, w, b = _operands(2, shape)
    z, g64 = emulate_gram_wgmma(x, w, b)
    z_p, g_p = ks3.conv1_1_gram(x, w, b)
    _within(z, z_p, 2 ** -7, 1e-4)
    assert _rel_fro(g64, g_p) <= 1e-5


def test_relu_of_the_rounded_y_is_z():
    """bf16 rounding is monotone and keeps the sign: relu(y_r) equals the
    plain version's rounding of relu(y) bit for bit, -0 included, so E
    stages one tile for both outputs."""
    rng = np.random.RandomState(3)
    y = torch.tensor(np.concatenate([
        rng.randn(4096).astype(np.float32),
        np.array([0.0, -0.0, 1e-41, -1e-41, 3e-39, -3e-39], np.float32)]))
    want = torch.relu(y).to(torch.bfloat16)
    got = torch.relu(y.to(torch.bfloat16))
    bits = got.view(torch.int16)
    # The kernel's in-place relu: a half whose sign bit is set becomes +0.
    kernel = torch.where(bits < 0, torch.zeros_like(bits), bits)
    assert torch.equal(kernel.view(torch.bfloat16), want)
    assert torch.equal(got.float(), want.float())


def test_ragged_tile_rows_add_nothing():
    """Rows past the image are zero, ones column included: g64 is the
    Gram of the image's pixels alone. At 37 x 29 the one tile column is 3
    pixels short and the last tile row 1 pixel high, 207 rows past the
    image; had they kept the ones column, each would add bᵀb."""
    x, w, b = _operands(4, (1, 37, 29))
    _, g64 = emulate_gram_wgmma(x, w, b)
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(37, 29)
    past = tiles_x * tw * tiles_y * th - 37 * 29
    assert past == 207
    yr = _y64(x, w, b).to(torch.bfloat16).double().reshape(-1, C)
    assert _rel_fro(g64[0], yr.T @ yr) <= 1e-5
    bias = b.double().reshape(1, C)
    assert _rel_fro(g64[0], yr.T @ yr + past * bias.T @ bias) > 1e-4


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_gram_emulation_matches_pallas_interpret(shape):
    """K10a in bf16 (interpret mode): z after unpacking, and g64."""
    x, w, b = _operands(5, shape)
    xj, wj, bj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (x, w, b))
    z5, g_j = s3.conv1_1_packed_v3(xj, wj, bj, True)
    z_j = torch.tensor(np.asarray(unpack_output5(z5).astype(jnp.float32)))
    z, g64 = emulate_gram_wgmma(x, w, b)
    _within(z, z_j, 2 ** -7, 1e-4)
    assert _rel_fro(g64, torch.tensor(np.asarray(g_j))) <= 1e-5


# ---------------------------------------------------------------------------
# F: y recomputed, the mask on float32 y, y_r·S by the bf16 split, d Wᵀ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e5])
def test_split_bf16_is_within_2_16(scale):
    rng = np.random.RandomState(6)
    t = torch.tensor((rng.randn(4, C, C) * scale).astype(np.float32))
    hi, lo = ks3.split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2 ** -16 * t.double().abs()).all())
    assert float((hi.double() - t.double()).abs().max()) > 0


def test_s_operand_layout():
    """Row o of each part holds S[:, o] (the K-major B tile of y_r·S), so
    a non-symmetric S is not taken transposed; hi + lo gives S."""
    rng = np.random.RandomState(7)
    sym = torch.tensor(rng.randn(2, C, C).astype(np.float32))
    parts = s_operand(sym)
    assert parts.shape == (2, 2, C, C) and parts.is_contiguous()
    both = parts[:, 0].double() + parts[:, 1].double()
    torch.testing.assert_close(both, sym.double().transpose(1, 2),
                               rtol=2 ** -16, atol=0)
    yr = torch.tensor(rng.randn(2, 5, C).astype(np.float32))
    torch.testing.assert_close(yr.double() @ both.transpose(1, 2),
                               yr.double() @ sym.double(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_bwd_emulation_meets_float64(shape):
    x, w, b = _operands(8, shape)
    dz, sym = _bwd_operands(9, shape)
    dx, d = emulate_gram_bwd_wgmma(x, dz, w, b, sym)
    y = _y64(x, w, b)
    yr = y.to(torch.bfloat16).double()
    d64 = torch.where(y > 0, dz.double(), torch.zeros((), dtype=y.dtype)) \
        + (yr.reshape(shape[0], -1, C) @ sym.double()).reshape(y.shape)
    _within(d, d64, 2 ** -7, 1e-5)
    dp = d.double() @ w.reshape(K27, C).double().T
    _within(dx, _col2im(dp, shape[1], shape[2]), 2 ** -8, 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_bwd_emulation_matches_plain(shape):
    """Against the plain version the card's kernel is held to; the Gram
    cotangent is large enough to matter (dropping it, or taking S of the
    next image, moves the plain dx by more than the tolerance)."""
    x, w, b = _operands(10, shape)
    dz, sym = _bwd_operands(11, shape)
    got, _ = emulate_gram_bwd_wgmma(x, dz, w, b, sym)
    ref = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    _within(got, ref, 2 ** -7, 4e-3)
    others = [torch.zeros_like(sym)] + ([sym.roll(1, 0)] if shape[0] > 1
                                        else [])
    for other in others:
        moved = ks3.conv1_1_gram_bwd(x, dz, w, b, other)
        assert float((moved.float() - ref.float()).abs().max()) \
            > 10 * 4e-3 * float(ref.float().abs().max())


def test_mask_is_taken_on_the_float32_y():
    """A y too small to survive bf16 rounding (2⁻¹⁴⁰ > 0, below half the
    least bf16 subnormal) has mask 1 and y_r 0: d is dz there, so dx at
    the pixel is dz·W = 2⁻⁷⁰, in the emulation and in the plain version
    alike (a mask taken on y_r would give 0); z and g64 see y_r = 0."""
    x = torch.zeros((1, 3, 3, 3))
    x[0, 1, 1, 0] = 2.0 ** -70
    w = torch.zeros((3, 3, 3, C))
    w[1, 1, 0, 0] = 2.0 ** -70
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    b = torch.zeros(C, dtype=torch.bfloat16)
    y = ks1.patches27(x) @ w.reshape(K27, C).float()
    assert float(y[0, 1, 1, 0]) == 2.0 ** -140
    assert float(y[0, 1, 1, 0].to(torch.bfloat16)) == 0.0
    dz = torch.ones((1, 3, 3, C), dtype=torch.bfloat16)
    sym = torch.zeros((1, C, C))
    dx, d = emulate_gram_bwd_wgmma(x, dz, w, b, sym)
    assert float(d[0, 1, 1, 0]) == 1.0 and float(d[0, 0, 0, 0]) == 0.0
    plain = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
    assert float(dx[0, 1, 1, 0]) == float(plain[0, 1, 1, 0]) == 2.0 ** -70
    z, g64 = emulate_gram_wgmma(x, w, b)
    assert not bool(z.float().any()) and not bool(g64.any())


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_gram_bwd_emulation_matches_pallas_interpret(shape):
    """K10b in bf16 (interpret mode) through the VJP of
    ``conv1_1_packed_v3``: the same cotangents of z and g64 give the
    emulation's dx, with sym = dG + dGᵀ as the autograd function forms it."""
    x, w, b = _operands(12, shape)
    bsz, h, wd = shape
    rng = np.random.RandomState(13)
    ct_z = rng.randn(bsz, h, wd, C).astype(np.float32)
    ct_g = (rng.randn(bsz, C, C) * 3e-2).astype(np.float32)
    xj, wj, bj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (x, w, b))
    _, vjp = jax.vjp(lambda xx: s3.conv1_1_packed_v3(xx, wj, bj, True), xj)
    (dx_j,) = vjp((pack_input5(jnp.asarray(ct_z).astype(jnp.bfloat16)),
                   jnp.asarray(ct_g)))
    dx_j = torch.tensor(np.asarray(dx_j.astype(jnp.float32)))
    dg = torch.tensor(ct_g)
    dz = torch.tensor(ct_z).to(torch.bfloat16)
    got, _ = emulate_gram_bwd_wgmma(x, dz, w, b, dg + dg.transpose(1, 2))
    _within(got, dx_j, 2 ** -7, 4e-3)
    assert float(dx_j.abs().max()) > 0


def test_e_and_f_share_y():
    """F's y_r equals E's bit for bit: both emulations take y from the same
    product of P' rows and W', as both kernels issue it through
    ``conv1_1_y``; so F's Gram cotangent meets the y_r E's Gram used."""
    shape = (1, 24, 40)
    x, w, b = _operands(14, shape)
    z, _ = emulate_gram_wgmma(x, w, b)
    dz = torch.zeros(shape + (C,), dtype=torch.bfloat16)
    eye = torch.eye(C)[None]
    # With dz = 0 and S = I, d = y_r·I = y_r, rounded to bf16: y_r itself.
    _, d = emulate_gram_bwd_wgmma(x, dz, w, b, eye)
    assert torch.equal(torch.relu(d), z)


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------

def test_cpu_bf16_takes_the_plain_versions():
    """On the CPU the bf16 route runs the plain versions and launches
    nothing, though ``v3_route`` names the tensor cores for bf16."""
    before = dict(ks3.LAUNCHES)
    x, w, b = _operands(15, (1, 8, 8))
    dz, sym = _bwd_operands(16, (1, 8, 8))
    for got, want in zip(ks3.conv1_1_gram(x, w, b),
                         ks3.conv1_1_gram_plain(x, w, b)):
        assert torch.equal(got, want)
    assert torch.equal(ks3.conv1_1_gram_bwd(x, dz, w, b, sym),
                       ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym))
    assert ks3.LAUNCHES == before
