"""The arithmetic of kernels A and B on their float32 tensor-core route
(``csrc/conv1_1_stats_tf32x3.cu``, ``csrc/conv1_1_bwd_tf32x3.cu``) on the
CPU, with the route rule and the tile plans of ``kernels/stage1.py``.

Every factor is split exactly into tf32 hi + lo (``kernels.conv.
split_tf32``) and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi. A
TF32 value is a float32 with its low 13 mantissa bits clear, so a float32
matmul of TF32 operands gives the tensor core's products with float32
sums. The emulations clear the low bits of the lo parts too, as a tensor
core that truncates would: the worst case the kernels allow.

A's emulation: z = relu(P'W') from the three products (P' the patch rows
with the ones column and zeros to 32 columns, W' the weights with the bias
as row 27). The statistics as the kernel sums them: per warpgroup (its two
pixel rows of each ``C11_STATS_TILE`` tile, rows past the image zero), each
tile's HH = Phiᵀ Phi and LH = Ploᵀ Phi into a fresh partial added to the
running sum, tile by tile in the order of ``c11_stats_blocks``'s persistent
blocks; the block's partial is (HH + LH) + LHᵀ of warpgroup 0 plus that of
warpgroup 1, and the image's statistics the blocks' partials in order.

B's emulation follows its kernel tile by tile (``C11_BWD_TILE`` and its
halo box, zero outside the image as TMA fills it): d = dz·[z > 0], each
32-channel slab's three products d Wᵀ into a fresh partial added to the
running dP, then P'S' (S' = sym with ds27 as row 27) the same way; col2im
over the halo in the kernel's tap order.

The kernels take the k dimension of z's product and of a slab in permuted
orders (``z_column``, ``slab_channel``), which change only the order of
float32 additions; the plan tests hold those orders to be permutations that
match the kernels' fragment reads.

Tolerances. Against float64: z and dx within 1e-6 of the largest value;
PᵀP and s27 within 1e-6 relative Frobenius. Against the plain versions
(the float32 functions the card's kernels are held to): the same 1e-6,
both sides being within 5e-7 of float64 here. Against the JAX package's
K4a and K4c in float32, interpret mode: the 1e-5 of the largest value that
``tests/test_torch_tf32x3.py`` holds K2's forward to, for z and dx, and
1e-5 relative Frobenius for PᵀP and s27.
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

from st3d_torch.kernels import conv as kconv
from st3d_torch.kernels import stage1 as ks1
from st3d_torch.models import vgg as tvgg

K27 = 27
SHAPES = [(2, 16, 16), (1, 24, 40), (1, 37, 29)]
CSRC = Path(ks1.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, shape, cout=64):
    """x in [0, 1) (an image), He-scaled weights, a bias, all float32."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.rand(*shape, 3).astype(np.float32))
    w = torch.tensor((rng.randn(3, 3, 3, cout) * (2.0 / 27) ** 0.5)
                     .astype(np.float32))
    b = torch.tensor((rng.randn(cout) * 0.1).astype(np.float32))
    return x, w, b


def _trunc(t):
    """t with its low 13 mantissa bits cleared, as a truncating tensor core
    reads a lo part."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def three_products(a, b):
    """a @ b by the 3xTF32 split: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    ah, al = kconv.split_tf32(a)
    bh, bl = kconv.split_tf32(b)
    return _trunc(al) @ bh + ah @ _trunc(bl) + ah @ bh


def _patches32(x):
    """(B, H*W, 32) float32 P': the patch rows, the ones column, zeros."""
    p = ks1.patches27(x).reshape(x.shape[0], -1, K27)
    return torch.cat([p, torch.ones_like(p[..., :1]),
                      torch.zeros_like(p[..., :4])], dim=-1)


def emulate_stats_tf32x3(x, w, b):
    """A's float32 route: (z, PᵀP, s27) as the kernel sums them."""
    bsz, h, wd, _ = x.shape
    cout = w.shape[3]
    p = _patches32(x)
    wb = torch.cat([w.reshape(K27, cout), b[None], torch.zeros((4, cout))])
    z = torch.relu(three_products(p, wb)).reshape(bsz, h, wd, cout)
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(h, wd)
    blocks = ks1.c11_stats_blocks(bsz, h, wd,
                                  ks1.C11_TF32_STATS_BLOCKS_PER_SM)
    p = F.pad(p.reshape(bsz, h, wd, 32),
              (0, 0, 0, tiles_x * tw - wd, 0, tiles_y * th - h))
    p_hi, p_lo = kconv.split_tf32(p)
    p_lo = _trunc(p_lo)
    stats = torch.zeros((bsz, 28, 28))
    for bi in range(bsz):
        total = torch.zeros((28, 28))
        for blk in range(blocks):
            block = torch.zeros((28, 28))
            for wg in range(2):
                run = torch.zeros((64, 32))
                for t in range(blk, tiles_x * tiles_y, blocks):
                    y0 = (t // tiles_x) * th + wg * th // 2
                    x0 = (t % tiles_x) * tw
                    box = (bi, slice(y0, y0 + th // 2), slice(x0, x0 + tw))
                    hi = p_hi[box].reshape(-1, 32)
                    lo = p_lo[box].reshape(-1, 32)
                    run = run + torch.cat([hi.T @ hi, lo.T @ hi])
                hh, lh = run[:28, :28], run[32:60, :28]
                block = block + ((hh + lh) + lh.T)
            total = total + block
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


def stats_operand(sym, ds27):
    """(B, 32, 27) float32 S': sym with ds27 as its row 27, zero rows 28-31
    (the kernel's K-major B tile holds its transpose)."""
    bsz = sym.shape[0]
    return torch.cat([sym, ds27[:, None], torch.zeros((bsz, 4, K27))], 1)


def emulate_bwd_tf32x3(x, dz, z, w, sym, ds27):
    """B's float32 route: dx as the kernel computes it, tile by tile of
    ``C11_BWD_TILE`` over its halo box, where pixels outside the image have
    d = 0 (TMA's zero fill) and a zero patch row."""
    bsz, h, wd, _ = x.shape
    cout = w.shape[3]
    tw, th = ks1.C11_BWD_TILE
    hx, hy = tw + 2, th + 2
    tiles_x, tiles_y = ks1.c11_bwd_tiles(h, wd)
    d = torch.where(z > 0, dz, torch.zeros(()))
    ring = (0, 0, 1, tiles_x * tw + 1 - wd, 1, tiles_y * th + 1 - h)
    d = F.pad(d, ring)
    p = F.pad(_patches32(x).reshape(bsz, h, wd, 32), ring)
    wt = w.reshape(K27, cout).T
    sp = stats_operand(sym, ds27)
    dx = torch.zeros((bsz, tiles_y * th, tiles_x * tw, 3))
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            y0, x0 = ty * th, tx * tw                   # halo box origin + 1
            box = (slice(None), slice(y0, y0 + hy), slice(x0, x0 + hx))
            db = d[box].reshape(bsz, -1, cout)
            acc = torch.zeros((bsz, hy * hx, K27))
            for c0 in range(0, cout, 32):
                acc = acc + three_products(db[..., c0:c0 + 32],
                                           wt[c0:c0 + 32])
            acc = acc + three_products(p[box].reshape(bsz, -1, 32), sp)
            dp = acc.reshape(bsz, hy, hx, K27)
            out = torch.zeros((bsz, th, tw, 3))
            for dy in range(3):
                for ddx in range(3):
                    k = (dy * 3 + ddx) * 3
                    out = out + dp[:, 2 - dy:2 - dy + th,
                                   2 - ddx:2 - ddx + tw, k:k + 3]
            dx[:, y0:y0 + th, x0:x0 + tw] = out
    return dx[:, :h, :wd]


def _bwd_operands(seed, x, w, b):
    rng = np.random.RandomState(seed)
    z = ks1.conv1_1_stats_plain(x, w, b)[0]
    dz = torch.tensor(rng.randn(*z.shape).astype(np.float32))
    dg = torch.tensor((rng.randn(x.shape[0], K27, K27) * 1e-2)
                      .astype(np.float32))
    ds = torch.tensor((rng.randn(x.shape[0], K27) * 1e-2).astype(np.float32))
    return z, dz, dg + dg.transpose(1, 2), ds


def _max_share(got, ref):
    """max |got - ref| over max |ref|."""
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _rel_fro(got, ref):
    return float(torch.linalg.norm((got.double() - ref.double()).flatten())
                 / torch.linalg.norm(ref.double().flatten()))


def _dp_f64(x, dz, z, w, sym, ds):
    """The float64 patch cotangent (B, H, W, 27)."""
    d = torch.where(z > 0, dz, torch.zeros((), dtype=dz.dtype)).double()
    p = ks1.patches27(x).double()
    return (d @ w.reshape(K27, -1).double().T
            + (p.reshape(x.shape[0], -1, K27) @ sym.double()).reshape(p.shape)
            + ds.double()[:, None, None, :])


# ---------------------------------------------------------------------------
# The route rule and the tile plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cout,want", [
    (64, "tf32x3"), (4, "tf32x3"), (8, "tf32x3"), (60, "tf32x3"),
    (6, None), (62, None), (68, None), (128, None)])
def test_c11_route_float32(cout, want):
    """float32 takes the 3xTF32 kernels with Cout a multiple of 4 up to
    ``C11_TF32_MAX_COUT``; every other float32 width (None) is refused."""
    assert ks1.C11_TF32_MAX_COUT == 64
    if want is None:
        with pytest.raises(ValueError, match=f"cout={cout}"):
            ks1.c11_route(torch.float32, cout)
    else:
        assert ks1.c11_route(torch.float32, cout) == want


@pytest.mark.parametrize("source", ["conv1_1_stats_tf32x3.cu",
                                    "conv1_1_bwd_tf32x3.cu"])
def test_plans_match_the_kernel_sources(source):
    """The tile plans, the route's Cout cap and A's blocks per SM are the
    kernels' own, and each source asserts its shared memory against a
    block's 227 KB when it compiles."""
    text = (CSRC / source).read_text()
    tile = (ks1.C11_STATS_TILE if "stats" in source else ks1.C11_BWD_TILE)
    found = re.search(r"constexpr int TW = (\d+), TH = (\d+);", text)
    assert found and tuple(map(int, found.groups())) == tile
    found = re.search(r"constexpr int MAX_COUT = (\d+);", text)
    assert found and int(found.group(1)) == ks1.C11_TF32_MAX_COUT
    assert "static_assert(SMEM" in text and "232448" in text
    if "stats" in source:
        found = re.search(r"constexpr int BLOCKS_PER_SM = (\d+);", text)
        assert found and int(found.group(1)) == \
            ks1.C11_TF32_STATS_BLOCKS_PER_SM
        assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in text


@pytest.mark.parametrize("bsz,size", [(4, 512), (1, 16), (12, 512)])
def test_tf32_stats_blocks_fill_the_card_once(bsz, size):
    """One block an SM over the batch, never more than an image's tiles,
    and every tile walked by exactly one block."""
    tiles_x, tiles_y = ks1.c11_stats_tiles(size, size)
    tiles = tiles_x * tiles_y
    blocks = ks1.c11_stats_blocks(bsz, size, size,
                                  ks1.C11_TF32_STATS_BLOCKS_PER_SM)
    walked = sorted(t for blk in range(blocks)
                    for t in range(blk, tiles, blocks))
    assert walked == list(range(tiles))
    if tiles >= ks1.SMS:
        assert bsz * blocks >= ks1.SMS
        assert bsz * blocks < ks1.SMS + bsz


def _z_column(p):
    """csrc/conv1_1_stats_tf32x3.cu::z_column."""
    t, j = p & 3, 2 * (p >> 3) + ((p >> 2) & 1)
    return 3 * j + t if t < 3 else 24 + j


def _slab_channel(p):
    """csrc/conv1_1_bwd_tf32x3.cu::slab_channel."""
    kk, col = p >> 3, p & 7
    return 8 * (col & 3) + 4 * (kk >> 1) + 2 * (kk & 1) + (col >> 2)


def test_k_orders_are_permutations_matching_the_fragment_reads():
    """z's k order takes each patch column once, and lane column t of tap
    j (position 8kk + t + 4h, j = 2kk + h) holds tap j's channel t for t <
    3; a slab's order takes each channel once, and thread column t finds
    the channels of k8 steps 2m and 2m + 1 in 16-byte chunk 2t + m, element
    2e + h for step 2m + e and column t + 4h."""
    assert sorted(map(_z_column, range(32))) == list(range(32))
    assert sorted(map(_slab_channel, range(32))) == list(range(32))
    for kk in range(4):
        for t in range(4):
            for h in range(2):
                p = 8 * kk + t + 4 * h
                j = 2 * kk + h
                if t < 3:
                    assert _z_column(p) == 3 * j + t
                m, e = kk >> 1, kk & 1
                assert _slab_channel(p) == 4 * (2 * t + m) + 2 * e + h
    for source, name, fn in (("conv1_1_stats_tf32x3.cu", "z_column",
                              _z_column),
                             ("conv1_1_bwd_tf32x3.cu", "slab_channel",
                              _slab_channel)):
        assert f"int {name}(int p)" in (CSRC / source).read_text()
    assert [_z_column(p) for p in (3, 7, 11, 15)] == [24, 25, 26, 27]


# ---------------------------------------------------------------------------
# A: z with the bias in the product, the statistics by HH + LH + LHᵀ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_stats_emulation_meets_float64(shape):
    x, w, b = _operands(1, shape)
    z, ptp, s27 = emulate_stats_tf32x3(x, w, b)
    p = ks1.patches27(x).double()
    ref = torch.relu(p @ w.reshape(K27, -1).double() + b.double())
    assert _max_share(z, ref) <= 1e-6
    flat = p.reshape(shape[0], -1, K27)
    assert _rel_fro(ptp, flat.transpose(1, 2) @ flat) <= 1e-6
    assert _rel_fro(s27, flat.sum(dim=1)) <= 1e-6
    assert bool((z == 0).any()) and bool((z > 0).any())   # both ReLU sides


def test_one_tf32_product_misses_float64():
    """A single TF32 product of rounded operands, the tensor core's plain
    mode, misses the 1e-6 that three products meet by an order of
    magnitude: the split is needed."""
    x, w, b = _operands(11, (1, 24, 40))
    p = _patches32(x)
    wb = torch.cat([w.reshape(K27, -1), b[None], torch.zeros((4, 64))])
    rnd = lambda t: ((t.view(torch.int32) + 4096) & -8192).view(torch.float32)
    one = torch.relu(rnd(p) @ rnd(wb))
    ref = torch.relu(p.double() @ wb.double())
    assert _max_share(one, ref) > 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_stats_emulation_matches_plain(shape):
    """The emulation against the plain version the wrapper takes on the
    CPU (which the card's kernel is held to)."""
    x, w, b = _operands(2, shape)
    z, ptp, s27 = emulate_stats_tf32x3(x, w, b)
    z_p, ptp_p, s27_p = ks1.conv1_1_stats(x, w, b)
    assert _max_share(z, z_p) <= 1e-6
    assert _rel_fro(ptp, ptp_p) <= 1e-6 and _rel_fro(s27, s27_p) <= 1e-6


def test_ragged_tile_rows_add_nothing():
    """Tile rows past the image are zero, ones column included: s27 and
    PᵀP count only the image's pixels (37 x 29 leaves the last tile column
    29 pixels wide and the last tile row 1 pixel high)."""
    x, w, b = _operands(3, (1, 37, 29))
    _, ptp, s27 = emulate_stats_tf32x3(x, w, b)
    p = ks1.patches27(x)[0].reshape(-1, K27).double()
    tw, th = ks1.C11_STATS_TILE
    assert 29 % tw and 37 % th
    assert _rel_fro(s27[0], p.sum(0)) <= 1e-6
    assert _rel_fro(ptp[0], p.T @ p) <= 1e-6


@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 32, 16)])
def test_stats_emulation_matches_pallas_interpret(shape):
    """K4a in float32 (interpret mode): z, and PᵀP and s27 folded from its
    48-wide quad statistics by the JAX package's selection matrices."""
    x, w, b = _operands(4, shape)
    xj, wj, bj = (jnp.asarray(t.numpy()) for t in (x, w, b))
    z5, g48, s48 = s1.conv1_1_packed(xj, wj, bj, True)
    z_j = torch.tensor(np.asarray(s1.unpack_output5(z5)))
    sel = np.asarray(s1._selection_matrices(3), np.float64)   # (4, 27, 48)
    ptp_j = np.einsum("ikl,blm,inm->bkn", sel, np.asarray(g48, np.float64),
                      sel)
    s27_j = np.einsum("ikl,bl->bk", sel,
                      np.asarray(s48, np.float64).reshape(shape[0], -1))
    z, ptp, s27 = emulate_stats_tf32x3(x, w, b)
    assert _max_share(z, z_j) <= 1e-5
    assert _rel_fro(ptp, torch.tensor(ptp_j)) <= 1e-5
    assert _rel_fro(s27, torch.tensor(s27_j)) <= 1e-5


# ---------------------------------------------------------------------------
# B: d Wᵀ slab by slab and P S' by three products, col2im
# ---------------------------------------------------------------------------

def test_emulated_stats_operand_layout():
    """Row k of S' holds sym[k] for k < 27 and ds27 in row 27; zero rows
    after."""
    rng = np.random.RandomState(6)
    g = torch.tensor(rng.randn(2, K27, K27).astype(np.float32))
    sym, ds = g + g.transpose(1, 2), torch.tensor(
        rng.randn(2, K27).astype(np.float32))
    sp = stats_operand(sym, ds)
    assert sp.shape == (2, 32, K27)
    assert torch.equal(sp[:, :K27], sym) and torch.equal(sp[:, K27], ds)
    assert not bool(sp[:, 28:].any())


@pytest.mark.parametrize("shape,cout", [((2, 16, 16), 64), ((1, 24, 40), 64),
                                        ((1, 37, 29), 64),
                                        ((1, 37, 29), 20)])
def test_bwd_emulation_meets_float64(shape, cout):
    x, w, b = _operands(7, shape, cout)
    z, dz, sym, ds = _bwd_operands(8, x, w, b)
    got = emulate_bwd_tf32x3(x, dz, z, w, sym, ds)
    ref = _col2im(_dp_f64(x, dz, z, w, sym, ds), shape[1], shape[2])
    assert _max_share(got, ref) <= 1e-6


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_emulation_matches_plain(shape):
    """Against the plain version the card's kernel is held to; the S term
    is large enough to matter (dropping it moves dx by more than the
    tolerance)."""
    x, w, b = _operands(9, shape)
    z, dz, sym, ds = _bwd_operands(10, x, w, b)
    got = emulate_bwd_tf32x3(x, dz, z, w, sym, ds)
    ref = ks1.conv1_1_bwd(x, dz, z, w, sym, ds)
    assert _max_share(got, ref) <= 1e-6
    no_s = ks1.conv1_1_bwd(x, dz, z, w, torch.zeros_like(sym), ds)
    assert _max_share(no_s, ref) > 1e-2


@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 32, 16)])
def test_bwd_emulation_matches_pallas_interpret(shape):
    """K4c in float32 (interpret mode) through the VJP of
    ``conv1_1_packed`` and the JAX package's fold of the Gram: the same
    cotangents (z's and the closed-form Gram's) give the emulation's dx,
    which takes JAX's z for its ReLU mask and sym and ds27 from the port's
    closed form."""
    x, w, b = _operands(13, shape)
    bsz, h, wd = shape
    rng = np.random.RandomState(14)
    ct_z = rng.randn(bsz, h, wd, 64).astype(np.float32)
    ct_g = (rng.randn(bsz, 64, 64) * 1e-3).astype(np.float32)
    xj, wj, bj = (jnp.asarray(t.numpy()) for t in (x, w, b))

    def jfn(xx):
        z5, g48, s48 = s1.conv1_1_packed(xx, wj, bj, True)
        return s1.unpack_output5(z5), s1.fold_gram48(g48, s48, wj, bj,
                                                     h * wd)

    (z_j, _), vjp = jax.vjp(jfn, xj)
    (dx_j,) = vjp((jnp.asarray(ct_z), jnp.asarray(ct_g)))
    dx_j = torch.tensor(np.asarray(dx_j))

    ptp = torch.zeros((bsz, K27, K27), requires_grad=True)
    s27 = torch.zeros((bsz, K27), requires_grad=True)
    g = tvgg.gram1_closed_form(ptp, s27, w, b, h * wd)
    dptp, ds = torch.autograd.grad(g, (ptp, s27), torch.tensor(ct_g))
    z = torch.tensor(np.asarray(z_j))
    sym = dptp + dptp.transpose(1, 2)
    got = emulate_bwd_tf32x3(x, torch.tensor(ct_z), z, w, sym, ds)
    assert _max_share(got, dx_j) <= 1e-5
    assert float(dx_j.abs().max()) > 0
