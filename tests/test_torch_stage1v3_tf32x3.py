"""The arithmetic of kernels E and F on their float32 tensor-core route
(``csrc/conv1_1_gram_tf32x3.cu``, ``csrc/conv1_1_gram_bwd_tf32x3.cu``) on
the CPU, with the k orders and tile plans they share with kernels A and B
(``kernels/stage1.py``) and ``hopper.cuh``.

Every factor is split exactly into tf32 hi + lo (``kernels.conv.
split_tf32``) and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi. A TF32
value is a float32 with its low 13 mantissa bits clear, so a float32 matmul
of TF32 operands gives the tensor core's products with float32 sums. The
emulations clear the low bits of the lo parts too, as a tensor core that
truncates would: the worst case the kernels allow.

E's emulation: y = P'W' by the three products (P' the patch rows with the
ones column and zeros to 32 columns, W' the weights with the bias as row
27), z = relu(y). The Gram as the kernel sums it: per block of
``c11_stats_blocks`` (float32's ``C11_TF32_STATS_BLOCKS_PER_SM``), tile by
tile of ``C11_STATS_TILE`` (pixels past the image: y = 0), each tile's HH =
Yhiᵀ Yhi and LH = Yloᵀ Yhi over its 128 pixels added to running sums; the
block's partial (HH + LH) + LHᵀ, an image's partials added in order.

F's emulation follows its kernel tile by tile (``C11_BWD_TILE`` and its
halo box; dz zero outside the image as TMA fills it, P' rows zero there): y
recomputed as E computes it, the mask [y > 0], dP = y·M with M = S·Wᵀ
formed in float32, then each 32-channel slab's (dz·mask)·Wᵀ, each by the
three products into a fresh partial added to the running dP; col2im over
the halo in the kernel's tap order. ``fold=False`` takes d = dz·mask + y·S
(the three products) and d·Wᵀ instead: the function the fold stands for.

The kernels take the k dimension of y's product and of the products whose
A operand is an accumulator in permuted orders (``tf32_patch_column``,
``acc_k_channel``), which change only the order of float32 additions; the
plan tests hold those orders to be permutations that match the fragment
reads.

Tolerances. Against float64: z and dx within 1e-6 of the largest value,
g64 within 1e-6 relative Frobenius. Against the plain versions (the float32
functions the card's kernels are held to): the same 1e-6, both sides lying
within 5e-7 of float64 here. Against the JAX package's K10a and K10b in
float32, interpret mode: 1e-5 of the largest value for z and dx, 1e-5
relative Frobenius for g64, as ``tests/test_torch_stage1_tf32x3.py`` holds
K4a and K4c.
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

from st3d_torch.kernels import conv as kconv
from st3d_torch.kernels import stage1 as ks1
from st3d_torch.kernels import stage1v3 as ks3

K27 = 27
C = 64
SHAPES = [(2, 16, 16), (1, 24, 40), (1, 37, 29)]
JAX_SHAPES = [(2, 16, 24), (1, 32, 16)]     # tests/test_torch_stage1v3.py's
CSRC = Path(ks3.__file__).resolve().parents[1] / "csrc"
SOURCES = {"E": "conv1_1_gram_tf32x3.cu", "F": "conv1_1_gram_bwd_tf32x3.cu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, shape):
    """x in [0, 1) (an image), He-scaled weights, a bias, all float32."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.rand(*shape, 3).astype(np.float32))
    w = torch.tensor((rng.randn(3, 3, 3, C) * (2.0 / 27) ** 0.5)
                     .astype(np.float32))
    b = torch.tensor((rng.randn(C) * 0.1).astype(np.float32))
    return x, w, b


def _bwd_operands(seed, shape, scale=3e-2):
    """dz and sym = dG + dGᵀ, dG at ``scale``: y·S is then a large share of
    d, as in ``chip_smoke.py``'s check."""
    rng = np.random.RandomState(seed)
    dz = torch.tensor(rng.randn(*shape, C).astype(np.float32))
    dg = torch.tensor((rng.randn(shape[0], C, C) * scale).astype(np.float32))
    return dz, dg + dg.transpose(1, 2)


def _trunc(t):
    """t with its low 13 mantissa bits cleared, as a truncating tensor core
    reads a lo part."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _split(t):
    """(hi, lo) of t as the tensor core reads them."""
    hi, lo = kconv.split_tf32(t)
    return hi, _trunc(lo)


def three_products(a, b):
    """a @ b by the 3xTF32 split: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _patches32(x):
    """(B, H, W, 32) float32 P': the patch rows, the ones column, zeros."""
    p = ks1.patches27(x)
    return torch.cat([p, torch.ones_like(p[..., :1]),
                      torch.zeros_like(p[..., :4])], dim=-1)


def _w_bias(w, b):
    """(32, 64) float32 W': the weights, the bias as row 27, zero rows."""
    return torch.cat([w.reshape(K27, C), b.reshape(1, C),
                      torch.zeros((4, C))])


def emulate_gram_tf32x3(x, w, b):
    """E's float32 route: (z, g64) as the kernel sums them."""
    bsz, h, wd, _ = x.shape
    y = three_products(_patches32(x), _w_bias(w, b))
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(h, wd)
    blocks = ks1.c11_stats_blocks(bsz, h, wd,
                                  ks1.C11_TF32_STATS_BLOCKS_PER_SM)
    # Pixels past the image: a zero patch row, ones column included: y = 0.
    yp = F.pad(y, (0, 0, 0, tiles_x * tw - wd, 0, tiles_y * th - h))
    y_hi, y_lo = _split(yp)
    g64 = torch.zeros((bsz, C, C))
    for bi in range(bsz):
        total = torch.zeros((C, C))
        for blk in range(blocks):
            hh, lh = torch.zeros((C, C)), torch.zeros((C, C))
            for t in range(blk, tiles_x * tiles_y, blocks):
                y0, x0 = (t // tiles_x) * th, (t % tiles_x) * tw
                box = (bi, slice(y0, y0 + th), slice(x0, x0 + tw))
                hi = y_hi[box].reshape(-1, C)
                lo = y_lo[box].reshape(-1, C)
                hh = hh + hi.T @ hi
                lh = lh + lo.T @ hi
            total = total + ((hh + lh) + lh.T)
        g64[bi] = total
    return torch.relu(y), g64


def emulate_gram_bwd_tf32x3(x, dz, w, b, sym, fold=True):
    """F's float32 route: dx as the kernel computes it, tile by tile of
    ``C11_BWD_TILE`` over its halo box. ``fold=False``: d = dz·mask + y·S,
    then d·Wᵀ, in place of y·M + (dz·mask)·Wᵀ."""
    bsz, h, wd, _ = x.shape
    tw, th = ks1.C11_BWD_TILE
    hx, hy = tw + 2, th + 2
    tiles_x, tiles_y = ks1.c11_bwd_tiles(h, wd)
    ring = (0, 0, 1, tiles_x * tw + 1 - wd, 1, tiles_y * th + 1 - h)
    p = F.pad(_patches32(x), ring)
    dzp = F.pad(dz, ring)
    wb = _w_bias(w, b)
    wt = w.reshape(K27, C).T
    m = sym @ wt                                  # M = S Wᵀ, (B, 64, 27)
    dx = torch.zeros((bsz, tiles_y * th, tiles_x * tw, 3))
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            y0, x0 = ty * th, tx * tw                   # halo box origin + 1
            box = (slice(None), slice(y0, y0 + hy), slice(x0, x0 + hx))
            y = three_products(p[box].reshape(bsz, -1, 32), wb)
            d = torch.where(y > 0, dzp[box].reshape(bsz, -1, C),
                            torch.zeros(()))
            if fold:
                acc = three_products(y, m)
            else:
                d = d + three_products(y, sym)
                acc = torch.zeros((bsz, hy * hx, K27))
            for c0 in range(0, C, 32):
                acc = acc + three_products(d[..., c0:c0 + 32],
                                           wt[c0:c0 + 32])
            dp = acc.reshape(bsz, hy, hx, K27)
            out = torch.zeros((bsz, th, tw, 3))
            for dy in range(3):
                for ddx in range(3):
                    k = (dy * 3 + ddx) * 3
                    out = out + dp[:, 2 - dy:2 - dy + th,
                                   2 - ddx:2 - ddx + tw, k:k + 3]
            dx[:, y0:y0 + th, x0:x0 + tw] = out
    return dx[:, :h, :wd]


def _y64(x, w, b):
    """(B, H, W, 64) float64 pre-ReLU y."""
    return ks1.patches27(x).double() @ w.reshape(K27, C).double() \
        + b.double()


def _dx64(x, dz, w, b, sym):
    """The float64 dx: d = dz·[y > 0] + y·S, col2im(d Wᵀ)."""
    y = _y64(x, w, b)
    d = torch.where(y > 0, dz.double(), torch.zeros((), dtype=y.dtype)) \
        + (y.reshape(x.shape[0], -1, C) @ sym.double()).reshape(y.shape)
    return _col2im(d @ w.reshape(K27, C).double().T, x.shape[1], x.shape[2])


def _col2im(dp, h, wd):
    """(B, H, W, 27) patch cotangents onto the (B, H, W, 3) image."""
    bsz = dp.shape[0]
    dxp = torch.zeros((bsz, h + 2, wd + 2, 3), dtype=dp.dtype)
    for dy in range(3):
        for dx in range(3):
            k = (dy * 3 + dx) * 3
            dxp[:, dy:dy + h, dx:dx + wd, :] += dp[..., k:k + 3]
    return dxp[:, 1:h + 1, 1:wd + 1, :]


def _max_share(got, ref):
    """max |got - ref| over max |ref|."""
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _rel_fro(got, ref):
    return float(torch.linalg.norm((got.double() - ref.double()).flatten())
                 / torch.linalg.norm(ref.double().flatten()))


# ---------------------------------------------------------------------------
# The k orders and the plans
# ---------------------------------------------------------------------------

def _tf32_patch_column(p):
    """hopper.cuh::tf32_patch_column."""
    t, j = p & 3, 2 * (p >> 3) + ((p >> 2) & 1)
    return 3 * j + t if t < 3 else 24 + j


def _acc_k_channel(p):
    """hopper.cuh::acc_k_channel."""
    return (p & ~7) + 2 * (p & 3) + ((p >> 2) & 1)


def _cuh_return(name):
    """The return expression of ``int name(int p)`` in hopper.cuh, as a
    Python function of p (``a ? b : c`` read as one conditional)."""
    text = (CSRC / "hopper.cuh").read_text()
    found = re.search(r"constexpr int " + name + r"\(int p\) \{\s*return "
                      r"(.*?);\s*\}", text, re.S)
    assert found, name
    expr = " ".join(found.group(1).split())
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        yes, no = rest.split(":", 1)
        expr = f"({yes}) if ({cond}) else ({no})"
    return lambda p: eval(expr, {"p": p})


def test_k_orders_are_permutations_matching_the_fragment_reads():
    """y's k order takes each patch column once (kernel A f32's z_column),
    lane column t of tap j (position 8kk + t + 4h, j = 2kk + h) holding tap
    j's channel t for t < 3. The accumulator order takes each of 64
    channels once, within its k8 step, and position 8kk + t + 4h of the A
    fragment of thread column t (row r of its two) is the accumulator entry
    4kk + 2r + h that thread holds: row 8r + l/4, column 8kk + 2t + h. The
    sources' expressions are these."""
    assert sorted(map(_tf32_patch_column, range(32))) == list(range(32))
    assert sorted(map(_acc_k_channel, range(64))) == list(range(64))
    for kk in range(4):
        for t in range(4):
            for h in range(2):
                j = 2 * kk + h
                if t < 3:
                    assert _tf32_patch_column(8 * kk + t + 4 * h) == 3 * j + t
    assert [_tf32_patch_column(p) for p in (3, 7, 11, 15)] == [24, 25, 26, 27]
    for kk in range(8):
        for t in range(4):
            for r in range(2):
                for h in range(2):
                    v = 4 * kk + 2 * r + h                  # acc index
                    col = 8 * (v >> 2) + 2 * t + (v & 1)
                    row = 8 * ((v >> 1) & 1)
                    p = 8 * kk + t + 4 * h                  # A position
                    assert _acc_k_channel(p) == col and row == 8 * r
                    # F's dz read: channel col of a slab lies in 16-byte
                    # chunk 2m + t // 2 at byte 8 (t % 2) + 4h, m = kk % 4.
                    c = col % 32
                    assert (c // 4, 4 * (c % 4)) == \
                        (2 * (kk % 4) + t // 2, 8 * (t % 2) + 4 * h)
    for name, fn, n in (("tf32_patch_column", _tf32_patch_column, 32),
                        ("acc_k_channel", _acc_k_channel, 64)):
        src = _cuh_return(name)
        assert [src(p) for p in range(n)] == [fn(p) for p in range(n)]
    a_src = (CSRC / "conv1_1_stats_tf32x3.cu").read_text()
    assert "int z_column(int p)" in a_src   # A's own copy of the same order


@pytest.mark.parametrize("kernel", ["E", "F"])
def test_plans_match_the_kernel_sources(kernel):
    """The plans are the kernels' own: each source's (TW, TH) is the plan's
    (E kernel A's, F kernel B's); E runs two warpgroups with
    ``C11_TF32_STATS_BLOCKS_PER_SM`` blocks to an SM; F three warpgroups of
    two 64-row groups, 32-channel slabs of the 64 channels in two stages;
    both assert their shared memory when they compile, and both take y from
    hopper.cuh's one sequence of instructions."""
    text = (CSRC / SOURCES[kernel]).read_text()
    found = re.search(r"constexpr int TW = (\d+), TH = (\d+);", text)
    tile = ks1.C11_STATS_TILE if kernel == "E" else ks1.C11_BWD_TILE
    assert found and tuple(map(int, found.groups())) == tile
    assert "static_assert(SMEM" in text and "232448" in text
    if kernel == "E":
        assert "constexpr int THREADS = 256;" in text
        found = re.search(r"constexpr int BLOCKS_PER_SM = (\d+);", text)
        assert found and int(found.group(1)) == \
            ks1.C11_TF32_STATS_BLOCKS_PER_SM
        assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in text
        assert "conv1_1_y_tf32x3<HX>(" in text
    else:
        assert "constexpr int WGS = 3;" in text
        assert "constexpr int SLABS = C / 32;" in text
        assert "constexpr int STAGES = 2;" in text
        assert "M == 64 * GROUPS * WGS && M == THREADS" in text
        assert "conv1_1_y_tf32x3<HX + 2>(" in text
    assert "load_conv1_1_wb_tf32x3<THREADS>" in text
    assert ks3.v3_route(torch.float32) == "tf32x3"


@pytest.mark.parametrize("bsz,size", [(4, 512), (1, 16), (12, 512)])
def test_gram_blocks_fill_the_card_once(bsz, size):
    """E's float32 plan: one block an SM over the batch, never more than
    an image's tiles, every tile walked by exactly one block."""
    tiles_x, tiles_y = ks1.c11_stats_tiles(size, size)
    tiles = tiles_x * tiles_y
    blocks = ks1.c11_stats_blocks(bsz, size, size,
                                  ks1.C11_TF32_STATS_BLOCKS_PER_SM)
    walked = sorted(t for blk in range(blocks)
                    for t in range(blk, tiles, blocks))
    assert walked == list(range(tiles))
    if tiles >= ks1.SMS:
        assert ks1.SMS <= bsz * blocks < ks1.SMS + bsz


# ---------------------------------------------------------------------------
# E: y by three products, z, the Gram by HH + LH + LHᵀ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_gram_emulation_meets_float64(shape):
    x, w, b = _operands(1, shape)
    z, g64 = emulate_gram_tf32x3(x, w, b)
    y = _y64(x, w, b)
    assert _max_share(z, torch.relu(y)) <= 1e-6
    flat = y.reshape(shape[0], -1, C)
    assert _rel_fro(g64, flat.transpose(1, 2) @ flat) <= 1e-6
    assert bool((z == 0).any()) and bool((z > 0).any())   # both ReLU sides


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_emulation_matches_plain(shape):
    """Against the plain version the wrapper takes on the CPU (which the
    card's kernel is held to)."""
    x, w, b = _operands(2, shape)
    z, g64 = emulate_gram_tf32x3(x, w, b)
    z_p, g_p = ks3.conv1_1_gram(x, w, b)
    assert _max_share(z, z_p) <= 1e-6
    assert _rel_fro(g64, g_p) <= 1e-6


def test_two_gram_products_give_the_three():
    """g = HH + LH + LHᵀ, with Yhiᵀ Ylo = LHᵀ, is the three-product Gram
    Yhiᵀ Yhi + Yloᵀ Yhi + Yhiᵀ Ylo to float32 rounding; both meet float64."""
    x, w, b = _operands(3, (1, 24, 40))
    y = three_products(_patches32(x), _w_bias(w, b)).reshape(-1, C)
    hi, lo = _split(y)
    hh, lh = hi.T @ hi, lo.T @ hi
    two = (hh + lh) + lh.T
    three = hh + lh + hi.T @ lo
    assert _rel_fro(two, three) <= 1e-7
    ref = _y64(x, w, b).reshape(-1, C)
    for g in (two, three):
        assert _rel_fro(g, ref.T @ ref) <= 1e-6
    assert _rel_fro(hh, ref.T @ ref) > 1e-5        # the lo parts matter


def test_one_tf32_product_misses_float64():
    """A single TF32 product of rounded operands, the tensor core's plain
    mode, misses the 1e-6 that the split meets by an order of magnitude,
    for y and for the Gram: the split is needed."""
    x, w, b = _operands(11, (1, 24, 40))
    rnd = lambda t: ((t.view(torch.int32) + 4096) & -8192).view(torch.float32)
    y1 = rnd(_patches32(x)) @ rnd(_w_bias(w, b))
    ref = _y64(x, w, b)
    assert _max_share(torch.relu(y1), torch.relu(ref)) > 1e-5
    yf = ref.float().reshape(-1, C)
    g1 = rnd(yf).T @ rnd(yf)
    flat = ref.reshape(-1, C)
    assert _rel_fro(g1, flat.T @ flat) > 1e-5


def test_ragged_tile_rows_add_nothing():
    """Tile pixels past the image have a zero patch row, ones column
    included, so y = 0 there: g64 is the Gram of the image's pixels alone.
    At 37 x 29 the one tile column is 3 pixels short and the last tile row
    1 pixel high, 207 pixels past the image; had they kept the ones column,
    each would add bᵀb."""
    x, w, b = _operands(4, (1, 37, 29))
    _, g64 = emulate_gram_tf32x3(x, w, b)
    tw, th = ks1.C11_STATS_TILE
    tiles_x, tiles_y = ks1.c11_stats_tiles(37, 29)
    past = tiles_x * tw * tiles_y * th - 37 * 29
    assert past == 207
    y = _y64(x, w, b).reshape(-1, C)
    assert _rel_fro(g64[0], y.T @ y) <= 1e-6
    bias = b.double().reshape(1, C)
    assert _rel_fro(g64[0], y.T @ y + past * bias.T @ bias) > 1e-4


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_gram_emulation_matches_pallas_interpret(shape):
    """K10a in float32 (interpret mode): z after unpacking, and g64."""
    x, w, b = _operands(5, shape)
    xj, wj, bj = (jnp.asarray(t.numpy()) for t in (x, w, b))
    z5, g_j = s3.conv1_1_packed_v3(xj, wj, bj, True)
    z_j = torch.tensor(np.asarray(unpack_output5(z5)))
    z, g64 = emulate_gram_tf32x3(x, w, b)
    assert _max_share(z, z_j) <= 1e-5
    assert _rel_fro(g64, torch.tensor(np.asarray(g_j))) <= 1e-5


# ---------------------------------------------------------------------------
# F: y recomputed, the mask, y·M with M = S·Wᵀ, (dz·mask)·Wᵀ by slabs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_gram_bwd_emulation_meets_float64(shape):
    x, w, b = _operands(7, shape)
    dz, sym = _bwd_operands(8, shape)
    got = emulate_gram_bwd_tf32x3(x, dz, w, b, sym)
    assert _max_share(got, _dx64(x, dz, w, b, sym)) <= 1e-6


@pytest.mark.parametrize("shape", SHAPES)
def test_m_fold_matches_the_direct_product(shape):
    """dP = y·(S·Wᵀ) + (dz·mask)·Wᵀ against d·Wᵀ with d = dz·mask + y·S,
    both by three products: the same function up to float32 rounding, so
    the fold is held to the float32 tolerance."""
    x, w, b = _operands(9, shape)
    dz, sym = _bwd_operands(10, shape)
    folded = emulate_gram_bwd_tf32x3(x, dz, w, b, sym)
    direct = emulate_gram_bwd_tf32x3(x, dz, w, b, sym, fold=False)
    assert _max_share(folded, direct) <= 1e-6
    ref = _dx64(x, dz, w, b, sym)
    assert _max_share(direct, ref) <= 1e-6


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_bwd_emulation_matches_plain(shape):
    """Against the plain version the card's kernel is held to; the Gram
    cotangent is large enough to matter (dropping it, or taking S of the
    next image, moves the plain dx by more than the tolerance)."""
    x, w, b = _operands(12, shape)
    dz, sym = _bwd_operands(13, shape)
    got = emulate_gram_bwd_tf32x3(x, dz, w, b, sym)
    ref = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    assert _max_share(got, ref) <= 1e-6
    others = [torch.zeros_like(sym)] + ([sym.roll(1, 0)] if shape[0] > 1
                                        else [])
    for other in others:
        assert _max_share(ks3.conv1_1_gram_bwd(x, dz, w, b, other), ref) \
            > 1e-2


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_gram_bwd_emulation_matches_pallas_interpret(shape):
    """K10b in float32 (interpret mode) through the VJP of
    ``conv1_1_packed_v3``: the same cotangents of z and g64 give the
    emulation's dx, with sym = dG + dGᵀ as the autograd function forms it."""
    x, w, b = _operands(14, shape)
    bsz, h, wd = shape
    rng = np.random.RandomState(15)
    ct_z = rng.randn(bsz, h, wd, C).astype(np.float32)
    ct_g = (rng.randn(bsz, C, C) * 3e-2).astype(np.float32)
    xj, wj, bj = (jnp.asarray(t.numpy()) for t in (x, w, b))
    _, vjp = jax.vjp(lambda xx: s3.conv1_1_packed_v3(xx, wj, bj, True), xj)
    (dx_j,) = vjp((pack_input5(jnp.asarray(ct_z)), jnp.asarray(ct_g)))
    dx_j = torch.tensor(np.asarray(dx_j))
    dg = torch.tensor(ct_g)
    got = emulate_gram_bwd_tf32x3(x, torch.tensor(ct_z), w, b,
                                  dg + dg.transpose(1, 2))
    assert _max_share(got, dx_j) <= 1e-5
    assert float(dx_j.abs().max()) > 0


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------

def test_cpu_float32_takes_the_plain_versions():
    """On the CPU the float32 route runs the plain versions and launches
    nothing, though ``v3_route`` names the tensor cores for float32."""
    before = dict(ks3.LAUNCHES)
    x, w, b = _operands(18, (1, 8, 8))
    dz, sym = _bwd_operands(19, (1, 8, 8))
    for got, want in zip(ks3.conv1_1_gram(x, w, b),
                         ks3.conv1_1_gram_plain(x, w, b)):
        assert torch.equal(got, want)
    assert torch.equal(ks3.conv1_1_gram_bwd(x, dz, w, b, sym),
                       ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym))
    assert ks3.LAUNCHES == before
    assert {"conv1_1_gram_tf32x3", "conv1_1_gram_bwd_tf32x3"} <= set(before)


def test_plain_bwd_takes_a_given_mask():
    """``mask`` stands for [y > 0] in the plain F: y > 0 itself gives the
    same dx, and flipping one pixel's mask moves dx by that pixel's dz·W
    alone (the check on the card holds F to the plain F masked by E's own
    z > 0)."""
    x, w, b = _operands(20, (1, 12, 10))
    dz, sym = _bwd_operands(21, (1, 12, 10))
    y = _y64(x, w, b).float()
    ref = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
    assert torch.equal(
        ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym, mask=y > 0), ref)
    mask = y > 0
    mask[0, 5, 4, 7] = ~mask[0, 5, 4, 7]
    moved = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym, mask=mask)
    one = torch.zeros_like(dz)
    one[0, 5, 4, 7] = dz[0, 5, 4, 7] * (1.0 if mask[0, 5, 4, 7] else -1.0)
    want = _col2im(one.double() @ w.reshape(K27, C).double().T, 12, 10)
    assert _max_share(moved - ref, want) <= 1e-5
