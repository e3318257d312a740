"""The arithmetic of K2's, D's, C's and K3's float32 routes on the tensor
cores (``csrc/conv3x3_tf32x3.cu`` with its two epilogues,
``csrc/pool_route_tf32x3.cu``, ``csrc/gram_tf32x3.cu``), on the CPU:
the exact split of ``kernels.conv.split_tf32`` and plain-torch emulations
of the kernels' three TF32 products. A TF32 value is a float32 with its low 13 mantissa
bits clear; the product of two is exact in float32, so a float32 matmul of
TF32 operands gives the tensor core's products with float32 sums.

The emulation clears the low bits of the lo parts too, as a tensor core
that truncates would: the worst case the kernel allows. Three products
land within 1e-6 of the largest output of a float64 conv at 16² x 64 ->
64; one product of operands rounded to TF32 (the tensor core's plain TF32
mode, at its most favourable) misses 1e-6 by two orders of magnitude. The
emulation also matches the JAX package's K2 (Pallas, interpret mode),
forward and input gradient, within the float32 tolerance of 1e-5 that
``tests/test_torch_conv.py`` holds the plain version to.

D's emulation follows its kernel step by step: the routed cotangent
(masked by pooled > 0, placed by idx), split, and each k-iteration (one
32-channel slab of one tap) summed into a fresh partial that is added to
the running sum. It lands within 1e-6 of the largest output of a float64
transpose conv at 16² x 64 -> 64, and matches the JAX package's K5
backward (Pallas, interpret mode).

C's emulation is K2's mainloop in its order (tap by tap, 32-channel slabs
inside a tap, a fresh partial each) with bias, ReLU and the first-max pool
in float32: within 1e-6 of the largest output of a float64 conv + ReLU +
pool, matching the JAX package's K5 forward, and bit-equal to the plain
version on integer data, where ties and all-zero windows abound. K3's
emulation sums each 32-pixel box's three products into a fresh partial,
the boxes of a ``gram_split`` slice in order, then the slices in order:
within 1e-6 (relative Frobenius) of a float64 Gram, and matching the JAX
package's K3 G."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from st3d.kernels import conv_pallas as cp

from st3d_torch.kernels import conv as kconv


def _bits(t):
    return t.contiguous().view(torch.int32)


def _trunc(t):
    """t with its low 13 mantissa bits cleared."""
    return (_bits(t) & -8192).view(torch.float32)


def _round_tf32(t):
    """t rounded to the nearest TF32 value (ties away from zero)."""
    return ((_bits(t) + 4096) & -8192).view(torch.float32)


def _conv(x, w, b=None):
    """K2's plain version (float32 sums) with a zero bias by default."""
    if b is None:
        b = torch.zeros(w.shape[3], dtype=x.dtype)
    return kconv.conv3x3_nhwc_plain(x, w, b)


def emulate_3xtf32(x, w, b):
    """The kernel's sum: a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, with
    every operand a TF32 value."""
    xh, xl = kconv.split_tf32(x)
    wh, wl = kconv.split_tf32(w)
    return _conv(_trunc(xl), wh) + _conv(xh, _trunc(wl)) + _conv(xh, wh, b)


def conv_f64(x, w, b):
    y = F.conv2d(x.double().permute(0, 3, 1, 2),
                 w.double().permute(3, 2, 0, 1), b.double(), padding=1)
    return y.permute(0, 2, 3, 1)


def _operands(seed, shape=(2, 16, 16, 64), cout=64):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(*shape).astype(np.float32))
    w = torch.tensor((rng.randn(3, 3, shape[3], cout)
                      * (2.0 / (9 * shape[3])) ** 0.5).astype(np.float32))
    b = torch.tensor((0.1 * rng.randn(cout)).astype(np.float32))
    return x, w, b


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4, 1e30])
def test_split_is_exact(scale):
    rng = np.random.RandomState(0)
    t = torch.tensor((rng.randn(4096) * scale).astype(np.float32))
    t[:4] = torch.tensor([0.0, -0.0, 1e-45, -3e-39])     # zeros, subnormals
    hi, lo = kconv.split_tf32(t)
    assert torch.equal(_bits(hi + lo), _bits(t))
    assert int((_bits(hi) & 8191).abs().sum()) == 0
    assert torch.equal(hi, _trunc(t)) and torch.equal(lo, t - hi)
    # lo carries only the 13 cleared bits: |lo| < 2^-10 |t| for a normal t.
    normal = t.abs() >= 2.0 ** -126
    assert bool((lo.abs() <= t.abs() * 2.0 ** -10)[normal].all())


def test_split_of_weights_keeps_the_layout():
    w = _operands(1)[1].permute(3, 0, 1, 2)              # a strided view
    hi, lo = kconv.split_tf32(w)
    assert hi.shape == lo.shape == w.shape
    assert torch.equal(hi + lo, w)


@pytest.mark.parametrize("seed", [2, 3])
def test_three_products_meet_1e6_of_float64(seed):
    x, w, b = _operands(seed)
    ref = conv_f64(x, w, b)
    scale = float(ref.abs().max())
    err3 = float((emulate_3xtf32(x, w, b).double() - ref).abs().max())
    assert err3 <= 1e-6 * scale


@pytest.mark.parametrize("seed", [2, 3])
def test_one_tf32_product_misses_1e6_of_float64(seed):
    x, w, b = _operands(seed)
    ref = conv_f64(x, w, b)
    scale = float(ref.abs().max())
    err1 = float((_conv(_round_tf32(x), _round_tf32(w), b).double()
                  - ref).abs().max())
    assert err1 > 1e-5 * scale


@pytest.mark.parametrize("shape,cout", [((2, 8, 12, 16), 32),
                                        ((1, 6, 4, 32), 16)])
def test_emulation_matches_pallas_interpret(shape, cout):
    """Forward and input gradient: the 3xTF32 sums against the JAX
    package's K2 in interpret mode; the dx side runs the same sums on the
    flipped, IO-transposed weights, as the kernel does."""
    x, w, b = _operands(4, shape, cout)
    y_j, vjp = jax.vjp(lambda xx: cp.conv3x3_bias(
        xx, jnp.asarray(w.numpy()), jnp.asarray(b.numpy()), True),
        jnp.asarray(x.numpy()))
    y_e = emulate_3xtf32(x, w, b)
    np.testing.assert_allclose(y_e.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)
    ct = torch.tensor(np.random.RandomState(5).randn(*y_e.shape)
                      .astype(np.float32))
    (dx_j,) = vjp(jnp.asarray(ct.numpy()))
    wt = kconv.transpose_weights(w, torch.float32)
    dx_e = emulate_3xtf32(ct, wt, torch.zeros(shape[3]))
    np.testing.assert_allclose(dx_e.numpy(), np.asarray(dx_j), atol=1e-4,
                               rtol=1e-4)


SLAB = 32                        # f32 channels per k-iteration of D's kernel


def emulate_pool_route_tf32x3(ct, pooled, idx, w):
    """D's float32 sum: route(ct * [pooled > 0], idx), split, and for each
    (slab, tap) the three TF32 products into a fresh partial, added to the
    running sum."""
    routed = kconv.route_pool_cotangent(ct, pooled, idx)
    rh, rl = kconv.split_tf32(routed)
    pad = (0, 0, 1, 1, 1, 1)
    rh, rl = F.pad(rh, pad), F.pad(_trunc(rl), pad)
    wh, wl = kconv.split_tf32(kconv.transpose_weights(w, torch.float32))
    wl = _trunc(wl)
    bsz, h, wd, c = routed.shape
    acc = torch.zeros((bsz, h, wd, w.shape[2]))
    for c0 in range(0, c, SLAB):
        ks = slice(c0, c0 + SLAB)
        for dy in range(3):
            for dx in range(3):
                a_h = rh[:, dy:dy + h, dx:dx + wd, ks]
                a_l = rl[:, dy:dy + h, dx:dx + wd, ks]
                part = (a_l @ wh[dy, dx, ks] + a_h @ wl[dy, dx, ks]
                        + a_h @ wh[dy, dx, ks])
                acc = acc + part
    return acc


def _pool_operands(seed, shape=(2, 16, 16, 64), cin=64):
    """ct, pooled, idx of a (B, H, W, C) pre-pool ReLU activation, and the
    forward weights (3, 3, Cin, C)."""
    rng = np.random.RandomState(seed)
    pre = torch.relu(torch.tensor(rng.randn(*shape).astype(np.float32)))
    pooled, idx = kconv.pool4_first_max(pre)
    ct = torch.tensor(rng.randn(*pooled.shape).astype(np.float32))
    w = torch.tensor((rng.randn(3, 3, cin, shape[3])
                      * (2.0 / (9 * cin)) ** 0.5).astype(np.float32))
    return ct, pooled, idx, w


@pytest.mark.parametrize("seed", [2, 3])
def test_pool_route_three_products_meet_1e6_of_float64(seed):
    ct, pooled, idx, w = _pool_operands(seed)
    routed = kconv.route_pool_cotangent(ct, pooled, idx)
    wt = kconv.transpose_weights(w, torch.float32)
    ref = conv_f64(routed, wt, torch.zeros(w.shape[2]))
    scale = float(ref.abs().max())
    got = emulate_pool_route_tf32x3(ct, pooled, idx, w)
    assert float((got.double() - ref).abs().max()) <= 1e-6 * scale
    # The plain version, float32 sums over the whole K at once, is as close.
    plain = kconv.pool_route_conv3x3_bwd_plain(ct, pooled, idx, w)
    assert float((plain.double() - ref).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("shape,cin", [((1, 16, 16, 64), 64),
                                       ((2, 8, 12, 48), 16)])
def test_pool_route_emulation_matches_pallas_interpret(shape, cin):
    """D's sums on the JAX package's forward outputs against its K5
    backward (``conv3x3_bias_relu_pool_packed``'s VJP in interpret mode),
    within the float32 tolerance of tests/test_torch_stage1.py; C = 48
    leaves the second slab half empty, as the kernel's zero fill does."""
    rng = np.random.RandomState(6)
    x = rng.randn(*shape[:3], cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, shape[3]) * 0.1).astype(np.float32)
    b = rng.randn(shape[3]).astype(np.float32)
    ct = rng.randn(shape[0], shape[1] // 2, shape[2] // 2,
                   shape[3]).astype(np.float32)
    (p_j, i_j), vjp = jax.vjp(
        lambda xx: cp.conv3x3_bias_relu_pool_packed(
            xx, jnp.asarray(w), jnp.asarray(b), True), jnp.asarray(x))
    (dx_j,) = vjp((jnp.asarray(ct), jnp.zeros_like(i_j)))
    dx_e = emulate_pool_route_tf32x3(
        torch.tensor(ct), torch.tensor(np.asarray(p_j)),
        torch.tensor(np.asarray(i_j)).to(torch.uint8), torch.tensor(w))
    dx_j = np.asarray(dx_j)
    assert float(np.abs(dx_j).max()) > 0
    np.testing.assert_allclose(dx_e.numpy(), dx_j, rtol=1e-4,
                               atol=1e-4 * np.abs(dx_j).max())


def emulate_relu_pool_tf32x3(x, w, b):
    """C's float32 sum in its kernel's order: for each tap, each 32-channel
    slab's three TF32 products into a fresh partial added to the running
    sum; then bias, ReLU and ``pool4_first_max``."""
    xh, xl = kconv.split_tf32(x)
    pad = (0, 0, 1, 1, 1, 1)
    xh, xl = F.pad(xh, pad), F.pad(_trunc(xl), pad)
    wh, wl = kconv.split_tf32(w)
    wl = _trunc(wl)
    bsz, h, wd, cin = x.shape
    acc = torch.zeros((bsz, h, wd, w.shape[3]))
    for dy in range(3):
        for dx in range(3):
            for c0 in range(0, cin, SLAB):
                ks = slice(c0, c0 + SLAB)
                a_h = xh[:, dy:dy + h, dx:dx + wd, ks]
                a_l = xl[:, dy:dy + h, dx:dx + wd, ks]
                acc = acc + (a_l @ wh[dy, dx, ks] + a_h @ wl[dy, dx, ks]
                             + a_h @ wh[dy, dx, ks])
    return kconv.pool4_first_max(torch.relu(acc + b))


def _pool_f64(x, w, b):
    """float64 conv + ReLU, and its 2x2 windows (..., 4) in scan order."""
    pre = torch.relu(conv_f64(x, w, b))
    bsz, h, wd, c = pre.shape
    win = pre.reshape(bsz, h // 2, 2, wd // 2, 2, c).permute(
        0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, c, 4)
    return pre, win


@pytest.mark.parametrize("seed", [2, 3])
def test_relu_pool_three_products_meet_1e6_of_float64(seed):
    x, w, b = _operands(seed)
    _, win = _pool_f64(x, w, b)
    ref = win.max(dim=-1).values
    scale = float(ref.abs().max())
    pooled, idx = emulate_relu_pool_tf32x3(x, w, b)
    assert float((pooled.double() - ref).abs().max()) <= 1e-6 * scale
    # idx names the window's maximum wherever the top two are separated.
    top2 = win.sort(dim=-1).values[..., -2:]
    sep = (top2[..., 1] - top2[..., 0]) > 1e-6 * scale
    pick = win.argmax(dim=-1)
    assert bool(sep.float().mean() > 0.5)
    assert torch.equal(idx.long()[sep], pick[sep])


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 32), 64),
                                        ((1, 8, 12, 48), 24)])
def test_relu_pool_emulation_matches_pallas_interpret(shape, cout):
    """C's sums against the JAX package's K5 forward
    (``conv3x3_bias_relu_pool_packed`` in interpret mode): pooled within
    1e-5 of max, idx equal wherever the float64 window's top two are more
    than that apart. Cin = 48 leaves the second slab half empty, as the
    kernel's zero fill does."""
    x, w, b = _operands(7, shape, cout)
    p_j, i_j = cp.conv3x3_bias_relu_pool_packed(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), True)
    p_j, i_j = np.asarray(p_j), np.asarray(i_j)
    pooled, idx = emulate_relu_pool_tf32x3(x, w, b)
    scale = float(np.abs(p_j).max())
    np.testing.assert_allclose(pooled.numpy(), p_j, rtol=0,
                               atol=1e-5 * scale)
    _, win = _pool_f64(x, w, b)
    top2 = win.sort(dim=-1).values[..., -2:]
    sep = ((top2[..., 1] - top2[..., 0]) > 1e-5 * scale).numpy()
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(idx.numpy()[sep], i_j[sep])


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 16), 64),
                                        ((1, 8, 10, 36), 40)])
def test_relu_pool_emulation_keeps_ties_bit_equal(shape, cout):
    """Integer operands (x, w in {-1, 0, 1}, b in {-2..2}) split exactly
    (lo = 0) and sum exactly in float32, so exact ties and all-zero windows
    are common: pooled and idx equal the plain version's bit for bit (idx
    is the first maximum in scan order, 0 for an all-zero window)."""
    rng = np.random.RandomState(8)
    x = torch.tensor(rng.randint(-1, 2, shape).astype(np.float32))
    w = torch.tensor(rng.randint(-1, 2, (3, 3, shape[3], cout))
                     .astype(np.float32))
    b = torch.tensor(rng.randint(-2, 3, cout).astype(np.float32))
    pooled, idx = emulate_relu_pool_tf32x3(x, w, b)
    p_ref, i_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    _, win = _pool_f64(x, w, b)
    top2 = win.sort(dim=-1).values[..., -2:]
    assert bool((top2[..., 1] == top2[..., 0]).any())       # ties
    zero = p_ref == 0
    assert bool(zero.any())                                 # zero windows
    assert bool((i_ref[zero] == 0).all())
    assert torch.equal(_bits(pooled), _bits(p_ref))
    assert torch.equal(idx, i_ref)


BOX = 32                           # pixels per box of K3's float32 kernel


def emulate_gram_tf32x3(y):
    """K3's float32 sum: y (B, P, C) split, each 32-pixel box's three TF32
    products into a fresh partial added to its slice's running sum (the
    slices of ``gram_split``'s float32 route), then the slices added in
    order."""
    bsz, pixels, c = y.shape
    slices, slice_len = kconv.gram_split(bsz, pixels, c, "tf32x3")
    assert slice_len % BOX == 0
    yh, yl = kconv.split_tf32(y)
    yl = _trunc(yl)
    g = torch.zeros((bsz, c, c))
    for s0 in range(0, pixels, slice_len):
        acc = torch.zeros((bsz, c, c))
        for p0 in range(s0, min(pixels, s0 + slice_len), BOX):
            h, lo = yh[:, p0:p0 + BOX], yl[:, p0:p0 + BOX]
            acc = acc + (lo.transpose(1, 2) @ h + h.transpose(1, 2) @ lo
                         + h.transpose(1, 2) @ h)
        g = g + acc
    return g


def _rel_fro(got, ref):
    return float(torch.linalg.norm((got.double() - ref.double()).flatten())
                 / torch.linalg.norm(ref.double().flatten()))


@pytest.mark.parametrize("shape", [(2, 32 * 32, 128), (3, 37 * 29, 64),
                                   (1, 16, 136)])
def test_gram_three_products_meet_1e6_of_float64(shape):
    """At 2 x 32² x 128 (several slices of whole boxes), pixel counts off
    the box, and one box past P; the relu keeps y non-negative as at the
    style taps. One TF32 product of operands rounded to TF32 misses by an
    order of magnitude more."""
    rng = np.random.RandomState(9)
    y = torch.relu(torch.tensor(rng.randn(*shape).astype(np.float32)))
    yd = y.double()
    ref = yd.transpose(1, 2) @ yd
    assert _rel_fro(emulate_gram_tf32x3(y), ref) <= 1e-6
    yr = _round_tf32(y)
    assert _rel_fro(yr.transpose(1, 2) @ yr, ref) > 1e-5


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 32), 64),
                                        ((1, 8, 12, 16), 136)])
def test_gram_emulation_matches_pallas_interpret(shape, cout):
    """K3's sums on the JAX package's conv output against its Gram
    (``conv3x3_bias_gram`` in interpret mode): within 1e-5, relative
    Frobenius and of the largest entry."""
    x, w, b = _operands(10, shape, cout)
    y_j, g_j = cp.conv3x3_bias_gram(jnp.asarray(x.numpy()),
                                    jnp.asarray(w.numpy()),
                                    jnp.asarray(b.numpy()), True)
    y = torch.tensor(np.asarray(y_j)).reshape(shape[0], -1, cout)
    g_j = torch.tensor(np.asarray(g_j))
    g_e = emulate_gram_tf32x3(y)
    assert _rel_fro(g_e, g_j) <= 1e-5
    assert float((g_e - g_j).abs().max()) <= 1e-5 * float(g_j.abs().max())
