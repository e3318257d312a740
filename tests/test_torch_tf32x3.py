"""The arithmetic of K2's float32 route on the tensor cores
(``csrc/conv3x3_tf32x3.cu``), on the CPU: the exact split of
``kernels.conv.split_tf32`` and a plain-torch emulation of the kernel's
three TF32 products. A TF32 value is a float32 with its low 13 mantissa
bits clear; the product of two is exact in float32, so a float32 matmul of
TF32 operands gives the tensor core's products with float32 sums.

The emulation clears the low bits of the lo parts too, as a tensor core
that truncates would: the worst case the kernel allows. Three products
land within 1e-6 of the largest output of a float64 conv at 16² x 64 ->
64; one product of operands rounded to TF32 (the tensor core's plain TF32
mode, at its most favourable) misses 1e-6 by two orders of magnitude. The
emulation also matches the JAX package's K2 (Pallas, interpret mode),
forward and input gradient, within the float32 tolerance of 1e-5 that
``tests/test_torch_conv.py`` holds the plain version to."""

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
