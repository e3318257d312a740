"""st3d_torch conv and Gram functions (kernels K2/K3 through their plain
versions on the CPU) against the JAX package's Pallas kernels in interpret
mode: values and input gradients, float32, at (2,16,16,8->16) and
(1,8,8,32->64), and at the edges of the tensor-core K2's tile plan
(``kernels.conv.conv_tile``): W = 4 (a 4 x 32 box), a 10 x 12 image whose H
is not a multiple of the box height (16 x 8), and Cin = 64 on an image
lower than its box (the dx side then has Cout = 64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st3d.kernels import conv_pallas as cp
from st3d.ops.losses import gram_matrix_nhwc as jax_gram_nhwc

from st3d_torch.kernels import conv as kconv
from st3d_torch.ops.losses import gram_matrix_nhwc

SHAPES = [((2, 16, 16, 8), 16), ((1, 8, 8, 32), 64), ((1, 4, 4, 16), 32),
          ((2, 10, 12, 8), 16), ((1, 6, 8, 64), 24)]


def _inputs(shape, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[3], cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("shape,cout", SHAPES)
@pytest.mark.parametrize("op", ["bias", "relu"])
def test_conv_matches_pallas_interpret(shape, cout, op):
    x, w, b = _inputs(shape, cout)
    jfn = {"bias": cp.conv3x3_bias, "relu": cp.conv3x3_bias_relu}[op]
    tfn = {"bias": kconv.conv3x3_bias, "relu": kconv.conv3x3_bias_relu}[op]
    y_j, vjp = jax.vjp(lambda xx: jfn(xx, jnp.asarray(w), jnp.asarray(b),
                                      True), jnp.asarray(x))
    xt = _t(x, grad=True)
    y_t = tfn(xt, _t(w), _t(b))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=1e-5)
    ct = np.random.RandomState(1).randn(*y_t.shape).astype(np.float32)
    (dx_j,) = vjp(jnp.asarray(ct))
    (dx_t,) = torch.autograd.grad(y_t, xt, _t(ct))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_conv_gram_matches_pallas_interpret(shape, cout):
    x, w, b = _inputs(shape, cout, seed=2)
    (y_j, g_j), vjp = jax.vjp(
        lambda xx: cp.conv3x3_bias_gram(xx, jnp.asarray(w), jnp.asarray(b),
                                        True), jnp.asarray(x))
    xt = _t(x, grad=True)
    y_t, g_t = kconv.conv3x3_bias_gram(xt, _t(w), _t(b))
    assert g_t.dtype == torch.float32 and g_t.shape == (shape[0], cout, cout)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=1e-5)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.detach().numpy(), g_j, rtol=1e-5,
                               atol=1e-5 * np.abs(g_j).max())
    rng = np.random.RandomState(3)
    ct_y = rng.randn(*y_t.shape).astype(np.float32)
    ct_g = (rng.randn(*g_t.shape) * 1e-2).astype(np.float32)
    (dx_j,) = vjp((jnp.asarray(ct_y), jnp.asarray(ct_g)))
    (dx_t,) = torch.autograd.grad((y_t, g_t), xt, (_t(ct_y), _t(ct_g)))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 8, 64)])
def test_gram_matches_jax(shape):
    y = np.random.RandomState(4).randn(*shape).astype(np.float32)
    yt = _t(y, grad=True)
    g_t = gram_matrix_nhwc(yt)
    g_j, vjp = jax.vjp(jax_gram_nhwc, jnp.asarray(y))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.detach().numpy(), g_j, rtol=1e-5,
                               atol=1e-5 * np.abs(g_j).max())
    ct = np.random.RandomState(5).randn(*g_j.shape).astype(np.float32)
    (dy_j,) = vjp(jnp.asarray(ct))
    (dy_t,) = torch.autograd.grad(g_t, yt, _t(ct))
    np.testing.assert_allclose(dy_t.numpy(), np.asarray(dy_j), atol=1e-4,
                               rtol=1e-4)


def test_plain_conv_bf16_rounds_once():
    """The plain K2 computes in float32 from bf16 inputs and rounds once."""
    x, w, b = _inputs((1, 8, 8, 16), 32, seed=6)
    xb, wb, bb = (torch.tensor(a).bfloat16() for a in (x, w, b))
    y = kconv.conv3x3_nhwc_plain(xb, wb, bb)
    ref = kconv.conv3x3_nhwc_plain(xb.float(), wb.float(), bb.float())
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, ref.bfloat16(), atol=0, rtol=0)


def test_gram_split_covers_all_pixels():
    for bsz, pixels, c in [(4, 512 * 512, 27), (4, 256 * 256, 128),
                           (4, 32 * 32, 512), (1, 7, 3)]:
        slices, slice_len = kconv.gram_split(bsz, pixels, c)
        assert slice_len % 16 == 0 and bsz * slices <= 65535
        assert (slices - 1) * slice_len < pixels <= slices * slice_len
