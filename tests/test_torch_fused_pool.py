"""st3d_torch's fused conv + ReLU + 2x2 max-pool for the pre-pool convs (K8,
``ST3D_FUSED_POOL``; kernels C and D through their plain versions on the
CPU) against the JAX package's ``conv3x3_bias_relu_pool`` in interpret
mode, at the shapes of tests/test_conv_pallas.py plus one 128-channel case;
then ``get_features`` on the route against the JAX package's, and its
dispatch.

Tolerances, float32: values rtol 1e-5 (the same sums in another order),
input gradients rtol 1e-4 (the routed transpose conv reassociated); each
atol is the rtol times the reference's max. idx is compared where the
window's top two pre-pool values are more than 1e-5·max apart (elsewhere
either side may break the near-tie; both take the first maximum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import st3d.kernels.conv_pallas as cp
import st3d.models.vgg as jvgg

from st3d_torch.convert import vgg19_from_numpy
from st3d_torch.kernels import conv as kconv
from st3d_torch.models import vgg as tvgg

ENV = ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1",
       "ST3D_FUSED_POOL")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; one torch thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("shape,cout", [
    ((2, 32, 16, 8), 16),
    ((1, 48, 24, 8), 16),
    ((1, 16, 16, 64), 64),
    ((1, 16, 8, 128), 128),       # conv2_2's width
])
def test_conv3x3_bias_relu_pool_matches_pallas(shape, cout):
    rng = np.random.RandomState(23)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[3], cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    ct = rng.randn(shape[0], shape[1] // 2, shape[2] // 2,
                   cout).astype(np.float32)
    (p_j, i_j), vjp = jax.vjp(
        lambda xx: cp.conv3x3_bias_relu_pool(xx, jnp.asarray(w),
                                             jnp.asarray(b), True),
        jnp.asarray(x))
    (dx_j,) = vjp((jnp.asarray(ct), jnp.zeros_like(i_j)))

    xt = _t(x, grad=True)
    p_t, i_t = kconv.conv3x3_bias_relu_pool(xt, _t(w), _t(b))
    assert i_t.dtype == torch.uint8 and not i_t.requires_grad
    _close(p_t.detach(), p_j, 1e-5)
    pre = kconv.conv3x3_nhwc_plain(_t(x), _t(w), _t(b), True).numpy()
    bsz, h, wd, c = pre.shape
    win = pre.reshape(bsz, h // 2, 2, wd // 2, 2, c).transpose(
        0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, c, 4)
    top2 = np.sort(win, axis=-1)[..., -2:]
    separated = (top2[..., 1] - top2[..., 0]) > 1e-5 * np.abs(pre).max()
    assert separated.mean() > 0.5
    np.testing.assert_array_equal(i_t.numpy()[separated],
                                  np.asarray(i_j)[separated])
    (dx_t,) = torch.autograd.grad(p_t, xt, _t(ct))
    _close(dx_t, dx_j, 1e-4)
    assert float(dx_t.abs().max()) > 0


# ---------------------------------------------------------------------------
# get_features on the JAX package's fused-pool route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jvgg.init_random_vgg19(0)
    tm = vgg19_from_numpy([np.asarray(k) for k in jm.kernels],
                          [np.asarray(b) for b in jm.biases])
    return jm, tm


@pytest.fixture
def fused_config_jax(monkeypatch):
    """The JAX package with ``ST3D_FUSED_POOL=1`` as on a TPU, only the
    pre-pool convs routed to Pallas (conv1_2, conv2_2, conv3_4, conv4_4),
    their kernels in interpret mode; the other layers XLA convs (the same
    function as K2/K3; interpreting them is slow)."""
    real = (cp.conv3x3_bias_relu_pool, cp.conv3x3_bias_relu_pool_packed)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ST3D_FUSED_POOL", "1")
    monkeypatch.setattr(jvgg, "_pallas_conv_ok", lambda _x: True)
    monkeypatch.setattr(jvgg, "_pallas_convs",
                        lambda: frozenset({1, 3, 7, 11}))
    monkeypatch.setattr(cp, "conv3x3_bias_relu_pool",
                        lambda xx, w, b, i=False: real[0](xx, w, b, True))
    monkeypatch.setattr(cp, "conv3x3_bias_relu_pool_packed",
                        lambda xx, w, b, i=False: real[1](xx, w, b, True))
    return monkeypatch


@pytest.mark.parametrize("no_packed1", [False, True])
def test_get_features_fused_pool_matches_jax(models, fused_config_jax,
                                             no_packed1):
    """Every tap and the input gradient of a loss on all of them, 32² f32;
    with ``ST3D_NO_PACKED1`` conv1_2 takes K8 as well, on both sides."""
    if no_packed1:
        fused_config_jax.setenv("ST3D_NO_PACKED1", "1")
    jm, tm = models
    img = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    wts = {k: float(i + 1) for i, k in enumerate(sorted(tvgg.TAP_CONV_INDEX))}

    def loss_j(xx):
        f = jvgg.get_features(xx, jm, layout="NHWC", input_layout="NHWC")
        return sum(wts[k] * jnp.mean(v.astype(jnp.float32) ** 2)
                   for k, v in f.items()), f

    (l_j, f_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(img))
    xt = _t(img, grad=True)
    f_t = tvgg.get_features(xt, tm, layout="NHWC", input_layout="NHWC")
    l_t = sum(wts[k] * torch.mean(v.float() ** 2) for k, v in f_t.items())
    l_t.backward()
    assert set(f_t) == set(f_j)
    for k in f_j:
        _close(f_t[k].detach().numpy(), f_j[k], 1e-4)
    assert float(l_t.detach()) == pytest.approx(float(l_j), rel=1e-5)
    _close(xt.grad.numpy(), g_j, 1e-4)


@pytest.fixture
def spies(models, monkeypatch):
    """Count K8 calls and ``max_pool2d`` calls in the port's get_features."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    calls = {"k8": 0, "pool": 0}

    def spy(label, fn):
        def call(*a):
            out = fn(*a)
            calls[label] += out is not False
            return out
        return call

    # A conv takes K8 where the fused-pool gate opens (the packed gate,
    # asked first, having stayed shut).
    monkeypatch.setattr(tvgg, "_fused_pool_route",
                        spy("k8", tvgg._fused_pool_route))
    monkeypatch.setattr(tvgg, "_max_pool_2x2",
                        spy("pool", tvgg._max_pool_2x2))
    return calls, monkeypatch


@pytest.mark.parametrize("env,size,gram1,want", [
    ({"ST3D_FUSED_POOL": "1"}, 32, True, {"k8": 3, "pool": 0}),
    ({"ST3D_FUSED_POOL": "1"}, 32, False, {"k8": 3, "pool": 0}),
    ({"ST3D_FUSED_POOL": "1", "ST3D_NO_PACKED1": "1",
      "ST3D_NO_STAGE1_V2": "1"}, 32, True, {"k8": 4, "pool": 0}),
    ({"ST3D_FUSED_POOL": "1"}, 36, True, {"k8": 2, "pool": 1}),   # 9² conv3_4
    ({}, 32, True, {"k8": 0, "pool": 3}),
])
def test_fused_pool_dispatch(models, spies, env, size, gram1, want):
    """Which pre-pool convs take K8 and how many pools are left to
    ``max_pool2d``: none on the route at 32², whatever stage 1 does."""
    calls, monkeypatch = spies
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, tm = models
    tvgg.get_features(torch.rand(1, size, size, 3), tm, layout="NHWC",
                      input_layout="NHWC", gram1=gram1)
    assert calls == want
