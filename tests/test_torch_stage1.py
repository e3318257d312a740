"""st3d_torch stage 1 (kernels A-D through their plain versions on the CPU)
against the JAX package's stage-1 and packed-pool Pallas kernels in
interpret mode, at the shapes of tests/test_stage1_pallas.py and
tests/test_conv_pallas.py; then ``get_features`` on the JAX package's
default route (its TPU gates patched open, every Pallas kernel in interpret
mode) against the port's.

Tolerances, float32: values rtol 1e-5 (the same sums in another order);
input gradients rtol 1e-4 (two more reassociated reductions: the transpose
conv and the fold). Each atol is the rtol times the reference's max, since
values near 0 carry the large ones' rounding. bfloat16 is held loosely:
both sides round z and pooled once from float32 sums taken in different
orders, so a value may land one bf16 step (2⁻⁸ relative) apart, and
conv1_2 then sees those steps in its input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import st3d.kernels.conv_pallas as cp
import st3d.kernels.stage1_pallas as s1
import st3d.models.vgg as jvgg

from st3d_torch.convert import vgg19_from_numpy
from st3d_torch.kernels import conv as kconv
from st3d_torch.kernels import stage1 as ks1
from st3d_torch.models import vgg as tvgg

STAGE1_SHAPES = [(2, 16, 24), (1, 32, 16), (1, 48, 48)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU. With torch's default of one thread per
    core they oversubscribe it, and at these sizes the thread pool's waits
    then cost more than the work (a 64² run took 150 times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mats(rng, cin, cout, scale):
    w = (rng.randn(3, 3, cin, cout) * scale).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return w, b


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


def _idx_agree_where_separated(idx_got, idx_want, pre_pool, tol):
    """idx equal wherever the top two of the window differ by more than
    ``tol`` (elsewhere both sides may break the near-tie either way)."""
    bsz, h, wd, c = pre_pool.shape
    win = pre_pool.reshape(bsz, h // 2, 2, wd // 2, 2, c).transpose(
        0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, c, 4)
    top2 = np.sort(win, axis=-1)[..., -2:]
    separated = (top2[..., 1] - top2[..., 0]) > tol
    assert separated.mean() > 0.5, separated.mean()
    np.testing.assert_array_equal(np.asarray(idx_got)[separated],
                                  np.asarray(idx_want)[separated])


@pytest.mark.parametrize("shape", STAGE1_SHAPES)
def test_conv1_1_relu_stats_matches_pallas(shape):
    bsz, h, wd = shape
    rng = np.random.RandomState(3)
    x = rng.rand(bsz, h, wd, 3).astype(np.float32)
    w, b = _mats(rng, 3, 64, 0.2)
    ct_z = rng.randn(bsz, h, wd, 64).astype(np.float32)
    ct_g = (rng.randn(bsz, 64, 64) * 1e-3).astype(np.float32)
    wj, bj = jnp.asarray(w), jnp.asarray(b)

    def jfn(xx):
        z5, g48, s48 = s1.conv1_1_packed(xx, wj, bj, True)
        return s1.unpack_output5(z5), s1.fold_gram48(g48, s48, wj, bj, h * wd)

    (z_j, g_j), vjp = jax.vjp(jfn, jnp.asarray(x))
    (dx_j,) = vjp((jnp.asarray(ct_z), jnp.asarray(ct_g)))

    xt = _t(x, grad=True)
    z_t, ptp, s27 = ks1.conv1_1_relu_stats(xt, _t(w), _t(b))
    g_t = tvgg.gram1_closed_form(ptp, s27, _t(w), _t(b), h * wd)
    _close(z_t.detach(), z_j, 1e-5)
    _close(g_t.detach(), g_j, 1e-5)
    (dx_t,) = torch.autograd.grad((z_t, g_t), xt, (_t(ct_z), _t(ct_g)))
    _close(dx_t, dx_j, 1e-4)
    assert float(dx_t.abs().max()) > 0


def test_conv1_1_gram_is_the_pre_relu_gram():
    """gram1_closed_form of the statistics is the Gram of conv1_1's output
    before the ReLU, not of z."""
    rng = np.random.RandomState(4)
    x = _t(rng.rand(2, 16, 16, 3).astype(np.float32))
    w, b = (_t(a) for a in _mats(rng, 3, 64, 0.2))
    z, ptp, s27 = ks1.conv1_1_relu_stats(x, w, b)
    pre = kconv.conv3x3_nhwc_plain(x, w, b).reshape(2, -1, 64)
    want = (pre.transpose(1, 2) @ pre).numpy()
    _close(tvgg.gram1_closed_form(ptp, s27, w, b, 256).numpy(), want, 1e-5)
    assert (z.numpy() >= 0).all() and (pre.numpy() < 0).any()


@pytest.mark.parametrize("shape", STAGE1_SHAPES[:2])
def test_conv1_2_relu_pool_matches_pallas(shape):
    bsz, h, wd = shape
    rng = np.random.RandomState(17)
    x = rng.rand(bsz, h, wd, 3).astype(np.float32)
    w1, b1 = _mats(rng, 3, 64, 0.2)
    w2, b2 = _mats(rng, 64, 64, 0.05)
    z5, _, _ = s1._conv1_1_packed_ref(jnp.asarray(x), jnp.asarray(w1),
                                      jnp.asarray(b1))
    z = np.asarray(s1.unpack_output5(z5))
    ct = rng.randn(bsz, h // 2, wd // 2, 64).astype(np.float32)

    (p_j, i_j), vjp = jax.vjp(
        lambda zz: s1.conv1_2_packed_pool(zz, jnp.asarray(w2),
                                          jnp.asarray(b2), True), z5)
    (dz5_j,) = vjp((jnp.asarray(ct), jnp.zeros_like(i_j)))
    dz_j = s1.unpack_output5(dz5_j)

    zt = _t(z, grad=True)
    p_t, i_t = ks1.conv1_2_relu_pool(zt, _t(w2), _t(b2))
    assert i_t.dtype == torch.uint8 and not i_t.requires_grad
    _close(p_t.detach(), p_j, 1e-5)
    pre = kconv.conv3x3_nhwc_plain(_t(z), _t(w2), _t(b2), True).numpy()
    _idx_agree_where_separated(i_t, i_j, pre, 1e-5 * np.abs(pre).max())
    (dz_t,) = torch.autograd.grad(p_t, zt, _t(ct))
    _close(dz_t, dz_j, 1e-4)
    assert float(dz_t.abs().max()) > 0


@pytest.mark.parametrize("shape,cout", [((2, 32, 16, 8), 16),
                                        ((1, 48, 24, 8), 16),
                                        ((1, 16, 16, 64), 64)])
def test_conv3x3_bias_relu_pool_packed_matches_pallas(shape, cout):
    rng = np.random.RandomState(29)
    x = rng.randn(*shape).astype(np.float32)
    w, b = _mats(rng, shape[3], cout, 0.1)
    wgt = rng.randn(shape[0], shape[1] // 2, shape[2] // 2,
                    cout).astype(np.float32)
    (p_j, i_j), vjp = jax.vjp(
        lambda xx: cp.conv3x3_bias_relu_pool_packed(
            xx, jnp.asarray(w), jnp.asarray(b), True), jnp.asarray(x))
    (dx_j,) = vjp((jnp.asarray(wgt), jnp.zeros_like(i_j)))

    xt = _t(x, grad=True)
    p_t, i_t = kconv.conv3x3_bias_relu_pool_packed(xt, _t(w), _t(b))
    _close(p_t.detach(), p_j, 1e-5)
    pre = kconv.conv3x3_nhwc_plain(_t(x), _t(w), _t(b), True).numpy()
    _idx_agree_where_separated(i_t, i_j, pre, 1e-5 * np.abs(pre).max())
    (dx_t,) = torch.autograd.grad(p_t, xt, _t(wgt))
    _close(dx_t, dx_j, 1e-4)


def test_stage1_bf16_matches_pallas_loosely():
    """bf16 through both conv1_1 and conv1_2: dtypes carried, values within
    a few bf16 steps of the JAX kernels (see the module docstring)."""
    rng = np.random.RandomState(11)
    x = rng.rand(1, 16, 16, 3).astype(np.float32)
    w1, b1 = _mats(rng, 3, 64, 0.2)
    w2, b2 = _mats(rng, 64, 64, 0.05)
    bf = jnp.bfloat16
    args_j = [jnp.asarray(a).astype(bf) for a in (x, w1, b1, w2, b2)]
    z5, _, _ = s1.conv1_1_packed(*args_j[:3], True)
    p_j, _ = s1.conv1_2_packed_pool(z5, *args_j[3:], True)
    args_t = [torch.tensor(a).bfloat16() for a in (x, w1, b1, w2, b2)]
    z_t, ptp, s27 = ks1.conv1_1_relu_stats(*args_t[:3])
    p_t, _ = ks1.conv1_2_relu_pool(z_t, *args_t[3:])
    assert z_t.dtype == p_t.dtype == torch.bfloat16
    assert ptp.dtype == s27.dtype == torch.float32
    z_j = np.asarray(s1.unpack_output5(z5), np.float32)
    for got, want in ((z_t, z_j), (p_t, np.asarray(p_j, np.float32))):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2e-2 * np.abs(want).max(), rtol=2e-2)


def test_pool_first_max_wins_ties():
    """Crafted ties (a delta kernel copies quantised inputs exactly): idx is
    the first maximum in window scan order, as numpy's argmax."""
    c = 8
    w = torch.zeros(3, 3, c, c)
    w[1, 1] = torch.eye(c)
    x = torch.tensor(np.round(np.random.RandomState(31).rand(1, 16, 16, c)
                              * 3.0) / 2.0, dtype=torch.float32)
    p, idx = kconv.conv3x3_relu_pool(x, w, torch.zeros(c))
    wins = x.numpy().reshape(1, 8, 2, 8, 2, c).transpose(0, 1, 3, 2, 4, 5)
    wins = wins.reshape(1, 8, 8, 4, c)
    np.testing.assert_array_equal(p.numpy(), wins.max(axis=3))
    np.testing.assert_array_equal(idx.numpy(), wins.argmax(axis=3))
    assert (idx.numpy() > 0).any()


def test_route_masks_by_pooled_and_places_by_idx():
    """The routed cotangent: the value at the window position idx names,
    zero where pooled <= 0 and at the other three positions."""
    ct = torch.tensor([[[[2.0], [3.0]]]])             # (1, 1, 2, 1)
    pooled = torch.tensor([[[[1.0], [0.0]]]])
    idx = torch.tensor([[[[2], [1]]]], dtype=torch.uint8)
    r = kconv.route_pool_cotangent(ct, pooled, idx)[0, :, :, 0]
    np.testing.assert_array_equal(r.numpy(), [[0, 0, 0, 0], [2, 0, 0, 0]])


def test_cpu_tensors_take_the_plain_versions():
    before = {**kconv.LAUNCHES, **ks1.LAUNCHES}
    rng = np.random.RandomState(0)
    x = _t(rng.rand(1, 8, 8, 3).astype(np.float32))
    w, b = (_t(a) for a in _mats(rng, 3, 64, 0.2))
    for got, want in zip(ks1.conv1_1_stats(x, w, b),
                         ks1.conv1_1_stats_plain(x, w, b)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    z = ks1.conv1_1_stats(x, w, b)[0]
    w2, b2 = (_t(a) for a in _mats(rng, 64, 16, 0.1))
    p, idx = kconv.conv3x3_relu_pool(z, w2, b2)
    ct = torch.ones_like(p)
    torch.testing.assert_close(
        kconv.pool_route_conv3x3_bwd(ct, p, idx, w2),
        kconv.pool_route_conv3x3_bwd_plain(ct, p, idx, w2), atol=0, rtol=0)
    sym, ds = torch.zeros(1, 27, 27), torch.ones(1, 27)
    torch.testing.assert_close(ks1.conv1_1_bwd(x, z, z, w, sym, ds),
                               ks1.conv1_1_bwd_plain(x, z, z, w, sym, ds),
                               atol=0, rtol=0)
    assert {**kconv.LAUNCHES, **ks1.LAUNCHES} == before


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 6, 6, 8)
    with pytest.raises(ValueError):          # odd H
        kconv.conv3x3_relu_pool(torch.zeros(1, 5, 6, 8),
                                torch.zeros(3, 3, 8, 8), torch.zeros(8))
    with pytest.raises(ValueError):
        ks1.conv1_1_stats(x, torch.zeros(3, 3, 8, 64), torch.zeros(64))
    p = torch.zeros(1, 3, 3, 8)
    with pytest.raises(TypeError):
        kconv.pool_route_conv3x3_bwd(p, p, p, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError):
        ks1.conv1_1_bwd(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 64),
                        torch.zeros(1, 4, 4, 64), torch.zeros(3, 3, 3, 64),
                        torch.zeros(1, 27, 26), torch.zeros(1, 27))


# ---------------------------------------------------------------------------
# get_features on the JAX package's default route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jvgg.init_random_vgg19(0)
    tm = vgg19_from_numpy([np.asarray(k) for k in jm.kernels],
                          [np.asarray(b) for b in jm.biases])
    return jm, tm


@pytest.fixture
def default_config_jax(monkeypatch):
    """The JAX package dispatching as on a TPU by default, its Pallas
    kernels in interpret mode; the stage-1 and packed-pool switches are the
    environment's, which the port reads too."""
    real = (cp.conv3x3_bias, cp.conv3x3_bias_relu, cp.conv3x3_bias_gram,
            cp.conv3x3_bias_relu_pool_packed, s1.conv1_1_packed,
            s1.conv1_2_packed_pool)
    monkeypatch.delenv("ST3D_NO_STAGE1_V2", raising=False)
    monkeypatch.delenv("ST3D_NO_PACKED1", raising=False)
    monkeypatch.delenv("ST3D_STAGE1", raising=False)
    monkeypatch.setattr(jvgg, "_pallas_conv_ok", lambda _x: True)
    for mod, name, fn in ((cp, "conv3x3_bias", real[0]),
                          (cp, "conv3x3_bias_relu", real[1]),
                          (cp, "conv3x3_bias_gram", real[2]),
                          (cp, "conv3x3_bias_relu_pool_packed", real[3]),
                          (s1, "conv1_1_packed", real[4]),
                          (s1, "conv1_2_packed_pool", real[5])):
        monkeypatch.setattr(
            mod, name, lambda xx, w, b, i=False, fn=fn: fn(xx, w, b, True))
    return monkeypatch


def _loss_and_grad_jax(jm, img, content, style):
    import st3d.ops.losses as jl

    nchw = [np.transpose(a, (0, 3, 1, 2)).copy() for a in (content, style)]
    jt = jl.StyleContentTargets.create(*map(jnp.asarray, nchw), jm,
                                       layout="NHWC")

    def loss(x):
        f = jvgg.get_features(x, jm, layout="NHWC", input_layout="NHWC",
                              gram1=True)
        return jl.style_content_loss(f, jt, 1e6, 1.0, layout="NHWC")

    return jax.value_and_grad(loss)(jnp.asarray(img))


def _loss_and_grad_port(tm, img, content, style):
    from st3d_torch.ops import losses as tl

    nchw = [torch.tensor(np.transpose(a, (0, 3, 1, 2)).copy())
            for a in (content, style)]
    tt = tl.StyleContentTargets.create(*nchw, tm, layout="NHWC")
    x = torch.tensor(img, requires_grad=True)
    f = tvgg.get_features(x, tm, layout="NHWC", input_layout="NHWC",
                          gram1=True)
    loss = tl.style_content_loss(f, tt, 1e6, 1.0, layout="NHWC")
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("no_stage1", [False, True])
def test_loss_and_gradient_match_jax_default_route(models, default_config_jax,
                                                   no_stage1):
    """style_content_loss and its input gradient through get_features
    (gram1=True; targets without it), stage 1 on and off (K5 only). Only
    conv1_2's index stays routed to Pallas in JAX, so stage 1 or K5 run in
    interpret mode and the deeper layers as XLA convs with tap Grams (the
    same function; interpreting all twelve kernels' gradients is slow)."""
    default_config_jax.setattr(jvgg, "_pallas_convs", lambda: frozenset({1}))
    if no_stage1:
        default_config_jax.setenv("ST3D_NO_STAGE1_V2", "1")
    jm, tm = models
    rng = np.random.RandomState(7)
    img, content, style = (rng.rand(2, 16, 16, 3).astype(np.float32)
                           for _ in range(3))
    l_j, g_j = _loss_and_grad_jax(jm, img, content, style)
    l_t, g_t = _loss_and_grad_port(tm, img, content, style)
    assert l_t == pytest.approx(float(l_j), rel=1e-5)
    _close(g_t, g_j, 1e-4)


@pytest.mark.parametrize("gram1", [True, False])
def test_get_features_matches_jax_default_route(models, default_config_jax,
                                                gram1):
    jm, tm = models
    img = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    want = jvgg.get_features(jnp.asarray(img), jm, layout="NHWC",
                             input_layout="NHWC", gram1=gram1)
    got = tvgg.get_features(torch.tensor(img), tm, layout="NHWC",
                            input_layout="NHWC", gram1=gram1)
    assert set(got) == set(want)
    for k in want:
        _close(got[k].detach().numpy(), want[k], 1e-4)


@pytest.mark.parametrize("env,size,gram1,want", [
    ({}, 32, True, {"stage1"}),
    ({}, 36, True, {"packed"}),               # 36 % 8: stage 1's shape gate
    ({}, 32, False, {"packed"}),
    ({"ST3D_NO_STAGE1_V2": "1"}, 32, True, {"packed"}),
    ({"ST3D_NO_STAGE1_V2": "1", "ST3D_NO_PACKED1": "1"}, 32, True, set()),
])
def test_dispatch_gates(models, monkeypatch, env, size, gram1, want):
    _, tm = models
    for k in ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = set()

    def spy(label, fn):
        def call(*a):
            seen.add(label)
            return fn(*a)
        return call

    monkeypatch.setattr(tvgg, "conv1_1_relu_stats",
                        spy("stage1", tvgg.conv1_1_relu_stats))
    monkeypatch.setattr(tvgg, "conv3x3_bias_relu_pool_packed",
                        spy("packed", tvgg.conv3x3_bias_relu_pool_packed))
    img = torch.rand(1, size, size, 3)
    feats = tvgg.get_features(img, tm, layout="NHWC", input_layout="NHWC",
                              gram1=gram1)
    assert seen == want
    assert ("conv1_1:gram" in feats) == gram1
