"""st3d_torch stage 1 v3 (kernels E and F through their plain versions on the
CPU; C and D as K10c/K10d) against the JAX package's v3 Pallas kernels
(st3d/kernels/stage1v3_pallas.py) in interpret mode, at the shapes of
tests/test_stage1v3_pallas.py; then ``get_features`` with
``ST3D_STAGE1=v3`` against the JAX package's v3 route (its TPU gates
patched open, the v3 kernels in interpret mode), and the dispatch gates.

Tolerances, float32: values rtol 1e-5 (the same sums in another order);
input gradients rtol 1e-4 (the recompute, the Gram cotangent's matmul and
the transpose conv, each reassociated). Each atol is the rtol times the
reference's max (``_close``), since values near 0 carry the large ones'
rounding. bfloat16 is held loosely: both sides round z, y and d once from
float32 sums taken in different orders, so a value may land one bf16 step
(2⁻⁸ relative) apart, and the Gram then sums those steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import st3d.kernels.stage1v3_pallas as s3
import st3d.models.vgg as jvgg
from st3d.kernels.stage1_pallas import pack_input5, unpack_output5

from st3d_torch.convert import vgg19_from_numpy
from st3d_torch.kernels import conv as kconv
from st3d_torch.kernels import stage1 as ks1
from st3d_torch.kernels import stage1v3 as ks3
from st3d_torch.models import vgg as tvgg

STAGE1_SHAPES = [(2, 16, 24), (1, 32, 16), (1, 48, 48)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU. With torch's default of one thread per
    core they oversubscribe it, and at these sizes the thread pool's waits
    then cost more than the work."""
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


@pytest.mark.parametrize("shape", STAGE1_SHAPES)
def test_conv1_1_relu_gram_matches_pallas(shape):
    """E and F's plain versions against conv1_1_packed_v3 (interpret mode):
    z after unpacking, g64, and dx under both cotangents."""
    bsz, h, wd = shape
    rng = np.random.RandomState(3)
    x = rng.rand(bsz, h, wd, 3).astype(np.float32)
    w, b = _mats(rng, 3, 64, 0.2)
    ct_z = rng.randn(bsz, h, wd, 64).astype(np.float32)
    ct_g = (rng.randn(bsz, 64, 64) * 1e-3).astype(np.float32)
    wj, bj = jnp.asarray(w), jnp.asarray(b)

    (z5, g_j), vjp = jax.vjp(lambda xx: s3.conv1_1_packed_v3(xx, wj, bj, True),
                             jnp.asarray(x))
    (dx_j,) = vjp((pack_input5(jnp.asarray(ct_z)), jnp.asarray(ct_g)))

    xt = _t(x, grad=True)
    z_t, g_t = ks3.conv1_1_relu_gram(xt, _t(w), _t(b))
    _close(z_t.detach(), unpack_output5(z5), 1e-5)
    _close(g_t.detach(), g_j, 1e-5)
    (dx_t,) = torch.autograd.grad((z_t, g_t), xt, (_t(ct_z), _t(ct_g)))
    _close(dx_t, dx_j, 1e-4)
    assert float(dx_t.abs().max()) > 0


def test_conv1_1_gram_is_the_gram_of_the_rounded_pre_relu_tap():
    """In bf16, g64 is the float32 Gram of conv1_1's output before the ReLU
    rounded to bf16, not kernel A's closed form of the statistics."""
    rng = np.random.RandomState(4)
    x = _t(rng.rand(2, 16, 16, 3).astype(np.float32)).bfloat16()
    w, b = (_t(a).bfloat16() for a in _mats(rng, 3, 64, 0.2))
    z, g64 = ks3.conv1_1_gram(x, w, b)
    pre = kconv.conv3x3_nhwc_plain(x, w, b).float().reshape(2, -1, 64)
    _close(g64.numpy(), (pre.transpose(1, 2) @ pre).numpy(), 1e-5)
    assert z.dtype == torch.bfloat16 and g64.dtype == torch.float32
    _, ptp, s27 = ks1.conv1_1_stats(x, w, b)
    closed = tvgg.gram1_closed_form(ptp, s27, w, b, 256)
    assert not torch.allclose(closed, g64, rtol=1e-5, atol=0)


def test_stage1_v3_bf16_matches_pallas_loosely():
    """bf16 through both v3 halves: dtypes carried, values within a few
    bf16 steps of the JAX kernels (see the module docstring)."""
    rng = np.random.RandomState(11)
    x = rng.rand(1, 16, 16, 3).astype(np.float32)
    w1, b1 = _mats(rng, 3, 64, 0.2)
    w2, b2 = _mats(rng, 64, 64, 0.05)
    bf = jnp.bfloat16
    args_j = [jnp.asarray(a).astype(bf) for a in (x, w1, b1, w2, b2)]
    z5, g_j = s3.conv1_1_packed_v3(*args_j[:3], True)
    p_j, _ = s3.conv1_2_packed_pool_v3(z5, *args_j[3:], True)
    args_t = [torch.tensor(a).bfloat16() for a in (x, w1, b1, w2, b2)]
    z_t, g_t = ks3.conv1_1_relu_gram(*args_t[:3])
    p_t, _ = ks3.conv1_2_relu_pool_v3(z_t, *args_t[3:])
    assert z_t.dtype == p_t.dtype == torch.bfloat16
    assert g_t.dtype == torch.float32
    z_j = np.asarray(unpack_output5(z5), np.float32)
    for got, want in ((z_t, z_j), (p_t, np.asarray(p_j, np.float32)),
                      (g_t, np.asarray(g_j))):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2e-2 * np.abs(want).max(), rtol=2e-2)


def test_conv1_1_gram_bwd_bf16_rounds_like_pallas():
    """bf16 dx under both cotangents, loosely (d rounds once on each side)."""
    rng = np.random.RandomState(12)
    x = rng.rand(1, 16, 24, 3).astype(np.float32)
    w, b = _mats(rng, 3, 64, 0.2)
    ct_z = rng.randn(1, 16, 24, 64).astype(np.float32)
    ct_g = (rng.randn(1, 64, 64) * 1e-3).astype(np.float32)
    bf = jnp.bfloat16
    xj = jnp.asarray(x).astype(bf)
    _, vjp = jax.vjp(lambda xx: s3.conv1_1_packed_v3(
        xx, jnp.asarray(w).astype(bf), jnp.asarray(b).astype(bf), True), xj)
    (dx_j,) = vjp((pack_input5(jnp.asarray(ct_z).astype(bf)),
                   jnp.asarray(ct_g)))
    xt = torch.tensor(x).bfloat16().requires_grad_(True)
    z_t, g_t = ks3.conv1_1_relu_gram(xt, _t(w).bfloat16(), _t(b).bfloat16())
    (dx_t,) = torch.autograd.grad((z_t, g_t), xt,
                                  (_t(ct_z).bfloat16(), _t(ct_g)))
    assert dx_t.dtype == torch.bfloat16
    want = np.asarray(dx_j, np.float32)
    np.testing.assert_allclose(dx_t.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=2e-2)


@pytest.mark.parametrize("shape", STAGE1_SHAPES[:2])
def test_conv1_2_relu_pool_v3_matches_pallas(shape):
    """C and D (K10c, K10d) against conv1_2_packed_pool_v3: pooled, idx where
    the window's top two are separated, and dz."""
    bsz, h, wd = shape
    rng = np.random.RandomState(17)
    x = rng.rand(bsz, h, wd, 3).astype(np.float32)
    w1, b1 = _mats(rng, 3, 64, 0.2)
    w2, b2 = _mats(rng, 64, 64, 0.05)
    z5, _ = s3._conv1_1_v3_ref(jnp.asarray(x), jnp.asarray(w1),
                               jnp.asarray(b1))
    z = np.asarray(unpack_output5(z5))
    ct = rng.randn(bsz, h // 2, wd // 2, 64).astype(np.float32)

    (p_j, i_j), vjp = jax.vjp(
        lambda zz: s3.conv1_2_packed_pool_v3(zz, jnp.asarray(w2),
                                             jnp.asarray(b2), True), z5)
    (dz5_j,) = vjp((jnp.asarray(ct), jnp.zeros_like(i_j)))

    zt = _t(z, grad=True)
    p_t, i_t = ks3.conv1_2_relu_pool_v3(zt, _t(w2), _t(b2))
    _close(p_t.detach(), p_j, 1e-5)
    pre = kconv.conv3x3_nhwc_plain(_t(z), _t(w2), _t(b2), True).numpy()
    win = pre.reshape(bsz, h // 2, 2, wd // 2, 2, 64).transpose(
        0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, 64, 4)
    top2 = np.sort(win, axis=-1)[..., -2:]
    separated = (top2[..., 1] - top2[..., 0]) > 1e-5 * np.abs(pre).max()
    assert separated.mean() > 0.5
    np.testing.assert_array_equal(i_t.numpy()[separated],
                                  np.asarray(i_j)[separated])
    (dz_t,) = torch.autograd.grad(p_t, zt, _t(ct))
    _close(dz_t, unpack_output5(dz5_j), 1e-4)
    assert float(dz_t.abs().max()) > 0


def test_cpu_tensors_take_the_plain_versions():
    before = dict(ks3.LAUNCHES)
    rng = np.random.RandomState(0)
    x = _t(rng.rand(1, 8, 8, 3).astype(np.float32))
    w, b = (_t(a) for a in _mats(rng, 3, 64, 0.2))
    for got, want in zip(ks3.conv1_1_gram(x, w, b),
                         ks3.conv1_1_gram_plain(x, w, b)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    dz, sym = torch.ones(1, 8, 8, 64), torch.eye(64)[None]
    torch.testing.assert_close(ks3.conv1_1_gram_bwd(x, dz, w, b, sym),
                               ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym),
                               atol=0, rtol=0)
    assert ks3.LAUNCHES == before
    assert ks3.conv1_2_relu_pool_v3 is ks1.conv1_2_relu_pool


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError):                      # Cout != 64
        ks3.conv1_1_gram(x, torch.zeros(3, 3, 3, 32), torch.zeros(32))
    with pytest.raises(ValueError):                      # 4 input channels
        ks3.conv1_1_gram(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 3, 64),
                         torch.zeros(64))
    w, b = torch.zeros(3, 3, 3, 64), torch.zeros(64)
    with pytest.raises(ValueError):                      # dz's shape
        ks3.conv1_1_gram_bwd(x, torch.zeros(1, 8, 4, 64), w, b,
                             torch.zeros(1, 64, 64))
    with pytest.raises(ValueError):                      # sym's shape
        ks3.conv1_1_gram_bwd(x, torch.zeros(1, 8, 8, 64), w, b,
                             torch.zeros(2, 64, 64))


# ---------------------------------------------------------------------------
# get_features on the JAX package's v3 route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jvgg.init_random_vgg19(0)
    tm = vgg19_from_numpy([np.asarray(k) for k in jm.kernels],
                          [np.asarray(b) for b in jm.biases])
    return jm, tm


@pytest.fixture
def v3_config_jax(monkeypatch):
    """The JAX package on its v3 route as on a TPU: stage 1 routed to Pallas
    (conv1_1, conv1_2), the v3 kernels in interpret mode, the deeper layers
    XLA convs (the same function as K2/K3; interpreting them is slow)."""
    real = (s3.conv1_1_packed_v3, s3.conv1_2_packed_pool_v3)
    monkeypatch.delenv("ST3D_NO_STAGE1_V2", raising=False)
    monkeypatch.delenv("ST3D_NO_PACKED1", raising=False)
    monkeypatch.delenv("ST3D_FUSED_POOL", raising=False)
    monkeypatch.setenv("ST3D_STAGE1", "v3")
    monkeypatch.setattr(jvgg, "_pallas_conv_ok", lambda _x: True)
    monkeypatch.setattr(jvgg, "_pallas_convs", lambda: frozenset({0, 1}))
    monkeypatch.setattr(s3, "conv1_1_packed_v3",
                        lambda xx, w, b, i=False: real[0](xx, w, b, True))
    monkeypatch.setattr(s3, "conv1_2_packed_pool_v3",
                        lambda zz, w, b, i=False: real[1](zz, w, b, True))
    return monkeypatch


def test_get_features_v3_matches_jax(models, v3_config_jax):
    """Taps, conv1_1:gram and the input gradient of a loss on conv1_1:gram
    and conv4_2, 32² f32, port v3 against JAX v3. JAX returns the deeper
    style taps as taps here (their fused-Gram kernels are not routed), the
    port as Grams: those are compared as Grams."""
    jm, tm = models
    img = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    tgt = np.random.RandomState(7).rand(2, 64, 64).astype(np.float32)

    def loss_j(xx):
        f = jvgg.get_features(xx, jm, layout="NHWC", input_layout="NHWC",
                              gram1=True)
        return (jnp.mean((f["conv1_1:gram"] - tgt) ** 2)
                + jnp.mean(f["conv4_2"].astype(jnp.float32) ** 2)), f

    (l_j, f_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(img))
    xt = _t(img, grad=True)
    f_t = tvgg.get_features(xt, tm, layout="NHWC", input_layout="NHWC",
                            gram1=True)
    l_t = (torch.mean((f_t["conv1_1:gram"] - _t(tgt)) ** 2)
           + torch.mean(f_t["conv4_2"].float() ** 2))
    l_t.backward()
    assert len(f_t) == len(f_j) == 6
    for k, want in f_j.items():
        if k not in f_t:
            want = jnp.einsum("bhwc,bhwd->bcd", want, want)
            k = k + ":gram"
        _close(f_t[k].detach().numpy(), want, 1e-4)
    assert float(l_t.detach()) == pytest.approx(float(l_j), rel=1e-5)
    _close(xt.grad.numpy(), g_j, 1e-4)


@pytest.mark.parametrize("env,size,gram1,want", [
    ({"ST3D_STAGE1": "v3"}, 16, True, {"v3"}),
    ({"ST3D_STAGE1": "v3"}, 36, True, {"packed"}),  # 36 % 8: no stage 1
    ({"ST3D_STAGE1": "v3"}, 16, False, {"packed"}),
    ({"ST3D_STAGE1": "v3", "ST3D_NO_STAGE1_V2": "1"}, 16, True, {"packed"}),
    ({"ST3D_STAGE1": "v2"}, 16, True, {"v2"}),
])
def test_v3_dispatch_gates(models, monkeypatch, env, size, gram1, want):
    _, tm = models
    for k in ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1",
              "ST3D_FUSED_POOL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = set()

    def spy(label, fn):
        def call(*a):
            seen.add(label)
            return fn(*a)
        return call

    for name, label in (("conv1_1_relu_gram", "v3"),
                        ("conv1_1_relu_stats", "v2"),
                        ("conv3x3_bias_relu_pool_packed", "packed")):
        monkeypatch.setattr(tvgg, name, spy(label, getattr(tvgg, name)))
    feats = tvgg.get_features(torch.rand(1, size, size, 3), tm,
                              layout="NHWC", input_layout="NHWC",
                              gram1=gram1)
    assert seen == want
    assert ("conv1_1:gram" in feats) == gram1


def test_v3_route_below_the_jax_band_gate(monkeypatch):
    """At 8 rows the JAX package's band check sends v3 back to v2; the port,
    which has no bands, keeps v3 (models/vgg.py's docstring)."""
    monkeypatch.delenv("ST3D_NO_STAGE1_V2", raising=False)
    monkeypatch.setenv("ST3D_STAGE1", "v3")
    assert tvgg._stage1_route(torch.zeros(1, 8, 8, 3), True,
                              {"conv1_1"}) == "v3"
    assert not s3.stage1_v3_supported(jnp.zeros((1, 8, 8, 3)))
