"""st3d_torch VGG-19 against the JAX package, with the JAX package's
random-init weights carried across by ``vgg19_from_numpy``: ``get_features``
at 32², the algebraic conv1_1 Gram, and weight loading."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import st3d.kernels.conv_pallas as cp
import st3d.models.vgg as jvgg

from st3d_torch.convert import vgg19_from_numpy
from st3d_torch.models import vgg as tvgg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU. With torch's default of one thread per
    core they oversubscribe it, and at these sizes the thread pool's waits
    then cost more than the work (a 64² run took 150 times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = jvgg.init_random_vgg19(0)
    tm = vgg19_from_numpy([np.asarray(k) for k in jm.kernels],
                          [np.asarray(b) for b in jm.biases])
    return jm, tm


@pytest.fixture
def slice_config_jax(monkeypatch):
    """The JAX package dispatching as on a TPU in the slice configuration
    (ST3D_NO_STAGE1_V2=1, ST3D_NO_PACKED1=1), its Pallas kernels in
    interpret mode."""
    real = (cp.conv3x3_bias, cp.conv3x3_bias_relu, cp.conv3x3_bias_gram)
    monkeypatch.setenv("ST3D_NO_STAGE1_V2", "1")
    monkeypatch.setenv("ST3D_NO_PACKED1", "1")
    monkeypatch.setattr(jvgg, "_pallas_conv_ok", lambda _x: True)
    monkeypatch.setattr(cp, "conv3x3_bias",
                        lambda x, w, b, i=False: real[0](x, w, b, True))
    monkeypatch.setattr(cp, "conv3x3_bias_relu",
                        lambda x, w, b, i=False: real[1](x, w, b, True))
    monkeypatch.setattr(cp, "conv3x3_bias_gram",
                        lambda x, w, b, i=False: real[2](x, w, b, True))


def _images(seed=5, size=32):
    return np.random.RandomState(seed).rand(2, size, size, 3).astype(
        np.float32)


def _assert_feats_close(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("gram1", [True, False])
def test_get_features_nhwc_matches_slice_config(models, slice_config_jax,
                                                gram1):
    jm, tm = models
    img = _images()
    want = jvgg.get_features(jnp.asarray(img), jm, layout="NHWC",
                             input_layout="NHWC", gram1=gram1)
    got = tvgg.get_features(torch.tensor(img), tm, layout="NHWC",
                            input_layout="NHWC", gram1=gram1)
    if gram1:
        assert {k for k in got if k.endswith(":gram")} == {
            "conv1_1:gram", "conv2_1:gram", "conv3_1:gram", "conv4_1:gram",
            "conv5_1:gram"}
    _assert_feats_close(got, want)


def test_get_features_nchw_matches_xla_path(models):
    """The reference layout (NCHW, float32 taps) against the JAX package's
    CPU path (XLA convolutions)."""
    jm, tm = models
    img = np.transpose(_images(seed=6), (0, 3, 1, 2)).copy()
    want = jvgg.get_features(jnp.asarray(img), jm)
    got = tvgg.get_features(torch.tensor(img), tm)
    _assert_feats_close(got, want)


def test_loss_input_gradient_matches_jax(models):
    """d(style_content_loss)/d(image) through get_features(gram1=True):
    the port's slice dispatch (K2/K3 plain versions, Gram VJPs) against the
    JAX package's CPU path (XLA convolutions, tap Grams)."""
    import jax

    import st3d.ops.losses as jl
    from st3d_torch.ops import losses as tl

    jm, tm = models
    rng = np.random.RandomState(7)
    img, content, style = (rng.rand(2, 16, 16, 3).astype(np.float32)
                           for _ in range(3))
    nchw = [np.transpose(a, (0, 3, 1, 2)).copy() for a in (content, style)]
    jt = jl.StyleContentTargets.create(*map(jnp.asarray, nchw), jm,
                                       layout="NHWC")
    tt = tl.StyleContentTargets.create(*map(torch.tensor, nchw), tm,
                                       layout="NHWC")

    def jloss(x):
        f = jvgg.get_features(x, jm, layout="NHWC", input_layout="NHWC",
                              gram1=True)
        return jl.style_content_loss(f, jt, 1e6, 1.0, layout="NHWC")

    l_j, g_j = jax.value_and_grad(jloss)(jnp.asarray(img))
    xt = torch.tensor(img, requires_grad=True)
    f = tvgg.get_features(xt, tm, layout="NHWC", input_layout="NHWC",
                          gram1=True)
    l_t = tl.style_content_loss(f, tt, 1e6, 1.0, layout="NHWC")
    l_t.backward()
    assert float(l_t) == pytest.approx(float(l_j), rel=1e-4)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-4,
                               atol=1e-4 * np.abs(g_j).max())


def test_gram1_closed_form_matches_jax():
    rng = np.random.RandomState(9)
    p = rng.rand(2, 50, 27).astype(np.float32)
    ptp = np.einsum("bnk,bnl->bkl", p, p)
    s = p.sum(axis=1)
    w = (rng.randn(3, 3, 3, 64) * 0.3).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    want = np.asarray(jvgg.gram1_closed_form(
        jnp.asarray(ptp), jnp.asarray(s), jnp.asarray(w), jnp.asarray(b), 50))
    got = tvgg.gram1_closed_form(torch.tensor(ptp), torch.tensor(s),
                                 torch.tensor(w), torch.tensor(b), 50).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_npz_round_trip_through_get_vgg(models, tmp_path, monkeypatch):
    jm, tm = models
    path = str(tmp_path / "vgg.npz")
    tvgg.save_vgg19_npz(tm, path)
    with np.load(path) as data:
        for i, k in enumerate(jm.kernels):
            np.testing.assert_array_equal(data[f"conv{i}_kernel"],
                                          np.asarray(k))
    loaded = tvgg.get_vgg(path)
    for a, b in zip(loaded.kernels + loaded.biases, tm.kernels + tm.biases):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # The JAX package reads the same file.
    jl = jvgg.load_vgg19_npz(path)
    np.testing.assert_array_equal(np.asarray(jl.kernels[3]),
                                  tm.kernels[3].numpy())
    # $ST3D_VGG_WEIGHTS is the next channel; a missing explicit path raises.
    monkeypatch.setenv("ST3D_VGG_WEIGHTS", path)
    torch.testing.assert_close(tvgg.get_vgg().kernels[5], tm.kernels[5])
    with pytest.raises(FileNotFoundError):
        tvgg.get_vgg(str(tmp_path / "missing.npz"))


def test_random_init_is_deterministic_he():
    a, b = tvgg.init_random_vgg19(3), tvgg.init_random_vgg19(3)
    torch.testing.assert_close(a.kernels[7], b.kernels[7], atol=0, rtol=0)
    std = float(a.kernels[12].std())
    assert abs(std - (2.0 / (9 * 512)) ** 0.5) < 0.05 * std
    with pytest.raises(ValueError):
        tvgg.VGG19(a.kernels[:-1], a.biases[:-1])
