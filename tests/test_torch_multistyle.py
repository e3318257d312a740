"""The multi-style engine (``st3d_torch/engine/multistyle.py``, the
``st3d_torch.multi_style`` CLI) against ``st3d.engine.multistyle`` on the
CPU: the per-style loss, and ``run_multistyle`` end to end (2 styles, 2
views, 3 epochs at 32²) at the slice's tolerances (losses within rtol 1e-4
at first and 1e-3 after, textures within 1e-4; ``test_torch_slice.py``);
each style's texture within 2e-4 of a single-style second-approach run of
that style (the JAX package's tolerance for batched against sequential,
``tests/test_fleetbatch.py``); and resume bit-equal to an uninterrupted
run."""

import json
import os

import numpy as np
import pytest
import torch

from st3d_torch.engine.multistyle import _multi_style_content_loss
from st3d_torch.io.image import write_png
from st3d_torch.multi_style import main
from st3d_torch.profile_step import write_sphere_scene

SIZE = 32
EPOCHS = 3
LAYERS = {"conv1_1": (1, 5), "conv2_1": (2, 6), "conv3_1": (4, 7),
          "conv4_1": (8, 8), "conv5_1": (16, 9)}   # (scale, channels)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_inputs(lead, image_h, gram, seed=0):
    """Seeded feats, content features and Gram targets with leading axes
    ``lead`` (then B = 2), taps of ``image_h`` // scale rows."""
    rng = np.random.RandomState(seed)
    b = 2
    feats, grams = {}, {}
    for layer, (scale, c) in LAYERS.items():
        h = image_h // scale
        if gram:
            feats[layer + ":gram"] = rng.rand(*lead, b, c, c) * 5
        else:
            feats[layer] = rng.rand(*lead, b, h, h + 1, c)
        grams[layer] = rng.rand(*lead[-1:], b, c, c) * 5
    h = image_h // 8
    feats["conv4_2"] = rng.rand(*lead, b, h, h + 1, 4)
    content = rng.rand(*lead[:-1], b, h, h + 1, 4)
    f32 = lambda t: {k: v.astype(np.float32) for k, v in t.items()}  # noqa
    return f32(feats), content.astype(np.float32), f32(grams)


@pytest.mark.parametrize("gram", [True, False])
@pytest.mark.parametrize("image_h", [64, 60])
def test_multi_style_content_loss_matches_jax(image_h, gram):
    """(S,) per-style losses, with ``:gram`` keys (divisor height
    ``image_h // scale``, 60 not a multiple of 8) and with plain taps."""
    import jax.numpy as jnp

    from st3d.engine.multistyle import _multi_style_content_loss as jax_loss

    feats, content, grams = _loss_inputs((3,), image_h, gram)
    want = np.asarray(jax_loss(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(content),
        {k: jnp.asarray(v) for k, v in grams.items()}, 1e6, 1.0, image_h))
    got = _multi_style_content_loss(
        {k: torch.tensor(v) for k, v in feats.items()},
        torch.tensor(content), {k: torch.tensor(v) for k, v in grams.items()},
        1e6, 1.0, image_h)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_multi_style_content_loss_with_a_mesh_axis_matches_jax():
    """The fleet's (M, S) grid: each mesh's content features broadcast over
    the styles, the Grams over the meshes, as the JAX fleet's vmap."""
    import jax
    import jax.numpy as jnp

    from st3d.engine.multistyle import _multi_style_content_loss as jax_loss

    feats, content, grams = _loss_inputs((2, 3), 60, True, seed=1)
    want = np.asarray(jax.vmap(jax_loss, in_axes=(0, 0, None, None, None,
                                                  None))(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(content),
        {k: jnp.asarray(v) for k, v in grams.items()}, 1e6, 1.0, 60))
    got = _multi_style_content_loss(
        {k: torch.tensor(v) for k, v in feats.items()},
        torch.tensor(content)[:, None],
        {k: torch.tensor(v) for k, v in grams.items()}, 1e6, 1.0, 60)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    import st3d.models.vgg as jvgg

    from st3d_torch.convert import vgg19_from_numpy
    from st3d_torch.models.vgg import save_vgg19_npz

    root = tmp_path_factory.mktemp("multistyle")
    obj, style = write_sphere_scene(str(root), SIZE, 0, 2)
    style2 = str(root / "other.png")
    write_png(style2, (np.random.RandomState(7).rand(SIZE, SIZE, 3)
                       * 255).astype(np.uint8))
    jm = jvgg.init_random_vgg19(0)
    save_vgg19_npz(vgg19_from_numpy(jm.kernels, jm.biases),
                   str(root / "vgg.npz"))
    argv = ["--obj_path", obj, "--size", str(SIZE), "--n_views", "2",
            "--batch_size", "2", "--randomize_views", "False",
            "--epochs", str(EPOCHS), "--vgg_weights", str(root / "vgg.npz")]
    return root, argv, [style, style2]


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Logger:"
    with open(os.path.join(out, "metrics.jsonl")) as f:
        per_style = [json.loads(l)["per_style"] for l in f]
    return [float(l.rsplit(" ", 1)[1]) for l in lines[1:]], per_style


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def _close(got, want):
    assert len(got) == len(want) == EPOCHS
    assert got[0] == pytest.approx(want[0], rel=1e-4)
    for a, b in zip(got[1:], want[1:]):
        assert a == pytest.approx(b, rel=1e-3)


@pytest.fixture(scope="module")
def port_run(scene):
    root, argv, styles = scene
    out = str(root / "port")
    return out, main(argv + ["--style_paths", ",".join(styles),
                             "--output_path", out, "--device", "cpu"])


def test_run_multistyle_matches_jax(scene, port_run, monkeypatch):
    from st3d.engine.config import parse_second_approach as jax_parse
    from st3d.engine.multistyle import run_multistyle as jax_run

    monkeypatch.setenv("ST3D_COMPILE_CACHE", "")
    root, argv, styles = scene
    jax_out = str(root / "jax")
    want = jax_run(jax_parse(argv + ["--output_path", jax_out]), styles)
    out, got = port_run
    assert list(got) == list(want) == ["style", "other"]
    lt, pt = _log(out)
    lj, pj = _log(jax_out)
    _close(lt, lj)
    assert lt[-1] < lt[0]
    for name in got:
        _close([p[name] for p in pt], [p[name] for p in pj])
        np.testing.assert_allclose(got[name].texture.numpy(),
                                   np.asarray(want[name].texture),
                                   atol=1e-4, err_msg=name)
    assert _tree(out) == _tree(jax_out)
    assert len(os.listdir(os.path.join(out, "other", "final_render"))) == 12


def test_each_style_equals_its_single_style_run(scene, port_run):
    """Disjoint texels and elementwise Adam: each style's texture is that
    of a second-approach run of that style alone."""
    from st3d_torch.second_approach import main as second_approach

    root, argv, styles = scene
    _, got = port_run
    for style, name in zip(styles, got):
        single = second_approach(argv + [
            "--style_path", style, "--save_intermediate", "False",
            "--output_path", str(root / f"single_{name}"),
            "--device", "cpu"])
        np.testing.assert_allclose(got[name].texture.numpy(),
                                   single.texture.numpy(), atol=2e-4)


def test_multistyle_resume_is_bit_equal(scene, port_run, tmp_path):
    root, argv, styles = scene
    out = str(tmp_path / "part")
    common = argv + ["--style_paths", ",".join(styles), "--output_path", out,
                     "--device", "cpu", "--checkpoint_every", "2"]
    main(common + ["--epochs", "2"])
    resumed = main(common + ["--resume", "True"])
    losses, _ = _log(out)
    assert len(losses) == EPOCHS - 2
    assert losses == _log(port_run[0])[0][2:]
    for name, mesh in port_run[1].items():
        assert torch.equal(resumed[name].texture, mesh.texture)


@pytest.mark.parametrize("flag", ["--data_parallel", "--tile_parallel"])
def test_parallel_flags_run_in_a_world_of_one(scene, port_run, tmp_path,
                                              flag):
    """Without ``torchrun`` both flags take the plain path: the same losses
    and textures as the run without them."""
    root, argv, styles = scene
    got = main(argv + ["--style_paths", ",".join(styles), "--device", "cpu",
                       "--output_path", str(tmp_path), flag, "True"])
    assert _log(str(tmp_path)) == _log(port_run[0])
    for name, mesh in port_run[1].items():
        assert torch.equal(got[name].texture, mesh.texture)
