"""Checkpoints, ``--resume``, ``--debug_nan`` and ``--profile`` of the port
(``st3d_torch/utils/checkpoint.py``, ``utils/debug.py``,
``engine/pipelines.py``), held to the JAX package's behaviour
(``tests/test_pipelines.py``, ``tests/test_edge_cases.py``) on the CPU.

A resumed run restores the leaves, Adam's moments and step and the
generator state, so on the CPU it equals an uninterrupted run bit for bit,
with white and with noise backgrounds. A checkpoint the JAX package wrote
carries over through ``convert.adam_state_from_numpy``: the port's resumed
epochs then match JAX's at the slice's tolerances (losses within rtol 1e-4
at first and 1e-3 after, textures within 1e-4; ``test_torch_slice.py``)."""

import os

import numpy as np
import pytest
import torch

from st3d_torch.engine import pipelines
from st3d_torch.engine.config import (parse_first_approach,
                                      parse_second_approach)
from st3d_torch.profile_step import write_sphere_scene
from st3d_torch.utils.checkpoint import (
    adam_leaves,
    load_checkpoint,
    save_checkpoint,
)
from st3d_torch.utils.debug import check_finite

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic sphere scene and the JAX package's random VGG-19
    weights (so the port and JAX runs share them)."""
    import st3d.models.vgg as jvgg

    from st3d_torch.convert import vgg19_from_numpy
    from st3d_torch.models.vgg import save_vgg19_npz

    root = tmp_path_factory.mktemp("ckpt")
    obj, style = write_sphere_scene(str(root), SIZE, 0, 2)
    jm = jvgg.init_random_vgg19(0)
    save_vgg19_npz(vgg19_from_numpy(jm.kernels, jm.biases),
                   str(root / "vgg.npz"))
    return root, ["--obj_path", obj, "--style_path", style, "--size",
                  str(SIZE), "--n_views", "2", "--batch_size", "2",
                  "--randomize_views", "False", "--save_intermediate",
                  "False", "--vgg_weights", str(root / "vgg.npz")]


def _lines(out):
    with open(os.path.join(out, "log.txt")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Logger:"
    return lines[1:]


def _second(argv, out, *extra):
    return pipelines.run_second_approach(parse_second_approach(
        argv + ["--device", "cpu", "--output_path", out] + list(extra)))


def _first(argv, out, *extra):
    return pipelines.run_first_approach(parse_first_approach(
        argv + ["--device", "cpu", "--output_path", out,
                "--n_style_transfer_steps", "2"] + list(extra)))


# ---------------------------------------------------------------------------
# The file
# ---------------------------------------------------------------------------

def _state(seed=0, shape=(4, 4, 3), dtype=torch.float32):
    """{"texture", "verts"} leaves after two Adam steps, and a generator."""
    g = torch.Generator().manual_seed(seed)
    params = {"verts": torch.rand((5, 3), generator=g, dtype=dtype),
              "texture": torch.rand(shape, generator=g, dtype=dtype)}
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=0.1)
    for _ in range(2):
        opt.zero_grad()
        sum((p ** 2).sum() for p in params.values()).backward()
        opt.step()
    torch.rand(3, generator=g)
    return params, opt, g


def test_checkpoint_round_trip(tmp_path):
    params, opt, gen = _state()
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, 7, params, opt, gen, extras={"mse_done": 3})
    assert not os.path.exists(path + ".tmp.npz")
    fresh, fopt, fgen = _state(seed=1)
    step, extras = load_checkpoint(path, fresh, fopt, fgen)
    assert step == 7 and int(extras["mse_done"]) == 3
    for k in params:
        assert torch.equal(fresh[k], params[k])
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fopt.state[fresh[k]][key],
                               opt.state[params[k]][key]), (k, key)
    assert torch.equal(torch.rand(4, generator=fgen),
                       torch.rand(4, generator=gen))


def test_checkpoint_keys_follow_the_jax_layout(tmp_path):
    """The same leaves under the same keys, shapes and dtypes as the JAX
    package's checkpoint of optax.adam's state; the random state under a
    key of the port's own."""
    import jax
    import jax.numpy as jnp
    import optax

    from st3d.utils.checkpoint import save_checkpoint as jax_save

    params, opt, gen = _state()
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()}
    jax_save(str(tmp_path / "j.npz"), 7, jp, optax.adam(0.1).init(jp),
             jax.random.PRNGKey(0))
    save_checkpoint(str(tmp_path / "t.npz"), 7, params, opt, gen)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert set(j.files) - {"r0"} == set(t.files) - {"g_state"}
    for k in j.files:
        if k != "r0":
            assert (j[k].shape, j[k].dtype) == (t[k].shape, t[k].dtype), k
    # count, then mu and nu in sorted-key order (texture before verts).
    assert int(t["o0"]) == 2
    assert np.array_equal(t["o1"], opt.state[params["texture"]]["exp_avg"])
    assert np.array_equal(t["o4"], opt.state[params["verts"]]["exp_avg_sq"])


@pytest.mark.parametrize("fault", ["missing", "shape", "dtype"])
def test_checkpoint_mismatch_raises_naming_the_leaf(tmp_path, fault):
    """As ``tests/test_edge_cases.py::test_checkpoint_shape_mismatch_error``:
    a ValueError naming the leaf, before anything is restored."""
    params, opt, gen = _state()
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, 3, params, opt, gen)
    if fault == "missing":
        data = dict(np.load(path))
        del data["o2"]
        np.savez(path, **data)
        want, into = "missing o2", _state(seed=1)
    elif fault == "shape":
        want, into = "p0 has shape", _state(seed=1, shape=(8, 8, 3))
    else:
        want, into = "p0 has dtype", _state(seed=1, dtype=torch.float64)
    before = into[0]["texture"].detach().clone()
    with pytest.raises(ValueError, match=want):
        load_checkpoint(path, *into)
    assert torch.equal(into[0]["texture"], before)


def test_adam_state_from_numpy_continues_the_trajectory():
    """Adam's state carried across through numpy takes the same next step
    as the optimizer it came from."""
    from st3d_torch.convert import adam_state_from_numpy

    params, opt, _ = _state()
    count, *moments = adam_leaves(opt, params)
    fresh = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
    fopt = torch.optim.Adam(list(fresh.values()), lr=0.1)
    adam_state_from_numpy(fopt, fresh, count, moments[:2], moments[2:])
    for o, p in ((opt, params), (fopt, fresh)):
        o.zero_grad()
        sum((x ** 2).sum() for x in p.values()).backward()
        o.step()
    for k in params:
        assert torch.equal(params[k], fresh[k])


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bg", ["white", "noise"])
def test_second_approach_resume_is_bit_equal(scene, tmp_path, bg):
    """As ``tests/test_pipelines.py::test_checkpoint_resume``: 2 epochs with
    ``--checkpoint_every 2``, resumed to 4, equal an uninterrupted 4-epoch
    run bit for bit (noise backgrounds: the generator state is restored),
    and the resumed log holds only epochs 2 and 3."""
    _, argv = scene
    argv = argv + ["--content_background", bg, "--current_background", bg]
    whole = _second(argv, str(tmp_path / "whole"), "--epochs", "4")
    out = str(tmp_path / "part")
    _second(argv, out, "--epochs", "2", "--checkpoint_every", "2")
    assert os.path.isfile(os.path.join(out, "checkpoint.npz"))
    resumed = _second(argv, out, "--epochs", "4", "--checkpoint_every", "2",
                      "--resume", "True")
    lines = _lines(out)
    assert [l.split(",")[0] for l in lines] == ["Epoch 2", "Epoch 3"]
    assert lines == _lines(str(tmp_path / "whole"))[2:]
    assert torch.equal(resumed.texture, whole.texture)


def test_first_approach_batch_resume(scene, tmp_path, monkeypatch):
    """As ``tests/test_pipelines.py::test_first_approach_resume``: a run cut
    after batch 0's checkpoint resumes at batch 1 and ends bit-equal to an
    uninterrupted run; resuming a finished run takes no step."""
    _, argv = scene
    argv = argv + ["--n_views", "4", "--n_mse_steps", "3"]
    whole = _first(argv, str(tmp_path / "whole"))
    out = str(tmp_path / "cut")
    real = pipelines.save_checkpoint

    def cut_after_batch_0(path, step, *a, **kw):
        real(path, step, *a, **kw)
        if step == 1:
            raise RuntimeError("cut")

    monkeypatch.setattr(pipelines, "save_checkpoint", cut_after_batch_0)
    with pytest.raises(RuntimeError, match="cut"):
        _first(argv, out)
    monkeypatch.setattr(pipelines, "save_checkpoint", real)
    resumed = _first(argv, out, "--resume", "True")
    assert [l.split(", Loss")[0] for l in _lines(out)] == [
        f"Batch 1, Step {s}" for s in range(3)]
    assert _lines(out) == _lines(str(tmp_path / "whole"))[3:]
    assert torch.equal(resumed.texture, whole.texture)
    _first(argv, out, "--resume", "True")
    assert _lines(out) == []


def test_first_approach_midbatch_resume(scene, tmp_path, monkeypatch):
    """As ``tests/test_pipelines.py::test_first_approach_midbatch_resume``:
    cut right after the first mid-batch checkpoint (step 3 of 7, with the
    log flushed up to it), the resumed run continues the MSE steps against
    the stored stylised targets, without a new style transfer, and ends
    bit-equal to an uninterrupted run."""
    _, argv = scene
    argv = argv + ["--n_mse_steps", "7", "--checkpoint_every", "3",
                   "--style_transfer_init", "noise",
                   "--content_background", "noise"]
    whole = _first(argv, str(tmp_path / "whole"))
    out = str(tmp_path / "cut")
    real = pipelines.save_checkpoint

    def cut_mid_batch(path, step, *a, extras=None, **kw):
        real(path, step, *a, extras=extras, **kw)
        if extras is not None:
            assert len(_lines(out)) == int(extras["mse_done"]) == 3
            raise RuntimeError("cut")

    monkeypatch.setattr(pipelines, "save_checkpoint", cut_mid_batch)
    with pytest.raises(RuntimeError, match="cut"):
        _first(argv, out)
    monkeypatch.setattr(pipelines, "save_checkpoint", real)

    def no_style_transfer(*a, **kw):
        raise AssertionError("the resumed batch ran the style transfer")

    monkeypatch.setattr(pipelines, "style_transfer", no_style_transfer)
    resumed = _first(argv, out, "--resume", "True")
    lines = _lines(out)
    assert lines[0].startswith("Batch 0, Step 3, ")
    assert lines == _lines(str(tmp_path / "whole"))[3:]
    assert torch.equal(resumed.texture, whole.texture)


def test_first_approach_checkpoints_land_on_every_boundary(scene, tmp_path,
                                                           monkeypatch):
    """As ``tests/test_pipelines.py::
    test_first_approach_checkpoint_every_not_multiple_of_chunk``: mid-batch
    checkpoints at every multiple of ``checkpoint_every`` short of the
    batch's end, then one per batch."""
    _, argv = scene
    real = pipelines.save_checkpoint
    seen = []

    def recording(path, step, *a, extras=None, **kw):
        seen.append((step, None if extras is None
                     else int(extras["mse_done"])))
        real(path, step, *a, extras=extras, **kw)

    monkeypatch.setattr(pipelines, "save_checkpoint", recording)
    _first(argv + ["--n_views", "4", "--n_mse_steps", "7",
                   "--checkpoint_every", "3"], str(tmp_path / "o"))
    assert seen == [(0, 3), (0, 6), (1, None), (1, 3), (1, 6), (2, None)]


def test_jax_checkpoint_resumes_in_the_port(scene, tmp_path, monkeypatch):
    """A JAX second-approach run writes ``checkpoint.npz`` at epoch 3; its
    ``p*``/``o*`` leaves go through ``adam_state_from_numpy``, and the
    port's 2 further epochs match JAX's resumed epochs."""
    from st3d.engine.config import parse_second_approach as jax_parse
    from st3d.engine.pipelines import run_second_approach as jax_run

    from st3d_torch.convert import adam_state_from_numpy

    monkeypatch.setenv("ST3D_COMPILE_CACHE", "")
    _, argv = scene
    jax_out = str(tmp_path / "jax")
    jax_run(jax_parse(argv + ["--output_path", jax_out, "--epochs", "3",
                              "--checkpoint_every", "3"]))
    with np.load(os.path.join(jax_out, "checkpoint.npz")) as data:
        ck = dict(data)
    assert set(ck) == {"__step__", "p0", "o0", "o1", "o2", "r0"}
    final_j = jax_run(jax_parse(argv + ["--output_path", jax_out,
                                        "--epochs", "5", "--resume",
                                        "True"]))

    params = {"texture": torch.tensor(ck["p0"]).requires_grad_(True)}
    opt = torch.optim.Adam(list(params.values()), lr=0.01)
    adam_state_from_numpy(opt, params, ck["o0"], [ck["o1"]], [ck["o2"]])
    out = str(tmp_path / "port")
    save_checkpoint(os.path.join(out, "checkpoint.npz"), int(ck["__step__"]),
                    params, opt, torch.Generator().manual_seed(0))
    final_t = _second(argv, out, "--epochs", "5", "--resume", "True")

    lj, lt = _lines(jax_out), _lines(out)
    assert [l.split(",")[0] for l in lt] == [l.split(",")[0] for l in lj] \
        == ["Epoch 3", "Epoch 4"]
    loss = [[float(l.rsplit(" ", 1)[1]) for l in ls] for ls in (lt, lj)]
    assert loss[0][0] == pytest.approx(loss[1][0], rel=1e-4)
    assert loss[0][1] == pytest.approx(loss[1][1], rel=1e-3)
    np.testing.assert_allclose(final_t.texture.numpy(),
                               np.asarray(final_j.texture), atol=1e-4)


# ---------------------------------------------------------------------------
# --debug_nan and --profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,kind", [(float("nan"), "nan"),
                                        (float("inf"), "inf"),
                                        (-float("inf"), "inf")])
def test_check_finite_names_the_leaf(value, kind):
    """As ``tests/test_pipelines.py::test_debug_nan_guard_catches``."""
    ok = {"texture": torch.ones(3), "step": torch.tensor(2)}
    check_finite(ok, "epoch 0")
    check_finite(torch.log(torch.tensor(1.0)), "epoch 0")
    bad = dict(ok, verts=torch.tensor([1.0, value]))
    with pytest.raises(FloatingPointError,
                       match=rf"\({kind}\) in epoch 4 gradient\['verts'\]"):
        check_finite(bad, "epoch 4 gradient")


def test_debug_nan_run_raises_naming_the_epoch(scene, tmp_path):
    """A run driven non-finite stops at its first step; with finite values
    the guarded run equals the unguarded one bit for bit."""
    _, argv = scene
    with pytest.raises(FloatingPointError,
                       match=r"\(inf\) in epoch 0, batch 0 loss"):
        _second(argv, str(tmp_path / "inf"), "--epochs", "2",
                "--style_weight", "inf", "--debug_nan", "True")
    with pytest.raises(FloatingPointError,
                       match=r"in batch 0, step 0 parameter\['texture'\]"):
        _first(argv, str(tmp_path / "inf1"), "--n_mse_steps", "2",
               "--mse_lr", "inf", "--debug_nan", "True")
    guarded = _second(argv, str(tmp_path / "on"), "--epochs", "2",
                      "--debug_nan", "True")
    plain = _second(argv, str(tmp_path / "off"), "--epochs", "2")
    assert torch.equal(guarded.texture, plain.texture)
    assert _lines(str(tmp_path / "on")) == _lines(str(tmp_path / "off"))


@pytest.mark.parametrize("approach", ["second", "first"])
def test_profile_writes_a_trace(scene, tmp_path, approach):
    """As ``tests/test_pipelines.py::test_profile_flag_writes_trace``: a
    Chrome trace of the optimisation loop, the port's VGG autograd
    functions and its ``st3d.*`` spans among its events, its device time by
    kernel (empty on the CPU) and its spans (``spans.json``) under
    ``output_path/profile/``."""
    import json

    _, argv = scene
    out = str(tmp_path / approach)
    if approach == "second":
        _second(argv, out, "--epochs", "1", "--profile", "True")
    else:
        _first(argv, out, "--n_mse_steps", "2", "--profile", "True")
    prof = os.path.join(out, "profile")
    assert sorted(os.listdir(prof)) == ["device_ms.json", "spans.json",
                                        "trace.json"]
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("_Conv3x3Bias")
               for e in events)
    assert any(e.get("name") == "st3d.vgg" for e in events)
