"""The port's spans and counters (``st3d_torch/utils/trace.py``) on the CPU:
off by default with nothing recorded; the tree a second-approach and a
multi-style run record (set-up by phase, then per epoch its steps with
their forward, backward and optim phases and the epoch's end); losses and
leaves bit-equal with tracing on and off; each span a ``user_annotation``
of ``torch.profiler`` whose anchored Unix-ns start lies within 1 ms of
kineto's; spans closed when an optimiser hook raises; the kernel counters
read from ``kernels/build.py``; and ``--profile``'s ``spans.json``."""

import json
import os

import pytest
import torch

from st3d_torch.engine import pipelines
from st3d_torch.engine.config import parse_second_approach
from st3d_torch.engine.multistyle import run_multistyle
from st3d_torch.io.image import write_png
from st3d_torch.kernels import build
from st3d_torch.models.vgg import init_random_vgg19, save_vgg19_npz
from st3d_torch.profile_step import write_sphere_scene
from st3d_torch.utils import trace

SIZE = 32
EPOCHS = 2
SETUP_PHASES = {"setup.scene", "setup.vgg", "setup.targets",
                "setup.visibility"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts with tracing off and no records: a worker that
    ran another file first may hold the records of its runs (``enable``
    clears them, ``disable`` keeps them readable)."""
    trace.enable()
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic sphere scene, a second style and random VGG-19
    weights; 3 views in batches of 2, so an epoch is two steps."""
    import numpy as np

    root = tmp_path_factory.mktemp("trace")
    obj, style = write_sphere_scene(str(root), SIZE, 0, 2)
    other = str(root / "other.png")
    write_png(other, (np.random.RandomState(1).rand(SIZE, SIZE, 3)
                      * 255).astype(np.uint8))
    save_vgg19_npz(init_random_vgg19(0), str(root / "vgg.npz"))
    argv = ["--obj_path", obj, "--style_path", style, "--size", str(SIZE),
            "--n_views", "3", "--batch_size", "2", "--epochs", str(EPOCHS),
            "--save_intermediate", "False", "--device", "cpu",
            "--vgg_weights", str(root / "vgg.npz")]
    return root, argv, [style, other]


def _second(argv, out, *extra):
    return pipelines.run_second_approach(parse_second_approach(
        argv + ["--output_path", out] + list(extra)))


def _multi(argv, styles, out):
    return run_multistyle(parse_second_approach(
        argv + ["--output_path", out]), styles)


def _children(recs, parent):
    return [i for i, r in enumerate(recs) if r[1] == parent]


def _names(recs, idx):
    return [recs[i][0] for i in idx]


def _below(recs, parent):
    """Every name under ``parent``, at any depth."""
    out = set()
    for i in _children(recs, parent):
        out.add(recs[i][0])
        out |= _below(recs, i)
    return out


def test_off_by_default_records_nothing():
    assert not trace.enabled()
    a, b = trace.span("render"), trace.span("vgg")
    assert a is b
    with a:
        trace.count("steps")
    assert trace.records() == []
    assert "steps" not in trace.counters()


def _check_tree(recs, steps_per_epoch):
    """Set-up by phase, every span closed and nested in time, then per
    epoch ``steps_per_epoch`` steps (forward holding render, vgg and loss;
    backward; optim) and the epoch's end; then the final render."""
    assert all(r[3] >= r[2] > 0 for r in recs)
    for name, parent, a, b in recs:
        if parent >= 0:
            assert recs[parent][2] <= a and b <= recs[parent][3]
    top = _children(recs, -1)
    names = _names(recs, top)
    first_step = names.index("step")
    assert set(names[:first_step]) == {"setup"}
    setup = set()
    for i in top[:first_step]:
        setup |= _below(recs, i)
    assert SETUP_PHASES <= setup
    assert all(recs[i][3] <= recs[top[first_step]][2]
               for i in top[:first_step])
    last = len(names) - 1 - names[::-1].index("epoch_end")
    loop = names[first_step:last + 1]
    assert loop == (["step"] * steps_per_epoch + ["epoch_end"]) * EPOCHS
    assert set(names[last + 1:]) <= {"render"}     # the final render
    for i in top[first_step:]:
        if recs[i][0] != "step":
            continue
        phases = _children(recs, i)
        assert _names(recs, phases) == ["optim", "forward", "backward",
                                        "optim"]
        forward = phases[1]
        assert {"render", "vgg", "loss"} <= set(
            _names(recs, _children(recs, forward)))
    counts = trace.counters()
    assert counts["steps"] == steps_per_epoch * EPOCHS
    assert counts["epochs"] == EPOCHS


def test_second_approach_records_the_tree(scene, tmp_path):
    _, argv, _ = scene
    trace.enable()
    _second(argv, str(tmp_path / "on"))
    recs = trace.records()
    _check_tree(recs, steps_per_epoch=2)
    assert "setup.restore" in {r[0] for r in recs}


def test_multistyle_records_the_tree(scene, tmp_path):
    _, argv, styles = scene
    trace.enable()
    _multi(argv, styles, str(tmp_path / "on"))
    recs = trace.records()
    _check_tree(recs, steps_per_epoch=2)
    assert "setup.restore" in {r[0] for r in recs}


@pytest.mark.parametrize("entry", ["second", "multistyle"])
def test_tracing_leaves_the_run_bit_equal(scene, tmp_path, entry):
    _, argv, styles = scene

    def run(out):
        if entry == "second":
            return {"": _second(argv, out).texture}
        return {k: m.texture for k, m in _multi(argv, styles, out).items()}

    plain = run(str(tmp_path / "off"))
    trace.enable()
    traced = run(str(tmp_path / "on"))
    trace.disable()
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k])
    for out in ("off", "on"):
        with open(tmp_path / out / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        if out == "off":
            losses = [(r["loss"], r.get("per_style")) for r in recs]
        else:
            assert [(r["loss"], r.get("per_style")) for r in recs] == losses


def test_spans_are_user_annotations_on_the_profiler_clock():
    x = torch.randn(64, 64, requires_grad=True)
    act = torch.profiler.ProfilerActivity
    trace.enable()
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with trace.span("step"):
            with trace.span("vgg"):
                y = (x @ x).relu().sum()
            with trace.span("backward"):
                y.backward()
    recs = trace.records()
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            assert e.activity_type() == "user_annotation"
            kineto[e.name()] = e.start_ns()
    assert sorted(kineto) == ["st3d.backward", "st3d.step", "st3d.vgg"]
    for name, _, start, _ in recs:
        assert abs(trace.to_unix(start) - kineto["st3d." + name]) < 1e6


class _Stop(Exception):
    pass


def test_spans_close_when_an_optimiser_hook_raises(scene, tmp_path):
    """As the benchmark's window ends a run: an exception from Adam's
    post-hook, inside ``st3d.optim``, unwinds every open span."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    _, argv, _ = scene

    def stop(opt, args, kwargs):
        raise _Stop

    trace.enable()
    hook = register_optimizer_step_post_hook(stop)
    try:
        with pytest.raises(_Stop):
            _second(argv, str(tmp_path / "stop"))
    finally:
        hook.remove()
    recs = trace.records()
    assert recs[-1][0] == "optim" and all(r[3] for r in recs)
    with trace.span("after"):
        pass
    assert trace.records()[-1][1] == -1


def test_kernel_counters_read_the_build_registry(monkeypatch):
    """``kernels.loaded`` is ``_LIBS``'s size, ``kernels.built``
    ``BUILD_SECONDS``'s, and a library's first load is a span."""
    import ctypes.util

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_SECONDS", {"conv3x3_wgmma": 4.0})
    monkeypatch.setattr(build, "build", lambda name: libc)
    trace.enable()
    build.load("conv3x3_wgmma")
    build.load("conv3x3_wgmma")
    assert [r[0] for r in trace.records()] == ["kernels.load"]
    counts = trace.counters()
    assert counts["kernels.loaded"] == 1 and counts["kernels.built"] == 1


def test_profile_writes_spans_json(scene, tmp_path):
    _, argv, _ = scene
    out = str(tmp_path / "prof")
    _second(argv, out, "--profile", "True")
    assert not trace.enabled()
    with open(os.path.join(out, "profile", "spans.json")) as f:
        data = json.load(f)
    names = {s["name"] for s in data["spans"]}
    assert {"st3d." + p for p in SETUP_PHASES} <= names
    assert {"st3d.setup", "st3d.step", "st3d.epoch_end"} <= names
    assert {"kernels.loaded", "kernels.built", "steps",
            "epochs"} <= set(data["counters"])
    assert data["counters"]["epochs"] == EPOCHS
    with open(os.path.join(out, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "st3d.step"
               and e.get("cat") == "user_annotation" for e in events)
