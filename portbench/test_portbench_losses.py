"""A configuration's perceptual loss is a file of ``portbench/losses/``.

The Gram loss reads as it did before it moved there (float64 readings and
the work counts, bit for bit); a new loss takes new files and entries
only, and the reference, the work counter and the first-step tap all use
it; the reference refuses a flag it does not model.
"""

import contextlib
import hashlib
import json
import os
import shutil
import tempfile
import types

import pytest
import torch

from portbench import cells, harness, work
from portbench.reference import vgg
from portbench.reference.follow import follow
from portbench.test_portbench_reference import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
WORKLOADS = ("vgg19-768x6-f32.texture", "vgg19-768x6-bf16.texture",
             "vgg19-768x6-bf16.styles3")


@pytest.fixture(scope="module")
def recorded():
    with open(os.path.join(HERE, "fixtures", "gram-readings.json")) as f:
        return json.load(f)


@contextlib.contextmanager
def one_thread():
    """CPU convolutions split their sums by thread; the fixture was
    recorded on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def digest(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    return {"dtype": str(t.dtype), "shape": list(t.shape),
            "sha256": hashlib.sha256(t.numpy().tobytes()).hexdigest()}


@pytest.mark.parametrize("mix", ["texture", "styles3", "both-hard"])
def test_the_gram_loss_follows_as_before_bit_for_bit(mix, recorded):
    cell = tiny(mix, size=recorded["size"])
    rcell = harness.reference_cell(cell.flags, cell.loss)
    with tempfile.TemporaryDirectory() as d, one_thread():
        inp = harness.make_cell_inputs(cell, recorded["seed"], d, CPU)
        got = [follow(inp, inp.styles[k], rcell, cell.loss,
                      int(cell.flags["seed"]), harness.REFERENCE_STEPS,
                      harness.CHANGE_AFTER, CPU)
               for k in range(cell.styles)]
    want = recorded["mixes"][mix]
    assert len(got) == len(want)
    for r, w in zip(got, want):
        for part in ("epoch_loss", "step_loss", "first_grad", "change"):
            assert r[part] == w[part], part
        for part in ("first_grad_t", "first_step"):
            assert {k: digest(v) for k, v in r[part].items()} == w[part], (
                part)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_work_counts_as_before_to_the_last_bit(workload, recorded):
    assert work.summary(cells.resolve(workload)) == (
        recorded["work"][workload])


TOY = '''"""A toy loss: the mean squared difference of the render's conv3_1 map
from the style image's, times content_weight."""

import torch

TAPS = ("conv3_1",)
FLAGS = ("content_weight",)
FIRST_STEP = "conv3_1_diff"
CALLS = []


def targets(style, content, n, fmt):
    CALLS.append(("targets", sorted(style), sorted(content), n))
    return style["conv3_1"].expand(n, -1, -1, -1)


def loss(cur, target, cell, fmt):
    CALLS.append(("loss", sorted(cur)))
    return cell["content_weight"] * torch.mean((cur["conv3_1"] - target) ** 2)


def first_step(cur, fmt):
    return {k: v.cpu() for k, v in cur.items()}


def port_first_step(feats):
    return {"toy." + k: v.detach().float().cpu() for k, v in feats.items()
            if not k.endswith(":gram")}


def flops(h, w):
    return 3.0 * h * w


def layer_work(h, w, dtype):
    return {"conv3_1": (5, 7), "toy": (11, 13)}
'''


def _files(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            yield os.path.join(dirpath, f)


def _hashes(root):
    out = {}
    for p in _files(root):
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def _copy(root: str) -> str:
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), root)
    d = os.path.join(root, "portbench")
    shutil.copytree(cells.BENCH_DIR, d,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return d


def _add_toy(root: str) -> None:
    """The toy loss, a configuration naming it, its limits and entries."""
    d = os.path.join(root, "portbench")
    with open(os.path.join(d, "losses", "toy.py"), "w") as f:
        f.write(TOY)
    with open(os.path.join(d, "configs", "vgg19-768x6-f32.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "toy-64x4-f32"
    del cfg["flags"]["style_weight"]
    cfg["flags"].update(size=64, n_views=4, batch_size=2)
    cfg["scene"]["ico_level"] = 3
    cfg["model"]["loss"] = "toy"
    with open(os.path.join(d, "configs", "toy-64x4-f32.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(d, "limits", "vgg19-768x6-f32.texture.json")) as f:
        limits = json.load(f)
    limits["conv3_1_diff"] = limits.pop("gram_diff")
    with open(os.path.join(d, "limits", "toy-64x4-f32.texture.json"),
              "w") as f:
        json.dump(limits, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({**bench["configs"][0], "name": "toy-64x4-f32",
                             "file": "portbench/configs/toy-64x4-f32.json"})
    bench["workloads"].append({"name": "toy-64x4-f32.texture",
                               "config": "toy-64x4-f32", "traffic": "texture",
                               "chips": 1, "why": "a toy loss"})
    with open(path, "w") as f:
        json.dump(bench, f)


def test_a_new_loss_is_new_files_only(tmp_path):
    root = str(tmp_path)
    d = _copy(root)
    before = _hashes(d)
    _add_toy(root)
    cell = cells.resolve("toy-64x4-f32.texture", root)
    toy = cell.loss
    assert toy.__file__ == os.path.join(d, "losses", "toy.py")

    # The reference: VGG to conv3_1 only, the toy's targets, loss and
    # first-step statistic.
    with tempfile.TemporaryDirectory() as w:
        inp = harness.make_cell_inputs(cell, 2 ** 31 + 5, w, CPU)
        ref = harness.reference_readings(cell, inp, CPU)
        weights = vgg.load_weights(inp.vgg, CPU)
    assert toy.CALLS == (
        [("targets", ["conv3_1"], ["conv3_1"], 2)] * 2
        + [("loss", ["conv3_1"])] * harness.REFERENCE_STEPS)
    assert {k: tuple(v.shape) for k, v in ref["first_step"].items()} == {
        "conv3_1": (2, 256, 16, 16)}
    assert all(v > 0 for v in ref["epoch_loss"].values())
    x = torch.rand(1, 3, 64, 64, dtype=torch.float64)
    weights = [(k.double(), b.double()) for k, b in weights]
    assert set(vgg.taps(x, weights[:5], toy.TAPS)) == {"conv3_1"}

    # The work: VGG to conv3_1, the toy's FLOPs, its work in conv3_1's
    # layer and a layer of its own.
    plain = types.SimpleNamespace(TAPS=toy.TAPS, flops=lambda h, w: 0.0,
                                  layer_work=lambda h, w, dtype: {})
    layers = work.vgg_layers(work.convs_to("conv3_1"))
    base = work._layer_work(64, 64, "float32", plain)
    ours = work._layer_work(64, 64, "float32", toy)
    at = [n for n, _, _, _ in layers].index("conv3_1")
    assert len(base) == len(layers) and len(ours) == len(layers) + 1
    assert ours[at] == (base[at][0] + 5, base[at][1] + 7)
    assert ours[:at] + ours[at + 1:-1] == base[:at] + base[at + 1:]
    assert ours[-1] == (11.0, 13.0)
    s = work.summary(cell)
    assert s["images_per_epoch"] == 4
    assert s["epoch_flops"] == 4 * (
        2 * work.conv_forward_flops(64, 64, 5) + 3.0 * 64 * 64)
    assert s["vgg_bound_s_per_epoch"] == work.vgg_bound_s(64, 4, "float32",
                                                          toy)

    # The tap: the toy's pick of the first call with a gradient.
    feats = {"conv4_2": torch.ones(2, 3), "conv1_1:gram": torch.zeros(2, 2)}

    def get_features(images):
        return feats

    module = types.SimpleNamespace(get_features=get_features)
    tap = harness.FirstStepTap(module, toy)
    module.get_features(torch.zeros(1))
    assert tap.values == {} and module.get_features != get_features
    module.get_features(torch.zeros(1, requires_grad=True))
    assert set(tap.values) == {"toy.conv4_2"}
    assert torch.equal(tap.values["toy.conv4_2"], feats["conv4_2"])
    assert module.get_features is get_features

    assert _hashes(d).items() >= before.items()


def test_a_configuration_without_a_loss_fails_to_resolve(tmp_path):
    root = str(tmp_path)
    d = _copy(root)
    path = os.path.join(d, "configs", "vgg19-768x6-bf16.json")
    with open(path) as f:
        cfg = json.load(f)
    del cfg["model"]["loss"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(KeyError, match="'loss'"):
        cells.resolve("vgg19-768x6-bf16.styles3", root)


@pytest.mark.parametrize("flag,value", [
    ("soft_raster", True), ("faces_per_pixel", 4), ("blur_radius", 2e-4),
    ("randomize_views", False), ("current_background", "noise"),
    ("checkpoint_every", 100)])
def test_reference_cell_raises_on_an_unmodelled_flag(flag, value):
    cell = cells.resolve("vgg19-768x6-bf16.texture")
    rcell = harness.reference_cell(cell.flags, cell.loss)
    assert set(rcell) == {"size", "n_views", "batch_size",
                          "optimization_target", "lr", "style_weight",
                          "content_weight"}
    cell.mix = {**cell.mix, "flags": {**cell.mix["flags"], flag: value}}
    with pytest.raises(ValueError, match=flag):
        harness.reference_cell(cell.flags, cell.loss)
    with pytest.raises(ValueError, match=flag):
        harness.run_cell(cell, 1, 0.1, False, CPU, 0.0, lambda m: None)


def test_the_hard_raster_flags_at_their_modelled_values_pass():
    cell = tiny("both-hard")
    rcell = harness.reference_cell(cell.flags, cell.loss)
    assert "soft_raster" not in rcell and rcell["main_loss_weight"] == 3.0
