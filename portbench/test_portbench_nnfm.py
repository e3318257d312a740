"""ARF's NNFM configuration (``nnfm-vgg16-768x6-f32``) and its cell,
added as new files and entries only.

The cell resolves and its loss loads; on the CPU at 64² the port's
``--loss nnfm`` run is ``correct`` against the reference, and the TF32
control and the half-batch fault are not; ``work.summary`` counts the
matching's 12.52 TFLOP an epoch at 768² in ``epoch_flops`` and none of it
in the VGG bound; the ``nnfm.*`` readers read the ``nnfm`` layer; and the
parent's ``portbench/`` files with this configuration's files and entries
added resolve the cell and run its reference, every file that was there
hashing the same.
"""

import copy
import hashlib
import json
import os
import shutil
import tempfile
import time
import types

import pytest
import torch

from portbench import cells, harness, judge, work

CELL = "nnfm-vgg16-768x6-f32.texture"
CONFIG = "nnfm-vgg16-768x6-f32"
NEW_FILES = ("losses/nnfm.py", f"configs/{CONFIG}.json",
             f"limits/{CELL}.json", "layers/nnfm.json",
             "metrics/nnfm.device_ms.py", "metrics/nnfm.roofline.py")
NEW_METRICS = ("nnfm.device_ms", "nnfm.roofline")
CPU = torch.device("cpu")
P768 = (768 // 4) ** 2


def tiny(size=64, root=cells.ROOT):
    """The cell at ``size``², 4 views in batches of 2, a level-3 sphere."""
    cell = copy.deepcopy(cells.resolve(CELL, root))
    cell.config["flags"].update(size=size, n_views=4, batch_size=2)
    cell.config["scene"]["ico_level"] = 3
    return cell


def test_the_cell_resolves_and_its_loss_loads():
    cell = cells.resolve(CELL)
    loss = cell.loss
    assert loss.__file__ == os.path.join(cells.BENCH_DIR, "losses",
                                         "nnfm.py")
    assert cell.config["model"]["loss"] == "nnfm" == cell.flags["loss"]
    assert loss.TAPS == ("conv3_1", "conv3_2", "conv3_3")
    assert judge.numbers(loss)[-1] == "nn_cos_diff"
    assert harness.reference_cell(cell.flags, loss) == {
        "size": 768, "n_views": 6, "batch_size": 4,
        "optimization_target": "texture", "lr": 0.01, "loss": "nnfm",
        "style_weight": 1.0, "content_weight": 0.005}
    assert {m["name"] for m in cell.per_layer} >= set(NEW_METRICS)
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "epoch_ms", "epoch_p95_ms", "peak_mem_mib"}


def _run(cell, seed=2 ** 31 + 3):
    return harness.run_cell(cell, seed, 0.5, False, CPU, time.perf_counter(),
                            lambda m: None)


def test_the_port_on_the_cpu_is_correct():
    r = _run(tiny())
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["compared"]) == set(judge.numbers(tiny().loss))


@pytest.mark.parametrize("kind", ["control_tf32", "half_batch"])
def test_the_control_and_the_half_batch_are_not_correct(kind):
    cell = tiny()
    with tempfile.TemporaryDirectory() as d:
        inp = harness.make_cell_inputs(cell, 5, d, CPU)
        ref = harness.reference_readings(cell, inp, CPU)
        got = (harness.reference_readings(cell, inp, CPU, "tf32")
               if kind == "control_tf32" else
               harness.reference_readings(cell, inp, CPU, half_batch=True))
    checks = judge.compare(got, ref, cell.limits, cell.loss)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_the_work_counts_the_matching_in_the_epoch_not_in_vgg():
    cell = cells.resolve(CELL)
    loss = cell.loss
    s = work.summary(cell)
    match = 6 * 2 * P768 ** 2 * 768
    assert match == pytest.approx(12.52e12, rel=1e-3)
    prefix = 6 * 2 * work.conv_forward_flops(768, 768, 7)
    assert prefix == pytest.approx(2.63e12, rel=2e-3)
    assert s["images_per_epoch"] == 6
    assert s["epoch_flops"] == prefix + match
    plain = types.SimpleNamespace(TAPS=loss.TAPS, flops=lambda h, w: 0.0,
                                  layer_work=lambda h, w, dtype: {})
    assert s["vgg_bound_s_per_epoch"] == work.vgg_bound_s(768, 6, "float32",
                                                          plain)
    f, b = loss.match_work(768, 768, "float32")
    assert f == match / 6 and b < f / 100
    assert loss.match_bound_s(768, 768, "float32") == f / 495e12


def _ctx(cell, layer_s, epochs=10):
    trace = types.SimpleNamespace(epochs=epochs, device_s_by_layer=layer_s)
    return types.SimpleNamespace(cell=cell, trace=trace,
                                 work=work.summary(cell))


def test_the_nnfm_readers_read_the_nnfm_layer():
    cell = cells.resolve(CELL)
    dev_ms = cells.reader(cells.ROOT, "nnfm.device_ms")
    roof = cells.reader(cells.ROOT, "nnfm.roofline")
    bound = 6 * cell.loss.match_bound_s(768, 768, "float32")
    ctx = _ctx(cell, {"nnfm": 10 * bound, "vgg": 1.0})
    assert dev_ms.read(ctx) == pytest.approx(1e3 * bound)
    assert roof.read(ctx) == pytest.approx(100.0)
    # Cells without the layer, or whose loss has no matching, read none.
    assert dev_ms.read(_ctx(cell, {"vgg": 1.0})) is None
    gram = cells.resolve("vgg19-768x6-f32.texture")
    assert roof.read(_ctx(gram, {"nnfm": 1.0})) is None
    assert [s["name"] for s in cells.layers(cells.ROOT)][:2] == ["render",
                                                                   "vgg"]
    assert "nnfm" in {s["name"] for s in cells.layers(cells.ROOT)}


def _strip(bench):
    """``BENCHMARK.json`` without this configuration's entries."""
    out = copy.deepcopy(bench)
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"]
                        if m["name"] not in NEW_METRICS]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return out


def _add(parent, bench):
    """``parent`` with this configuration's entries appended, as taken from
    ``bench``."""
    out = copy.deepcopy(parent)
    out["configs"].append(next(c for c in bench["configs"]
                               if c["name"] == CONFIG))
    out["workloads"].append(next(w for w in bench["workloads"]
                                 if w["name"] == CELL))
    for kind in ("end_to_end", "per_layer"):
        named = {m["name"]: m for m in bench[kind]}
        for m in out[kind]:
            if CELL in named[m["name"]].get("workloads", ()):
                m["workloads"].append(CELL)
    out["per_layer"] += [m for m in bench["per_layer"]
                         if m["name"] in NEW_METRICS]
    return out


def _hashes(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_the_configuration_is_new_files_and_entries_only(tmp_path):
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    parent = _strip(bench)
    assert _add(parent, bench) == bench
    root = str(tmp_path)
    d = os.path.join(root, "portbench")
    new = [os.path.join(d, rel) for rel in NEW_FILES]
    shutil.copytree(cells.BENCH_DIR, d, ignore=shutil.ignore_patterns(
        "__pycache__", "test_portbench_nnfm.py"))
    for p in new:
        os.remove(p)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(parent, f)
    with pytest.raises(KeyError):
        cells.resolve(CELL, root)
    before = _hashes(d)
    for rel in NEW_FILES:
        shutil.copy(os.path.join(cells.BENCH_DIR, rel), os.path.join(d, rel))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(_add(parent, bench), f)
    cell = tiny(32, root)
    assert cell.loss.__file__ == os.path.join(d, "losses", "nnfm.py")
    with tempfile.TemporaryDirectory() as w:
        inp = harness.make_cell_inputs(cell, 2 ** 31 + 9, w, CPU)
        ref = harness.reference_readings(cell, inp, CPU)
    assert {k: tuple(v.shape) for k, v in ref["first_step"].items()} == {
        "relu3:nn_cos": (2, 64)}
    assert all(v > 0 for v in ref["epoch_loss"].values())
    after = _hashes(d)
    assert {p: h for p, h in after.items() if p not in new} == before
