"""``BENCHMARK.json`` against the benchmark contract, and cells found by
name: a new configuration and mix are new files plus new entries."""

import json
import os
import re
import shutil

import pytest

from portbench import cells, judge

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    n = 24
    total = ((2 + 14 * n) * (bench["run_seconds"] + 60) + n * 2 * 90 + 1200)
    assert total <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(body["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank", "_size"))


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] == 1
        pairs.add((w["config"], w["traffic"]))
        cell = cells.resolve(w["name"])
        assert cell.mix["entry"] in ("second_approach", "multistyle")
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
        assert set(cell.limits) >= set(judge.numbers(cell.loss))
    assert len(pairs) == len(bench["workloads"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == configs


def test_metrics_and_their_readers(bench):
    names = set()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert m["name"] not in names
            names.add(m["name"])
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            mod = cells.reader(ROOT, m["name"])
            assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
                assert set(m) <= {"name", "unit", "better", "bound",
                                  "source", "workloads"}
            else:
                assert set(m) <= {"name", "unit", "better", "source",
                                  "layer", "moves", "workloads"}
                assert m["moves"] in e2e and _line(m["layer"])
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_layer_patterns():
    specs = cells.layers(ROOT)
    assert [s["name"] for s in specs][:2] == ["render", "vgg"]
    assert all(s["patterns"] for s in specs)


def test_a_new_cell_takes_only_new_files_and_entries(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(cells.BENCH_DIR, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in _files(root)}
    d = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(d, "configs",
                                      "vgg19-768x6-bf16.json")))
    cfg["name"] = "vgg19-512x4-bf16"
    cfg["flags"].update(size=512, n_views=4, batch_size=4)
    json.dump(cfg, open(os.path.join(d, "configs", "vgg19-512x4-bf16.json"),
                        "w"))
    json.dump({"entry": "second_approach", "styles": 1, "warmup_epochs": 3,
               "flags": {"optimization_target": "mesh"}},
              open(os.path.join(d, "mixes", "mesh.json"), "w"))
    shutil.copy(os.path.join(d, "limits", "vgg19-768x6-bf16.texture.json"),
                os.path.join(d, "limits", "vgg19-512x4-bf16.mesh.json"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({**bench["configs"][1],
                             "name": "vgg19-512x4-bf16",
                             "file": "portbench/configs/vgg19-512x4-bf16.json"})
    bench["workloads"].append({"name": "vgg19-512x4-bf16.mesh",
                               "config": "vgg19-512x4-bf16",
                               "traffic": "mesh", "chips": 1, "why": "new"})
    # The metrics that read the new cell name it in their workloads.
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("workloads") and "epoch_ms" in (m["name"], m.get("moves")):
            m["workloads"].append("vgg19-512x4-bf16.mesh")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = cells.resolve("vgg19-512x4-bf16.mesh", root)
    assert cell.flags["size"] == 512
    assert cell.flags["optimization_target"] == "mesh"
    assert "epoch_ms" in [m["name"] for m in cell.end_to_end]
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in bench["per_layer"] if m["moves"] == "epoch_ms"]
    for p, body in before.items():
        if os.path.basename(p) != "BENCHMARK.json":
            assert open(p, "rb").read() == body, p


def _files(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            yield os.path.join(dirpath, f)


def test_limits_sit_between_their_readings():
    """Each limit lies above the largest sound reading it was set from and
    below the smallest control or fault reading that bounds it."""
    d = os.path.join(cells.BENCH_DIR, "limits")
    for fn in os.listdir(d):
        spec = json.load(open(os.path.join(d, fn)))
        for name in judge.numbers(cells.resolve(fn[:-len(".json")]).loss):
            lim = spec[name]
            if lim["limit"] is None:
                assert "upper" not in lim, (fn, name)
                continue
            if "lower" in lim:
                assert lim["lower"] < lim["limit"], (fn, name)
            if "upper" in lim:
                assert lim["limit"] < lim["upper"], (fn, name)
