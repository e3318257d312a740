"""Cells, found by name: ``BENCHMARK.json`` names each cell's configuration
and traffic mix, and each piece sits in a file of its own that the harness
finds by that name.

* ``BENCHMARK.json`` ``configs[].file``: the configuration (the port's CLI
  flags, the scene, the model's widths, what was assumed and reduced);
* ``portbench/mixes/<traffic>.json``: the mix (the entry point, the
  flags it adds, the number of styles, the warm-up epochs);
* ``portbench/limits/<cell>.json``: the limit of each number compared
  with the reference, and the readings it was set from;
* ``portbench/metrics/<metric>.py``: the reader of each metric that
  ``BENCHMARK.json`` lists for the cell;
* ``portbench/layers/<layer>.json``: the kernel-name patterns of a layer;
* ``portbench/losses/<loss>.py``: the perceptual loss that the
  configuration's ``model`` section names (``"loss": "gram"``), loaded
  from its path. It gives ``TAPS``, the reference's VGG taps it reads (the
  reference runs VGG to the deepest of them); ``FLAGS``, the
  configuration's flags it takes; ``targets(style, content, n, fmt)``, a
  view batch's targets from the style image's and the content render's
  taps; ``loss(cur, target, cell, fmt)``, a step's loss; ``FIRST_STEP``,
  the name of the number compared at the first step, with
  ``first_step(cur, fmt)``, its statistic from the reference's taps, and
  ``port_first_step(feats)``, the same picked from what the port's
  ``get_features`` returns; ``flops(h, w)``, one image's FLOPs of the loss,
  forward and backward; and ``layer_work(h, w, dtype)``, the (FLOPs, bytes)
  of its layers for the bound (``work.py``).

A new configuration, mix, metric or loss is new files plus new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import types
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    @property
    def flags(self) -> Dict[str, object]:
        """The port's CLI flags of the cell: the configuration's, then the
        mix's."""
        return {**self.config["flags"], **self.mix["flags"]}

    @property
    def styles(self) -> int:
        return int(self.mix.get("styles", 1))

    @property
    def dtype(self) -> str:
        return str(self.flags["compute_dtype"])

    @property
    def loss(self) -> types.ModuleType:
        """The module of the configuration's loss."""
        return load_loss(self.root, loss_name(self.config))


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str) -> str:
    return os.path.join(root, "portbench")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    d = bench_dir(root)
    mix = _load(os.path.join(d, "mixes", w["traffic"] + ".json"))
    limits = _load(os.path.join(d, "limits", workload + ".json"))
    load_loss(root, loss_name(config))
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                mix=mix, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)],
                root=root)


def _module(path: str, prefix: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, name: str):
    """The module ``portbench/metrics/<name>.py`` (names hold dots, so it
    is loaded from its path)."""
    return _module(os.path.join(bench_dir(root), "metrics", name + ".py"),
                   "portbench_metric_", name)


def loss_name(config: dict) -> str:
    """The loss that the configuration's ``model`` section names."""
    try:
        return str(config["model"]["loss"])
    except KeyError:
        raise KeyError(f"configuration {config.get('name')!r} names no "
                       f"loss: its 'model' section needs the key 'loss' "
                       f"(a file portbench/losses/<loss>.py)") from None


_LOSSES: Dict[str, types.ModuleType] = {}


def load_loss(root: str, name: str) -> types.ModuleType:
    """The module ``portbench/losses/<name>.py``, loaded from its path
    once."""
    path = os.path.join(bench_dir(root), "losses", name + ".py")
    if path not in _LOSSES:
        _LOSSES[path] = _module(path, "portbench_loss_", name)
    return _LOSSES[path]


def layers(root: str) -> List[dict]:
    """Every ``portbench/layers/*.json`` as {name, patterns, order}, in
    their order of matching (the first match wins)."""
    d = os.path.join(bench_dir(root), "layers")
    out = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            spec = _load(os.path.join(d, fn))
            out.append({"name": fn[:-5], "order": spec["order"],
                        "patterns": [p.lower() for p in spec["patterns"]]})
    return sorted(out, key=lambda s: (s["order"], s["name"]))
