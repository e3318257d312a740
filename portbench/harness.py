"""One run of one cell: the port's own loop, timed by epochs, then judged
against the reference and read by the cell's metric readers.

The window is marked without touching the program: a global optimiser hook
(``torch.optim.optimizer.register_optimizer_step_post_hook``) counts the
port's Adam steps. At the last step of each epoch (every batch of views,
every style) it synchronises the device and reads the host clock; the port
synchronises there anyway to log the epoch's loss. The window opens at the
end of the warm-up epochs, which build, load and warm every kernel and
shape the cell uses, and closes at the first epoch end ``seconds`` or more
later. The port logs that epoch's loss; at the next step the hook raises
``StopRun``, which ends the loop, so the final render and ``final.obj``
are never written.

The same hooks read what the run is judged by, from the objects the window
drives, during the warm-up: the leaves before the first step, the first
gradient as Adam holds it after one step (``exp_avg / (1 - beta1)``, kept
on the host), the
leaves' change after ``CHANGE_AFTER`` steps, and each epoch's loss from the
port's ``metrics.jsonl``. The first step's statistic of the cell's loss
(``portbench/losses/<loss>.py``; the style Grams for the Gram loss) comes
from the port's own VGG call: ``FirstStepTap`` wraps ``get_features`` where
the entry's module looks it up, keeps the loss's ``port_first_step`` of the
first call that takes a gradient and puts the port's function back, so the
window runs unwrapped.
Once the window has closed, the peak memory is
read and the port's state freed, the reference follows the same inputs for
``REFERENCE_STEPS`` steps and ``judge`` compares.

A traced run (``--trace 1``) times the first half of its window untraced
and traces the rest: the profiler starts at the first epoch end past half
of ``seconds`` and its first mark follows one epoch later, so its start-up
falls in neither half. The readers take device time from the traced half
and the epoch's length from the untraced one (``Context.untraced_s``),
which the profiler's host overhead does not stretch.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, Iterable, List, Optional

import torch

from portbench import cells, devtrace, judge, work
from portbench.inputs import make_inputs
from portbench.reference.follow import follow

CHANGE_AFTER = 3
REFERENCE_STEPS = 4


class StopRun(Exception):
    """Raised from the optimiser hook once the window has closed."""


def leaves(tensors: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Leaves by name: the texture (H, W, 3), the vertices (V, 3), or a
    stacked (1, S, H, W, 3) atlas split into its styles."""
    out = {}
    for t in tensors:
        if t.dim() == 5:
            out.update({f"texture.s{s}": t[0, s] for s in range(t.shape[1])})
        elif t.dim() == 3:
            out["texture"] = t
        elif t.dim() == 2:
            out["verts"] = t
    return out


def _norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.detach().double()))
            for k, v in ts.items()}


class Window:
    """The optimiser hooks: epoch ends, the window, and the readings."""

    def __init__(self, steps_per_epoch: int, warmup: int, seconds: float,
                 device: torch.device,
                 profiler: Optional[devtrace.Profiler] = None):
        self.spe, self.warmup, self.seconds = steps_per_epoch, warmup, seconds
        self.device, self.profiler = device, profiler
        self.steps = 0
        self.ends: List[float] = []
        self.open_at: Optional[int] = None
        self.close_at: Optional[int] = None
        self.start: Dict[str, torch.Tensor] = {}
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, float] = {}
        self.first_step_at: Optional[float] = None
        self.untraced_to: Optional[int] = None

    def _params(self, opt):
        return [p for g in opt.param_groups for p in g["params"]]

    def pre(self, opt, args, kwargs) -> None:
        if self.steps == 0:
            self.first_step_at = time.perf_counter()
            self.start = {k: v.detach().clone() for k, v in
                          leaves(self._params(opt)).items()}

    def post(self, opt, args, kwargs) -> None:
        self.steps += 1
        if self.steps == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            moments = [opt.state.get(p, {}).get("exp_avg",
                                                torch.zeros_like(p))
                       for p in self._params(opt)]
            self.first_grad = {k: (v / (1.0 - beta1)).detach().cpu()
                               for k, v in leaves(moments).items()}
        if self.steps == CHANGE_AFTER:
            now = leaves(self._params(opt))
            self.change = _norms({k: now[k].detach() - self.start[k]
                                  for k in now})
        if self.close_at is not None:
            raise StopRun
        if self.steps % self.spe:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.ends.append(t)
        done = len(self.ends)
        if done < self.warmup:
            return
        if done == self.warmup:
            self.open_at = done - 1
            return
        prof = self.profiler
        if prof is not None and prof.running:
            prof.mark()
        if t - self.ends[self.open_at] >= self.seconds:
            self.close_at = done - 1
            if prof is not None:
                prof.stop()
        elif (prof is not None and self.untraced_to is None
              and t - self.ends[self.open_at] >= self.seconds / 2):
            self.untraced_to = done - 1
            prof.start()

    @property
    def epoch_s(self) -> List[float]:
        e = self.ends[self.open_at:self.close_at + 1]
        return [b - a for a, b in zip(e, e[1:])]

    @property
    def untraced_s(self) -> List[float]:
        """The epochs of the window before the profiler started (all of
        them in an untraced run)."""
        last = self.close_at if self.untraced_to is None else (
            self.untraced_to)
        e = self.ends[self.open_at:last + 1]
        return [b - a for a, b in zip(e, e[1:])]


class FirstStepTap:
    """The loss's statistic of the port's first step with a gradient,
    ``loss.port_first_step`` of what ``get_features`` returns:
    ``get_features`` wrapped in ``module`` (the entry's module, which looks
    it up by name) until that call, then put back."""

    def __init__(self, module, loss):
        self.module, self.orig = module, module.get_features
        self.pick = loss.port_first_step
        self.values: Dict[str, torch.Tensor] = {}
        module.get_features = self._call

    def _call(self, images, *args, **kwargs):
        feats = self.orig(images, *args, **kwargs)
        if torch.is_grad_enabled() and images.requires_grad:
            self.values = self.pick(feats)
            self.remove()
        return feats

    def remove(self) -> None:
        self.module.get_features = self.orig


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    cell: cells.Cell
    setup_s: float
    epoch_s: List[float]
    untraced_s: List[float]
    peak_bytes: int
    trace: Optional[devtrace.Summary]
    work: dict

    @property
    def window_s(self) -> float:
        return sum(self.epoch_s)


def _argv(flags: dict) -> List[str]:
    out = []
    for k, v in flags.items():
        out += [f"--{k}", str(v)]
    return out


# The flags the reference takes besides its loss's ``FLAGS``.
REFERENCE_FLAGS = ("size", "n_views", "batch_size", "optimization_target",
                   "lr", "main_loss_weight", "mesh_edge_loss_weight",
                   "mesh_laplacian_smoothing_weight",
                   "mesh_normal_consistency_weight", "mesh_verts_weight")
# Flags only the port reads: its precision (the reference runs float64, or
# the control's format), the seed of its rig (which ``follow`` takes
# apart), the resize of a texture the inputs draw at the render size
# already, and its intermediate images.
PORT_ONLY = ("compute_dtype", "seed", "resize_texture", "save_intermediate")
# Flags the reference models at one value only: its rig is random, its
# backgrounds white, its raster a hard z-buffer (one face a pixel, no blur).
MODELLED = {"randomize_views": True, "content_background": "white",
            "current_background": "white", "soft_raster": False,
            "faces_per_pixel": 1, "blur_radius": 0.0}


def reference_cell(flags: dict, loss) -> dict:
    """The configuration as the reference takes it, from the cell's files
    (never from the port's parsed configuration). A flag that the reference
    does not model raises: the run would be judged against another
    computation."""
    keys = REFERENCE_FLAGS + tuple(loss.FLAGS)
    odd = sorted(k for k, v in flags.items()
                 if k not in keys and k not in PORT_ONLY
                 and (k not in MODELLED or v != MODELLED[k]))
    if odd:
        raise ValueError(
            "the reference does not model " + ", ".join(
                f"{k}={flags[k]!r}" for k in odd)
            + f" (it takes {', '.join(keys)}; "
            + ", ".join(f"{k}={v!r}" for k, v in MODELLED.items()) + ")")
    return {k: flags[k] for k in keys if k in flags}


def program_losses(out_dir: str) -> Dict[int, dict]:
    """{epoch: record} of the port's ``metrics.jsonl``."""
    path = os.path.join(out_dir, "metrics.jsonl")
    recs = {}
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    recs[int(r["epoch"])] = r
    return recs


def epoch_losses(recs: Dict[int, dict], epochs, stems) -> Dict[str, float]:
    """{"e<epoch>" or "e<epoch>.<style>": loss} of the given epochs."""
    out = {}
    for e in epochs:
        r = recs.get(e)
        if r is None:
            continue
        if "per_style" in r:
            for k, s in enumerate(stems):
                out[f"e{e}.s{k}"] = float(r["per_style"][s])
        else:
            out[f"e{e}"] = float(r["loss"])
    return out


def run_program(cell: cells.Cell, seconds: float, trace: bool,
                device: torch.device, workdir: str, inp) -> dict:
    """Drive the port's loop on ``inp`` until the window closes."""
    from st3d_torch.engine.config import parse_second_approach
    from torch.optim.optimizer import (
        register_optimizer_step_post_hook,
        register_optimizer_step_pre_hook,
    )

    flags = cell.flags
    out = os.path.join(workdir, "out")
    argv = _argv({**flags, "obj_path": inp.obj_path,
                  "style_path": inp.style_paths[0],
                  "vgg_weights": inp.vgg_path, "output_path": out,
                  "device": device.type, "epochs": 10 ** 9})
    cfg = parse_second_approach(argv)
    spe = math.ceil(int(flags["n_views"]) / int(flags["batch_size"]))
    profiler = devtrace.Profiler(device.type == "cuda") if trace else None
    win = Window(spe, int(cell.mix["warmup_epochs"]), seconds, device,
                 profiler)
    if cell.mix["entry"] == "multistyle":
        from st3d_torch.engine import multistyle as entry

        def loop():
            entry.run_multistyle(cfg, inp.style_paths)
    else:
        from st3d_torch.engine import pipelines as entry

        def loop():
            entry.run_second_approach(cfg)
    tap = FirstStepTap(entry, cell.loss)
    hooks = [register_optimizer_step_pre_hook(win.pre),
             register_optimizer_step_post_hook(win.post)]
    try:
        loop()
        raise RuntimeError("the port's loop ended before the window closed")
    except StopRun:
        pass
    finally:
        tap.remove()
        for h in hooks:
            h.remove()
        if profiler is not None:
            profiler.stop()
    recs = program_losses(out)
    first = win.open_at + 1
    window_epochs = list(range(first, win.close_at + 1))
    failed = sum(1 for e in window_epochs
                 if e not in recs or not math.isfinite(float(recs[e]["loss"])))
    stems = [os.path.splitext(os.path.basename(p))[0]
             for p in inp.style_paths]
    multi = cell.mix["entry"] == "multistyle"
    return {"window": win, "profiler": profiler, "attempted":
            len(window_epochs), "failed": failed,
            "readings": {"epoch_loss": epoch_losses(recs, (0, 1), stems),
                         "first_grad": _norms(win.first_grad),
                         "first_grad_t": win.first_grad,
                         "change": win.change,
                         "first_step": style_split(tap.values, cell.styles,
                                                   multi)}}


def style_split(values: Dict[str, torch.Tensor], styles: int, multi: bool
                ) -> Dict[str, torch.Tensor]:
    """{key} or, in a multi-style run, whose VGG batch is style-major,
    {key.s<k>}: each style's part of the first step's statistic."""
    if not multi:
        return values
    out = {}
    for k_, g in values.items():
        for s, part in enumerate(g.chunk(styles)):
            out[f"{k_}.s{s}"] = part
    return out


def reference_readings(cell: cells.Cell, inp, device,
                       fmt: str = "float64", half_batch: bool = False
                       ) -> dict:
    """The reference's readings, laid out as ``run_program``'s, in float64
    or in ``fmt`` (``reference/precision.py``)."""
    loss = cell.loss
    rcell = reference_cell(cell.flags, loss)
    multi = cell.mix["entry"] == "multistyle"
    out = {"epoch_loss": {}, "first_grad": {}, "first_grad_t": {},
           "change": {}, "first_step": {}}
    for k in range(cell.styles):
        r = follow(inp, inp.styles[k], rcell, loss, int(cell.flags["seed"]),
                   REFERENCE_STEPS, CHANGE_AFTER, device, fmt, half_batch)
        suffix = f".s{k}" if multi else ""
        for e, v in enumerate(r["epoch_loss"]):
            out["epoch_loss"][f"e{e}{suffix}"] = v
        for part in ("first_grad", "first_grad_t", "change", "first_step"):
            out[part].update({k_ + suffix: v for k_, v in r[part].items()})
    return out


def make_cell_inputs(cell: cells.Cell, seed: int, root: str, device):
    return make_inputs(os.path.join(root, "inputs"), seed,
                       int(cell.flags["size"]), cell.styles,
                       int(cell.config["scene"]["ico_level"]), device)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, log=print) -> dict:
    """One run of ``cell``; the result line's object (``compared`` last)."""
    reference_cell(cell.flags, cell.loss)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        t_inputs = time.perf_counter()
        inp = make_cell_inputs(cell, seed, workdir, device)
        t_port = time.perf_counter()
        prog = run_program(cell, seconds, trace, device, workdir, inp)
        win = prog["window"]
        setup_s = win.ends[win.open_at] - t_start
        log(f"set-up: {t_inputs - t_start:.3f} s to the inputs "
            f"(interpreter, imports), {t_port - t_inputs:.3f} s drawing and "
            f"writing them (the CUDA context first), "
            f"{win.first_step_at - t_port:.3f} s of the port's set-up to its "
            f"first step, {win.ends[win.open_at] - win.first_step_at:.3f} s "
            f"of warm-up epochs")
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        summary = None
        if prog["profiler"] is not None:
            summary = devtrace.summarize(prog["profiler"].events(),
                                         cells.layers(cell.root))
            prog["profiler"] = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = reference_readings(cell, inp, device)
        log(f"reference: {time.perf_counter() - t_ref:.2f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    checks = judge.compare(prog["readings"], ref, cell.limits, cell.loss)
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    correct = bool(ok and prog["failed"] == 0 and prog["attempted"] > 0)
    ctx = Context(cell=cell, setup_s=setup_s, epoch_s=win.epoch_s,
                  untraced_s=win.untraced_s, peak_bytes=int(peak),
                  trace=summary, work=work.summary(cell))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(cell.root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": prog["attempted"],
              "failed": prog["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
        log("layers (s in window): " + ", ".join(
            f"{k} {v}" for k, v in sorted(
                summary.device_s_by_layer.items(), key=lambda kv: -kv[1])))
        other = {k: v for k, v in summary.device_s_by_name.items()
                 if summary.layer_of[k] == "other"}
        log("other (no layer matched): " + "; ".join(
            f"{k[:100]} {v}" for k, v in sorted(
                other.items(), key=lambda kv: -kv[1])[:20]))
        log(f"trace: {summary.epochs} epochs, {summary.kernels} kernels, "
            f"{summary.syncs} syncs")
    else:
        es = win.epoch_s
        log(f"window: {len(es)} epochs, median "
            f"{statistics.median(es) * 1e3:.3f} ms, setup {setup_s:.3f} s")
    result["compared"] = checks
    return result
