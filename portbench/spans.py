"""The port's own spans (``st3d_torch/utils/trace.py``) in a run of a cell,
reduced by span: set-up by phase, host time, device time, kernels, host
syncs and the device's idle gaps.

    python3 portbench/spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

runs the cell as ``run.py`` does, with the port's spans on from before its
entry, prints ``run.py``'s result line, the reductions on standard error,
and last a JSON line ``{"spans": ...}``. (The harness does not turn the
spans on in its own runs; see ``PERF.md``, Open questions.)

Two sources:

* the in-memory log (``trace.records()``, on the harness's clock): the
  set-up's phases and kernel loads before the window opens, and the host
  time of each span over the untraced half of the window;
* the kineto events of the traced half (``--trace 1``). Each device event
  goes to its launch call by correlation id, then to the innermost host
  operator enclosing that call; if that operator is, or runs inside, a
  backward node, to the forward operator of the same ``(sequence_nr,
  fwd_thread_id)``; then to the innermost ``st3d.*`` span open at that
  operator's start (or at the launch, for forward work). Each sync call
  (``devtrace.SYNC_CALLS``) goes to the innermost span open at its start,
  each idle gap to the innermost span open at its middle, on any host
  thread; ``none`` where no span is open. The harness's own sync, the last
  sync call before each epoch mark after the first, is counted apart.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

PREFIX = "st3d."
NONE = "none"
HOST_PHASES = ("forward", "backward")


@dataclasses.dataclass
class Ev:
    """One event of a trace, reduced to what the attribution reads.
    ``kind``: ``op`` (a host operator), ``span`` (an ``st3d.*``
    annotation), ``mark`` (an epoch mark), ``call`` (a runtime or driver
    call) or ``device`` (a kernel, copy or set)."""

    kind: str
    name: str
    start: int
    end: int
    tid: int = 0
    corr: int = -1
    seq: int = -1
    fwd_tid: int = 0

    @property
    def backward(self) -> bool:
        return self.seq >= 0 and self.fwd_tid > 0


def normalize(events) -> List[Ev]:
    """Kineto events (``kineto_results.events()``) as ``Ev``s."""
    import torch

    from portbench import devtrace

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in events:
        kind = devtrace._kind(e, cuda)
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == cuda:
            if kind in devtrace.DEVICE_KINDS and "#" not in name:
                out.append(Ev("device", name, s, end,
                              corr=e.correlation_id()))
            continue
        tid = e.start_thread_id()
        if kind == "user_annotation":
            if name == devtrace.MARK:
                out.append(Ev("mark", name, s, end, tid))
            elif name.startswith(PREFIX):
                out.append(Ev("span", name, s, end, tid))
        elif kind in ("cuda_runtime", "cuda_driver"):
            out.append(Ev("call", name, s, end, tid,
                          corr=e.correlation_id()))
        elif kind == "cpu_op":
            out.append(Ev("op", name, s, end, tid, seq=e.sequence_nr(),
                          fwd_tid=e.fwd_thread_id()))
    return out


def _innermost(intervals: List[Ev], times: Sequence[int],
               track_backward: bool = False) -> List[Tuple[int, int]]:
    """For each time, ``(i, b)``: the index into ``intervals`` of the
    innermost interval open at it on the latest-starting thread (-1 if
    none), and of the innermost open backward node on that thread (-1).
    Intervals nest within a thread."""
    by_tid: Dict[int, List[int]] = collections.defaultdict(list)
    for i, ev in enumerate(intervals):
        by_tid[ev.tid].append(i)
    order = sorted(range(len(times)), key=lambda k: times[k])
    best = [(-1, -1)] * len(times)
    for idx in by_tid.values():
        idx.sort(key=lambda i: (intervals[i].start, -intervals[i].end))
        stack: List[Tuple[int, int]] = []
        p = 0
        for k in order:
            t = times[k]
            while p < len(idx) and intervals[idx[p]].start <= t:
                i = idx[p]
                while stack and intervals[stack[-1][0]].end < intervals[
                        i].start:
                    stack.pop()
                bw = i if (track_backward and intervals[i].backward) else (
                    stack[-1][1] if stack else -1)
                stack.append((i, bw))
                p += 1
            while stack and intervals[stack[-1][0]].end < t:
                stack.pop()
            if stack:
                cur = best[k][0]
                if cur < 0 or intervals[stack[-1][0]].start > intervals[
                        cur].start:
                    best[k] = stack[-1]
    return best


def _span_at(spans: List[Ev], times: Sequence[int]) -> List[str]:
    return [spans[i].name if i >= 0 else NONE
            for i, _ in _innermost(spans, times)]


@dataclasses.dataclass
class TraceSpans:
    """The traced half by span, per whole window (divide by ``epochs``)."""

    epochs: int
    device_s: Dict[str, float]
    syncs: Dict[str, int]
    sync_calls: Dict[str, int]
    harness_syncs: int
    step_syncs: int
    idle_s: Dict[str, float]
    kernels_by_span: Dict[str, Dict[str, float]]
    launches: Dict[str, int]

    def per_epoch(self) -> dict:
        e = max(self.epochs, 1)
        idle = sum(self.idle_s.values())
        return {
            "epochs": self.epochs,
            "device_ms": {k: 1e3 * v / e for k, v in self.device_s.items()},
            "launches": {k: v / e for k, v in self.launches.items()},
            "syncs": {k: v / e for k, v in self.syncs.items()},
            "sync_calls": {k: v / e for k, v in self.sync_calls.items()},
            "step_syncs": self.step_syncs / e,
            "idle_ms": {k: 1e3 * v / e for k, v in self.idle_s.items()},
            "idle_unattributed_share": (self.idle_s.get(NONE, 0.0) / idle
                                        if idle else 0.0)}


def reduce_trace(evs: List[Ev]) -> TraceSpans:
    """Device time, syncs and idle gaps of the window (first to last epoch
    mark) by the innermost ``st3d.*`` span."""
    from portbench import devtrace

    marks = sorted(e.start for e in evs if e.kind == "mark")
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} epoch marks")
    t0, t1 = marks[0], marks[-1]
    ops = [e for e in evs if e.kind == "op"]
    spans = [e for e in evs if e.kind == "span"]
    calls = {e.corr: e for e in evs if e.kind == "call" and e.corr >= 0}
    device = [e for e in evs if e.kind == "device" and e.end > t0
              and e.start < t1]

    # Forward operators by (sequence_nr, thread): the outermost one.
    forward: Dict[Tuple[int, int], int] = {}
    for e in ops:
        if e.seq >= 0 and not e.backward:
            key = (e.seq, e.tid)
            if key not in forward or e.start < forward[key]:
                forward[key] = e.start
    launch = [calls[d.corr].start if d.corr in calls else -1 for d in device]
    inner = _innermost(ops, launch, track_backward=True)
    at = []
    for d, t, (_, bw) in zip(device, launch, inner):
        if t < 0:
            at.append(-1)
        elif bw >= 0:
            b = ops[bw]
            at.append(forward.get((b.seq, b.fwd_tid), t))
        else:
            at.append(t)
    names = _span_at(spans, [max(t, 0) for t in at])
    device_s: Dict[str, float] = collections.defaultdict(float)
    kernels: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    launches: Dict[str, int] = collections.Counter()
    busy = []
    for d, t, name in zip(device, at, names):
        a, b = max(d.start, t0), min(d.end, t1)
        if b <= a:
            continue
        span = name if t >= 0 else NONE
        device_s[span] += (b - a) / 1e9
        launches[span] += not d.name.startswith(("Memcpy", "Memset"))
        kernels[span][d.name] += (b - a) / 1e9
        busy.append((a, b))

    # Syncs in the window; the harness's is the last to start before each
    # later mark, with the call that holds it (a driver call inside its
    # runtime call).
    syncs = sorted((e for e in evs if e.kind == "call"
                    and e.name in devtrace.SYNC_CALLS
                    and t0 <= e.start < t1), key=lambda e: e.start)
    harness = set()
    for m in marks[1:]:
        before = [i for i, s in enumerate(syncs) if s.start < m]
        if before:
            last = syncs[before[-1]]
            harness.update(i for i in before if syncs[i].start <= last.start
                           and last.end <= syncs[i].end)
    kept = [s for i, s in enumerate(syncs) if i not in harness]
    sync_names = _span_at(spans, [s.start for s in kept])
    by_span = collections.Counter(sync_names)
    calls_by = collections.Counter(f"{n} {s.name}"
                                   for n, s in zip(sync_names, kept))
    steps = [e for e in spans if e.name == PREFIX + "step"]
    step = sum(1 for i, _ in _innermost(steps, [s.start for s in kept])
               if i >= 0)

    gaps, prev = [], t0
    for a, b in devtrace._union(busy):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    idle: Dict[str, float] = collections.defaultdict(float)
    for (a, b), name in zip(gaps, _span_at(spans, [(a + b) // 2
                                                   for a, b in gaps])):
        idle[name] += (b - a) / 1e9
    return TraceSpans(epochs=len(marks) - 1, device_s=dict(device_s),
                      syncs=dict(by_span), sync_calls=dict(calls_by),
                      harness_syncs=len(harness), step_syncs=step,
                      idle_s=dict(idle),
                      kernels_by_span={k: dict(v) for k, v in
                                       kernels.items()},
                      launches=dict(launches))


def reduce_log(records, window_open_ns: int,
               bounds_ns: Optional[Tuple[int, int]] = None,
               epochs: int = 0) -> dict:
    """From ``trace.records()``: seconds of the set-up (the ``setup``
    spans at the top) and of each of its phases, the kernel loads before
    ``window_open_ns``, and, over ``bounds_ns`` (``epochs`` epochs), the
    host milliseconds an epoch of each span starting there."""
    setup_s = sum((b - a) / 1e9 for n, p, a, b in records
                  if n == "setup" and p < 0 and b)
    phases: Dict[str, float] = collections.defaultdict(float)
    for n, p, a, b in records:
        if b and (n.startswith("setup.") or (n == "kernels.load"
                                              and b <= window_open_ns)):
            phases[n] += (b - a) / 1e9
    host: Dict[str, float] = collections.defaultdict(float)
    if bounds_ns is not None and epochs:
        lo, hi = bounds_ns
        for n, p, a, b in records:
            if b and lo <= a < hi and not (p >= 0 and records[p][0] == n):
                host[n] += (b - a) / 1e6 / epochs
    return {"setup_s": setup_s, "setup_phases_s": dict(phases),
            "kernel_load_s": phases.get("kernels.load", 0.0),
            "host_ms": dict(host),
            "dispatch_host_ms": (sum(host.get(n, 0.0) for n in HOST_PHASES)
                                 if host else None)}


def _fmt(d: Dict[str, float], scale: float = 1.0, digits: int = 3) -> str:
    return ", ".join(f"{k} {v * scale:.{digits}f}" for k, v in sorted(
        d.items(), key=lambda kv: -kv[1]))


def run_with_spans(call):
    """``call()``, a run of a cell through ``harness.run_cell``, with the
    port's spans on from before its entry; returns its result and the
    report (``None`` if no window opened)."""
    from portbench import cells, devtrace, harness
    from st3d_torch.utils import trace

    seen: dict = {}
    summarize, window = devtrace.summarize, harness.Window

    def summarize_and_keep(events, layers):
        seen["trace"] = reduce_trace(normalize(events))
        return summarize(events, layers)

    class Window(window):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["window"] = self

    devtrace.summarize, harness.Window = summarize_and_keep, Window
    trace.enable()
    try:
        result = call()
    finally:
        trace.disable()
        devtrace.summarize, harness.Window = summarize, window
    win = seen.get("window")
    if win is None or win.open_at is None:
        return result, None
    last = win.close_at if win.untraced_to is None else win.untraced_to
    ns = lambda t: int(t * 1e9)  # noqa: E731
    report = {"log": reduce_log(trace.records(), ns(win.ends[win.open_at]),
                                (ns(win.ends[win.open_at]),
                                 ns(win.ends[last])), last - win.open_at),
              "counters": trace.counters(),
              "untraced_epoch_ms": 1e3 * sum(win.untraced_s)
              / max(len(win.untraced_s), 1)}
    t = seen.get("trace")
    if t is not None:
        report["trace"] = t.per_epoch()
        report["kernels_by_span_ms"] = {
            s: {k: 1e3 * v / max(t.epochs, 1) for k, v in sorted(
                ks.items(), key=lambda kv: -kv[1])[:12]}
            for s, ks in t.kernels_by_span.items()}
        report["vgg_against_patterns"] = reconcile(
            t.kernels_by_span, cells.layers(cells.ROOT),
            epochs=max(t.epochs, 1))
    return result, report


def reconcile(kernels_by_span: Dict[str, Dict[str, float]],
              layers: List[dict], span: str = PREFIX + "vgg",
              layer: str = "vgg", epochs: int = 1) -> dict:
    """Where ``span``'s device time and the name patterns of ``layer``
    (``portbench/layers/``) part: ms an epoch of the kernels in the span
    that the layer does not match, and of those the layer matches outside
    the span, by name."""
    from portbench import devtrace

    inside: Dict[str, float] = collections.defaultdict(float)
    outside: Dict[str, float] = collections.defaultdict(float)
    for s, ks in kernels_by_span.items():
        for name, sec in ks.items():
            matched = devtrace._layer(name, layers) == layer
            if s == span and not matched:
                inside[name] += 1e3 * sec / epochs
            elif s != span and matched:
                outside[f"{s}: {name}"] += 1e3 * sec / epochs
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:8])  # noqa
    return {"span_not_layer_ms": sum(inside.values()),
            "layer_not_span_ms": sum(outside.values()),
            "span_not_layer": top(inside), "layer_not_span": top(outside)}


def log_report(report: dict, log) -> None:
    """The report's lines: set-up by phase, then host ms, device ms, syncs
    and idle ms by span, an epoch."""
    r = report["log"]
    log(f"spans: set-up {r['setup_s']:.3f} s: {_fmt(r['setup_phases_s'])}")
    log(f"spans: host ms an epoch (untraced half, "
        f"{report['untraced_epoch_ms']:.3f} ms an epoch): "
        f"{_fmt(r['host_ms'])}")
    pe = report.get("trace")
    if pe is None:
        return
    log(f"spans: device ms an epoch: {_fmt(pe['device_ms'])}")
    log(f"spans: kernels an epoch: {_fmt(pe['launches'], digits=1)}")
    log(f"spans: syncs an epoch besides the harness's: "
        f"{_fmt(pe['sync_calls'], digits=2)}; inside st3d.step "
        f"{pe['step_syncs']:.2f}")
    log(f"spans: idle ms an epoch: {_fmt(pe['idle_ms'])}; with no span "
        f"open {pe['idle_unattributed_share']:.4f} of the idle time")
    v = report["vgg_against_patterns"]
    log(f"spans: st3d.vgg against layers/vgg.json, ms an epoch: "
        f"{v['span_not_layer_ms']:.3f} in the span unmatched "
        f"({_fmt(v['span_not_layer'])}); {v['layer_not_span_ms']:.3f} "
        f"matched outside it ({_fmt(v['layer_not_span'])})")


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    if os.path.abspath(sys.path[0]) == here:
        sys.path[0] = root
    elif root not in sys.path:
        sys.path.insert(0, root)
    from portbench import run

    run.T_START = T_START
    run._env()
    rc, report = run_with_spans(lambda: run.main(argv))
    if rc != 0 or report is None:
        return rc or 1
    log_report(report, lambda msg: print(msg, file=sys.stderr))
    print(json.dumps({"spans": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
