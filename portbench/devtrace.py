"""The traced window: ``torch.profiler`` (CPU and CUDA, CUPTI) around the
measured epochs, reduced to what the per-layer readers take.

The harness starts the profiler at the first epoch end past half of the
measured window, and marks every later epoch end with an empty
``portbench.epoch`` range after its synchronisation; the traced window runs
from the first mark, one epoch after the start, so the profiler's start-up
falls outside it, to the last. The reduction reads the raw kineto events
(``kineto_results.events()``), not the profiler's Python event tree, which
takes minutes at a window's millions of events:

* device activity (kernels, copies, sets) clipped to the window: time by
  name, by layer (``portbench/layers/*.json``, the first pattern match in
  their order; no match is ``other``), and the union of busy intervals;
* the kernels the device ran in the window, one launch each, and the CUDA
  runtime and driver calls starting there that synchronise the host
  (device, stream and event syncs, blocking copies);
* the device's idle gaps inside the window, each named by the innermost
  host range (an operator, a runtime call, an annotation) open at the
  gap's middle on any host thread, or ``host (python)`` where none is.

Device time by name is summed as ``st3d_torch.profile_step.kernel_ms`` sums
it: device events only, ``#``-numbered ranges left out.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

import torch

MARK = "portbench.epoch"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cuCtxSynchronize",
              "cuStreamSynchronize", "cuEventSynchronize", "cudaMemcpy",
              "cuMemcpyDtoH", "cuMemcpyDtoH_v2")


@dataclasses.dataclass
class Summary:
    epochs: int
    window_s: float
    busy_s: float
    device_s_by_name: Dict[str, float]
    device_s_by_layer: Dict[str, float]
    layer_of: Dict[str, str]
    kernels: int
    syncs: int
    idle_by_host: Dict[str, float]

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[f"{self.layer_of[k]}: {k[:120]}", v]
                               for k, v in ops[:n]],
                "idle_gaps": [[k[:120], v] for k, v in gaps[:n]]}


class Profiler:
    """``torch.profiler`` over CPU and CUDA, started and stopped by the
    harness's hook; ``mark`` records an epoch end."""

    def __init__(self, cuda: bool = True):
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CPU] + ([act.CUDA] if cuda else []))
        self.running = False

    def start(self) -> None:
        self.prof.start()
        self.running = True

    @staticmethod
    def mark() -> None:
        with torch.autograd.profiler.record_function(MARK):
            pass

    def stop(self) -> None:
        if self.running:
            self.prof.stop()
            self.running = False

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _kind(e, cuda) -> str:
    """The kineto activity of an event: ``activity_type()`` where the
    installed torch has it, else from the device, the annotation flag and
    the name (runtime and driver calls are named ``cuda*`` / ``cu*``)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    ann = getattr(e, "is_user_annotation", None)
    ann = bool(ann()) if callable(ann) else bool(ann)
    name = e.name()
    if e.device_type() == cuda:
        if ann or name == MARK:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if ann:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def _layer(name: str, layers: List[dict]) -> str:
    low = name.lower()
    for spec in layers:
        if any(p in low for p in spec["patterns"]):
            return spec["name"]
    return "other"


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _name_gaps(gaps: List[Tuple[int, int]], host: Dict[int, list],
               most: int = 300000) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host range open at
    each gap's middle (the latest-starting one over the threads); past the
    ``most`` longest gaps, the rest are summed as short gaps."""
    per: Dict[str, float] = {}
    index = {tid: ([e[0] for e in evs], evs) for tid, evs in host.items()}
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    if len(gaps) > most:
        rest = gaps[most:]
        per[f"short gaps (under {(rest[0][1] - rest[0][0]) / 1e3:.1f} us)"] \
            = sum(b - a for a, b in rest) / 1e9
        gaps = gaps[:most]
    for a, b in gaps:
        mid = (a + b) // 2
        best = None
        for starts, evs in index.values():
            i = bisect.bisect_right(starts, mid) - 1
            # Walk back to the innermost range still open at ``mid``.
            for j in range(i, max(i - 4000, -1), -1):
                s, e, name = evs[j]
                if e >= mid:
                    if best is None or s > best[0]:
                        best = (s, name)
                    break
        key = best[1] if best else "host (python)"
        per[key] = per.get(key, 0.0) + (b - a) / 1e9
    return per


def summarize(events, layers: List[dict]) -> Summary:
    """Reduce the raw events of a traced run to the window's summary."""
    marks = sorted(e.start_ns() for e in events
                   if e.name() == MARK and e.device_type()
                   != torch.autograd.DeviceType.CUDA)
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} epoch marks")
    t0, t1 = marks[0], marks[-1]
    by_name: Dict[str, float] = {}
    busy: List[Tuple[int, int]] = []
    host: Dict[int, list] = {}
    kernels = syncs = 0
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        kind = _kind(e, cuda)
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == cuda and kind in DEVICE_KINDS:
            if "#" in name:
                continue
            a, b = max(s, t0), min(end, t1)
            if b > a:
                by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
                busy.append((a, b))
                kernels += kind == "kernel"
        elif kind in HOST_KINDS:
            if kind in ("cuda_runtime", "cuda_driver") and t0 <= s < t1:
                syncs += name in SYNC_CALLS
            if end > t0 and s < t1 and name != MARK:
                host.setdefault(e.start_thread_id(), []).append(
                    (s, end, name))
    merged = _union(busy)
    busy_ns = sum(b - a for a, b in merged)
    gaps, prev = [], t0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    for evs in host.values():
        evs.sort(key=lambda x: (x[0], -x[1]))
    layer_of = {n: _layer(n, layers) for n in by_name}
    by_layer: Dict[str, float] = {}
    for n, v in by_name.items():
        by_layer[layer_of[n]] = by_layer.get(layer_of[n], 0.0) + v
    return Summary(epochs=len(marks) - 1, window_s=(t1 - t0) / 1e9,
                   busy_s=busy_ns / 1e9, device_s_by_name=by_name,
                   device_s_by_layer=by_layer, layer_of=layer_of,
                   kernels=kernels, syncs=syncs,
                   idle_by_host=_name_gaps(gaps, host))
