"""Named spans and counters inside the port, off by default.

``span("render")`` marks a stretch of the port's own work: with tracing
on it opens ``torch.profiler.record_function("st3d.render")``, so a running
``torch.profiler`` holds the span on the clock of the device's kernels, and
keeps ``(name, parent, start_ns, end_ns)`` in memory on
``time.perf_counter_ns()``'s clock (``parent`` is the index of the
enclosing span of the same thread, -1 at the top). ``enable()`` takes one
anchor pair ``(perf_counter_ns, time_ns)``, so every record also converts
to the profiler's Unix-ns clock (``to_unix``, ``write``). Spans close on
exceptions. Off, ``span()`` returns one shared null context after one flag
check and ``count()`` returns at once: nothing is allocated.

``device_counts(names, device)`` gives, while tracing is on, an int64
tensor on the device that the port's kernels add counters to with no
sync; ``counters()`` reads it (one sync, at read time).

The kernel counters are read from ``kernels/build.py`` itself:
``kernels.loaded`` is the number of libraries loaded (``_LIBS``),
``kernels.built`` the number nvcc built in this process
(``BUILD_SECONDS``). The pipelines count ``steps`` and ``epochs``.

``--profile`` turns tracing on for its run and writes ``write``'s JSON to
``output_path/profile/spans.json``; ``portbench/spans.py`` turns it on in a
run of a benchmark cell.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "st3d."

_on = False
_NULL = contextlib.nullcontext()
_records: List[list] = []
_counts: Dict[str, int] = {}
_device_counts: Dict[Tuple[Tuple[str, ...], str], torch.Tensor] = {}
_anchor = (0, 0)
_lock = threading.Lock()
_local = threading.local()


def enable() -> None:
    """Turn tracing on with fresh records and a new clock anchor (a no-op
    when it is on)."""
    global _on, _anchor
    if _on:
        return
    _records.clear()
    _counts.clear()
    _device_counts.clear()
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable() -> None:
    """Turn tracing off; the records stay readable until the next
    ``enable``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.rec = rec = [self.name, stack[-1] if stack else -1, 0, 0]
        with _lock:
            stack.append(len(_records))
            _records.append(rec)
        rec[2] = time.perf_counter_ns()
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec[3] = time.perf_counter_ns()
        _local.stack.pop()
        return False


def span(name: str):
    """A context manager that records ``st3d.<name>`` while tracing is
    on; the shared null context otherwise."""
    if not _on:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def device_counts(names: Tuple[str, ...], device) -> Optional[torch.Tensor]:
    """While tracing is on, the int64 tensor (len(names),) on ``device``
    that holds the counters ``names``, for a kernel to add to on the device
    (zeros at its first request after ``enable``); None while off."""
    if not _on:
        return None
    key = (tuple(names), str(device))
    with _lock:
        t = _device_counts.get(key)
        if t is None:
            t = _device_counts[key] = torch.zeros(len(names),
                                                  dtype=torch.int64,
                                                  device=device)
    return t


def counters() -> Dict[str, int]:
    """The counters, the device's read here, with the kernel libraries
    loaded and built."""
    from st3d_torch.kernels import build

    out = dict(_counts)
    for (names, _), t in _device_counts.items():
        for name, v in zip(names, t.tolist()):
            out[name] = out.get(name, 0) + int(v)
    return {**out, "kernels.loaded": len(build._LIBS),
            "kernels.built": len(build.BUILD_SECONDS)}


def records() -> List[Tuple[str, int, int, int]]:
    """Every span since ``enable``: (name without the prefix, parent index
    or -1, start, end) in ``perf_counter_ns``; end 0 while open."""
    return [tuple(r) for r in _records]


def to_unix(ns: int) -> int:
    """A ``perf_counter_ns`` stamp on the Unix-ns clock of the profiler."""
    return ns - _anchor[0] + _anchor[1]


def write(path: str) -> None:
    """Every record and counter as JSON, stamped in Unix ns."""
    spans = [{"name": PREFIX + n, "parent": p, "start_ns": to_unix(a),
              "end_ns": to_unix(b) if b else None}
             for n, p, a, b in records()]
    with open(path, "w") as f:
        json.dump({"anchor": {"perf_counter_ns": _anchor[0],
                              "unix_ns": _anchor[1]},
                   "counters": counters(), "spans": spans}, f, indent=1)
