"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; ``harness.run_cell`` draws the inputs from ``--seed``, drives
the port (``st3d_torch``) through its warm-up and a window of ``--seconds``,
and judges its readings against the plain reference. With ``--trace 0`` the
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones: the window's first half runs untraced and gives the epoch's length,
``torch.profiler`` covers the second half and gives the device's time.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and ``compared``, each
number compared with the reference beside its limit; the last lines of
standard error give the same numbers. Without a CUDA device, with fewer
devices than the cell asks for, or with ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``st3d`` in ``sys.modules`` once the window has closed, it
prints no result and exits with a code other than 0.

Build and kernel caches stay inside the checkout (``build/``, where
``st3d_torch`` builds its kernels too); inputs and the port's outputs go to
a temporary directory under ``$TMPDIR``, removed at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BANNED = ("jax", "jaxlib", "flax", "st3d")


def banned_modules():
    """Top-level names of ``sys.modules`` that are JAX or the JAX
    package, compared whole (``st3d_torch`` is not ``st3d``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _finite(obj):
    """JSON-safe: a non-finite float becomes 1e300."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def _env() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through
    ``transformers``; one host thread for CPU ops, so that the run loads
    its host as little as it can."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    build = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()

    import torch

    from portbench import cells, harness

    torch.set_num_threads(1)
    cell = cells.resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, log)
    found = banned_modules()
    if found:
        print(f"portbench: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(_finite(result)), flush=True)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
