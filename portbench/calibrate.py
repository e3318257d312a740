"""The readings a cell's limits are set from (not run by the benchmark's own
runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--program] [--control] [--seconds 1] [--out DIR]

``--program``: the port on each seed, in one process (set-up paid once),
each through a short window as in a run, its readings judged against the
reference: the lower readings. ``--control``: the reference put in the
port's place, computed in the precision below the configuration's (TF32
for float32, fp8 for bfloat16; ``reference/precision.py``), and the
planted fault that leaves out half of each batch, the mean taken over the
rest; each judged against the full-precision reference: the upper
readings. A step that leaves the state unchanged reads 1 by
``change_gap`` and needs no run. One JSON line per seed and kind, also
appended to ``<out>/calibrate.jsonl`` (``build/portbench/`` by default).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "portbench"))
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"

    import torch

    from portbench import cells, harness, judge

    cell = cells.resolve(args.workload, ROOT)
    unlimited = judge.unlimited(cell.loss)
    dev = torch.device(args.device, 0) if args.device == "cuda" else (
        torch.device("cpu"))
    os.makedirs(args.out, exist_ok=True)
    sink = open(os.path.join(args.out, "calibrate.jsonl"), "a")

    def emit(kind, seed, values, extra=None):
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                           **{k: v["value"] for k, v in values.items()},
                           **(extra or {})})
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    for seed in [int(s) for s in args.seeds.split(",")]:
        work = tempfile.mkdtemp(prefix="portbench-cal-")
        try:
            inp = harness.make_cell_inputs(cell, seed, work, dev)
            ref = harness.reference_readings(cell, inp, dev)
            if args.program:
                t = time.perf_counter()
                prog = harness.run_program(cell, args.seconds, False, dev,
                                           work, inp)
                emit("program", seed,
                     judge.compare(prog["readings"], ref, unlimited,
                                   cell.loss),
                     {"failed": prog["failed"],
                      "seconds": time.perf_counter() - t})
            if args.control:
                fmt = CONTROL[cell.dtype]
                ctl = harness.reference_readings(cell, inp, dev, fmt)
                emit("control_" + fmt, seed,
                     judge.compare(ctl, ref, unlimited, cell.loss))
                half = harness.reference_readings(cell, inp, dev,
                                                  half_batch=True)
                emit("half_batch", seed,
                     judge.compare(half, ref, unlimited, cell.loss))
        finally:
            shutil.rmtree(work, ignore_errors=True)
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
