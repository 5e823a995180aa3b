"""Readings from which a cell's correctness limits are set, on the card.

    python3 benchmark_torch/control.py --workload NAME --seeds 1 2 ... \
        --control-seeds 101 102 103 [--faults half_batch ...] \
        [--seconds 2] [--out FILE]

Every reading is one run of the cell in this process
(``lib/harness.run_cell``: set-up, a short window of ``--seconds`` at the
cell's own load and sizes, the check of ``lib/check.py`` against the
cell's limits):

- ``--seeds``: the program as the run drives it; its largest readings
  are the limits' lower readings, and each has to read correct;
- ``--control-seeds``: the control, the plain reference computed with
  every product's operands rounded to float8 e4m3 (the precision below
  the configuration's bfloat16), put in the program's place on the
  window's sample; its smallest readings are the upper readings, and
  each has to read not correct;
- ``--faults``: each fault of ``faults.py`` planted in the timed path,
  on every control seed; each has to read not correct.

Prints one JSON line a run and a summary line last; ``--out`` appends
them to a file too. Exits 1 where a run reads otherwise than it has to.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark_torch import faults
    from benchmark_torch.lib import harness
    from benchmark_torch.reference.render import fp8_round

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    run = harness.load_cell(args.workload)
    runs = ([("program", None, s) for s in args.seeds]
            + [("control", None, s) for s in args.control_seeds]
            + [(f"fault:{f}", f, s) for f in args.faults
               for s in args.control_seeds])
    readings = {"program": [], "control": []}
    wrong = 0
    for side, fault, seed in runs:
        t0 = time.perf_counter()
        with faults.plant(fault) if fault else contextlib.nullcontext():
            result = harness.run_cell(
                run, seed, args.seconds, False, t0,
                control=fp8_round if side == "control" else None)
        got = {k: v["value"] for k, v in result["checks"].items()}
        readings.setdefault(side, []).append(got)
        wrong += result["correct"] is not (side == "program")
        line = json.dumps({"workload": run.name, "seed": seed, "side": side,
                           "correct": result["correct"], **got,
                           "run_s": time.perf_counter() - t0})
        _emit(line, args.out)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": run.name, "runs": len(runs), "wrong": wrong}
    for k in ("mean_abs_lsb", "max_abs_lsb"):
        if readings["program"]:
            summary[f"{k}_lower"] = max(p[k] for p in readings["program"])
        if readings["control"]:
            summary[f"{k}_upper"] = min(c[k] for c in readings["control"])
    _emit(json.dumps(summary), args.out)
    return 1 if wrong else 0


def _emit(line: str, out) -> None:
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
