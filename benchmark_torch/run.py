"""Run one benchmark cell once and print its result line.

    python3 benchmark_torch/run.py --workload NAME --seed N --seconds S \
        --trace 0|1

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic
and metrics are found by name, ``lib/harness.py``), sets the program up
with weights and inputs made from ``--seed``, warms every shape the
window meets, measures for ``--seconds`` (``--trace 1``: profiles the
traffic's fixed ``trace_items`` frames or stills instead), checks the
outputs against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device`` (``--trace 1``: with ``busy_s`` and
``window_s``), ``breakdown`` (``--trace 1``) and ``checks`` (each number
compared, with its limit). Needs as many CUDA devices as the cell asks
for; exits 2 without them, or without the program beside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark_torch.lib import harness

    run = harness.load_cell(args.workload)
    import torch

    chips = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        import waifu2x_tensorrt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(run, args.seed, args.seconds,
                              bool(args.trace), T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
