"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything specific to a configuration, a traffic mix or a metric is
found by name: ``BENCHMARK.json`` names the cell's configuration (its
file, ``configs/<config>.json``) and its traffic (``traffic/<mix>.json``,
generated and driven by the module of its kind, ``traffic/<kind>.py``,
``lib/traffic.py``); each metric is ``metrics/<name>.py``
(``read(ctx)``, None where it finds nothing to read); the correctness
limits of a cell are ``limits/<workload>.json``; the counts of an
architecture are ``counts/<arch>.py`` and its plain reference
``reference/<arch>.py``.

The program is reached only through ``waifu2x_tensorrt_tpu_torch``'s
entry points: ``Upscaler`` (``load`` of a weight file, ``open_stream``,
``render``) and ``engine.upscaler.fetch_async``.
"""

from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark_torch.lib import check, trace, traffic, weights

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_cell(workload: str, bench: dict | None = None) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, metrics and limits."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
                     .read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])

    # a per-layer metric without a cell list is read in every cell that
    # reports the end-to-end metric it moves
    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    limits_file = BENCH_DIR / "limits" / f"{workload}.json"
    return SimpleNamespace(
        name=workload, cell=cell, config=config, mix=mix,
        kind=traffic.kind(mix),
        end_to_end=end_to_end,
        per_layer=[m for m in bench["per_layer"]
                   if workload in m.get("workloads", ())
                   or ("workloads" not in m and m["moves"] in reported)],
        limits=(json.loads(limits_file.read_text())
                if limits_file.exists() else None))


def metric_module(name: str):
    """``metrics/<q>.py`` reads the metric ``q`` and its variants
    ``q.<cells>``, one quantity split by the end-to-end metric it moves."""
    return importlib.import_module(
        f"benchmark_torch.metrics.{name.split('.')[0]}")


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": None, "peaks": None}
    kind = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "unknown"
    table = json.loads((BENCH_DIR / "counts" / "peaks.json").read_text())
    peaks = next((v for k, v in table["cards"].items() if k in kind), None)
    return {"kind": kind, "power_limit": smi or "unknown", "peaks": peaks}


def _load_program(run, device, models_dir):
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    c = run.config
    up = Upscaler(models_dir=models_dir, device=str(device))
    cfg = RenderConfig(precision=Precision(c["precision"]),
                       batch_size=c["batch"], height=c["tile"],
                       width=c["tile"], scaling=c["scale"],
                       overlap=(c["overlap"], c["overlap"]))
    up.load(c["family"], c["scale"], c["noise"], cfg)
    return up


def run_cell(run: SimpleNamespace, seed: int, seconds: float, trace_on: bool,
             t_start: float, device="cuda", control=None) -> dict:
    """One run; returns the result line (a dict). ``control``
    (``reference.render.fp8_round``): the check holds the reference in
    that precision, put in the program's place, against the float32
    reference, on the same sample of the window's items
    (``control.py``)."""
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import fetch_async

    steps = [("python imports", time.perf_counter())]
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)

        def sync():
            torch.cuda.synchronize(device)
    else:
        def sync():
            return None
    torch.zeros(1, device=device)
    steps.append(("CUDA context", time.perf_counter()))
    params = weights.make_params(run.config, seed, device)
    mix_traffic = run.kind.Traffic(run.mix, seed, device)
    steps.append(("seeded weights and inputs", time.perf_counter()))
    with tempfile.TemporaryDirectory(prefix="w2x-bench-") as models_dir:
        weights.write_weight_file(Path(models_dir), run.config, params)
        up = _load_program(run, device, models_dir)
    steps.append(("weight file and Upscaler.load", time.perf_counter()))
    run.kind.warm(up, mix_traffic, fetch_async, sync)
    sync()
    steps.append(("warm-up: kernel library, captures, first replays",
                  time.perf_counter()))
    marks = [t_start] + [t for _, t in steps]
    note("setup_s by step: " + "; ".join(
        f"{name} {b - a:.3f} s" for (name, _), a, b
        in zip(steps, marks, marks[1:])))
    sample = traffic.Sample(run.mix["sample"], seed)
    drive = run.kind.drive
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace_on:
        prof = trace.start(device)
        with torch.profiler.record_function("bench.window"):
            sent, done, window_s = drive(
                up, mix_traffic, sample, seconds,
                n_items=run.mix["trace_items"],
                span=torch.profiler.record_function, fetch=fetch_async,
                sync=sync)
        prof.stop()
    else:
        sent, done, window_s = drive(up, mix_traffic, sample, seconds,
                                     fetch=fetch_async, sync=sync)
    card = _card(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    ctx = SimpleNamespace(
        config=run.config, mix=run.mix, card=card, seed=seed,
        setup_s=setup_s, window_s=window_s, items=done,
        attempted=len(sent), kind=run.kind, counts=importlib.import_module(
            f"benchmark_torch.counts.{run.config['arch']}"),
        note=note)
    trace.describe_work(ctx)
    if prof is not None:
        trace.reduce(prof, ctx)
    metrics = {}
    for m in (run.per_layer if trace_on else run.end_to_end):
        value = metric_module(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    shares = {k: v["value"] for k, v in metrics.items() if v["unit"] == "%"}
    if shares:
        note(f"shares of peak and roofline on {card['kind']}, power limit "
             f"{card['power_limit']}: {shares}")
    del up, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = check.compare(run, ctx, mix_traffic, sample, params,
                                    device, control)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": card["kind"], "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    if trace_on:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.trace_window_s
    result = {"correct": correct, "attempted": len(sent),
              "failed": len(sent) - len(done), "metrics": metrics,
              "device": dev}
    if trace_on:
        result["breakdown"] = ctx.breakdown
    result["checks"] = checks
    return result
