"""CPU self-checks of the MambaIR configuration's counts, its plain
reference's parameters and kernel K's metrics (not part of the
repository's tier-1).

    python3 -m pytest benchmark_torch/tests/test_mambair.py -q -p no:cacheprovider

- the configuration found by its cell's name, every published width of
  ``test_MambaIR_SR_x4.yml`` and nothing reduced;
- ``reference/mambair.param_shapes`` against the program's state dict
  (through ``convert.mambair_mapping``) at the published widths;
- ``counts/mambair.py`` against the program's own FLOP count
  (``ChunkedPipeline.flops_per_frame`` on the meta device, the scan left
  out there) at 720 x 480: 2.531 TFLOP of library work a tile of 256,
  and the scan's FLOPs beside it;
- 36 kernel-K calls a chunk of 16 tiles and the bound PERF.md gives;
- ``kernel_k_roofline``: the plan's bound over the scan's and combine's
  time, and nothing where the trace's calls differ from the plan or the
  configuration has no kernel-K plan; ``scan_ms_per_mp``.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark_torch.counts import dat  # noqa: E402
from benchmark_torch.counts import mambair  # noqa: E402
from benchmark_torch.lib import harness  # noqa: E402
from benchmark_torch.reference import mambair as ref  # noqa: E402
from benchmark_torch.reference import tiling  # noqa: E402

PEAKS = json.loads((BENCH / "counts" / "peaks.json").read_text())[
    "cards"]["H100"]
CELL = harness.load_cell("mambair4x-480p-stream")
CONFIG = CELL.config


def test_the_cell_runs_the_published_widths():
    c = CONFIG
    assert (c["arch"], c["family"], c["reduced"]) == ("mambair",
                                                      "mambair/photo", [])
    assert (c["embed_dim"], c["depths"], c["d_state"], c["mlp_ratio"],
            c["d_conv"], c["compress_ratio"], c["squeeze_factor"],
            c["num_feat"]) == (180, [6] * 6, 16, 2, 3, 3, 30, 64)
    assert CELL.cell["traffic"] == "stream-480p"
    assert {m["name"] for m in CELL.per_layer} >= {"kernel_k_roofline",
                                                    "scan_ms_per_mp",
                                                    "mfu_pct"}
    assert "library_roofline" not in {m["name"] for m in CELL.per_layer}
    n = sum(math.prod(s) for s in ref.param_shapes(c).values())
    assert round(n / 1e6, 2) == 20.57


def test_param_shapes_are_the_programs_state():
    from waifu2x_tensorrt_tpu_torch.models import registry

    module, _ = registry.create_model("mambair/photo", 4, -1,
                                      device="meta")
    assert registry._flax_leaves(module) == ref.param_shapes(CONFIG)


def test_counts_match_the_programs_flop_count():
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
    from waifu2x_tensorrt_tpu_torch.models import registry

    c = CONFIG
    module, spec = registry.create_model(c["family"], c["scale"], c["noise"],
                                         dtype=torch.bfloat16, device="cpu")
    cfg = RenderConfig(precision=Precision(c["precision"]),
                       batch_size=c["batch"], height=c["tile"],
                       width=c["tile"], scaling=c["scale"],
                       overlap=(c["overlap"],) * 2)
    program = ChunkedPipeline(module, spec, cfg, "cpu").flops_per_frame(
        (480, 720))
    plan = tiling.plan((480, 720), c["tile"], c["scale"], 0, c["overlap"])
    t = c["tile"]
    library = mambair.library_flops_per_tile(c, t, t)
    scan = mambair.scan_flops_per_tile(c, t, t)
    assert plan.count * library == pytest.approx(program, rel=1e-9)
    assert mambair.flops_per_tile(c, t, t) == library + scan
    assert round(library / 1e12, 3) == 2.531
    assert round(scan / 1e12, 3) == 0.408


def test_launches_and_bound_a_chunk():
    assert mambair.scan_launches(CONFIG, 16, 256, 256) == [1048576] * 36
    nbytes, compute_s = mambair.kernel_k(1048576, CONFIG)
    assert round(nbytes / 1e9, 3) == 1.879
    assert round(mambair.bound_s(1048576, CONFIG, PEAKS) * 1e3,
                 4) == 2.8886
    assert compute_s > nbytes / PEAKS["hbm_bytes_s"]   # bound by updates


def _ctx(events, chunks=(16, 16), counts=mambair):
    notes = []
    return SimpleNamespace(card={"peaks": PEAKS}, counts=counts,
                           config=CONFIG, chunk_sizes=list(chunks),
                           device_events=events, note=notes.append,
                           out_mp=44.24), notes


def test_kernel_k_roofline_and_scan_ms_read_the_plan():
    metric = harness.metric_module("kernel_k_roofline")
    per_mp = harness.metric_module("scan_ms_per_mp")
    names = ["w2x::scan::(anonymous namespace)::selective_scan_kernel(...)",
             "w2x::scan::(anonymous namespace)::selective_scan_combine(...)"]
    # 72 calls, 8 ms each (7.5 + 0.5), in microseconds
    events = [(n, 0.0, us) for _ in range(72)
              for n, us in zip(names, (7500.0, 500.0))]
    events.append(("sm90_xmma_gemm", 0.0, 5000.0))
    ctx, notes = _ctx(events)
    bound = 72 * mambair.bound_s(1048576, CONFIG, PEAKS)
    assert metric.read(ctx) == pytest.approx(100 * bound / (72 * 8e-3))
    assert notes == []
    assert per_mp.read(ctx) == pytest.approx(72 * 8.0 / 44.24)
    # a call missing from the trace: nothing, and the run says why
    ctx, notes = _ctx(events[2:])
    assert metric.read(ctx) is None and "71 kernel K calls" in notes[0]
    # no kernel-K plan (DAT) or no kernel-K event: nothing
    assert metric.read(_ctx(events, counts=dat)[0]) is None
    assert metric.read(_ctx(events[-1:])[0]) is None
    assert per_mp.read(_ctx(events[-1:])[0]) is None
