"""CPU self-checks of the HAT configuration's counts (not part of the
repository's tier-1).

    python3 -m pytest benchmark_torch/tests/test_hat.py -q -p no:cacheprovider

- ``counts/hat.py`` against the program's own FLOP count
  (``ChunkedPipeline.flops_per_frame``, kernel G counted through its
  plain twin on the meta device) at 720 x 480, and 50.72 MFLOP an input
  pixel;
- 42 kernel-G launches a chunk of 16 tiles, 4096 windows each;
- the kernel-G bounds PERF.md gives;
- the library FLOPs (the count without the attention products) and the
  `library_roofline` metric that divides them by the library group's time.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark_torch.counts import hat  # noqa: E402
from benchmark_torch.counts import kernels  # noqa: E402
from benchmark_torch.lib import harness  # noqa: E402
from benchmark_torch.reference import tiling  # noqa: E402

PEAKS = json.loads((BENCH / "counts" / "peaks.json").read_text())[
    "cards"]["H100"]
CONFIG = harness.load_cell("hat4x-480p-stream").config


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
    per_tile = hat.flops_per_tile(c, c["tile"], c["tile"])
    assert plan.count == 6
    assert plan.count * per_tile == pytest.approx(program, rel=1e-9)
    assert round(per_tile / c["tile"] ** 2 / 1e6, 2) == 50.72
    assert round(per_tile / 1e12, 3) == 3.324


def test_kernel_g_launches_a_chunk():
    got = hat.attention_launches(CONFIG, 16, 256, 256)
    assert len(got) == 42
    assert got.count((4096, "self")) == 36
    assert got.count((4096, "overlap")) == 6


@pytest.mark.parametrize("kind, gflop, flop_ms, bound_ms", [
    ("self", 193.3, 0.1954, 0.4507), ("overlap", 434.9, 0.4397, 0.4507),
])
def test_kernel_g_bounds_match_perf_md(kind, gflop, flop_ms, bound_ms):
    flops, nbytes = hat.kernel_g(4096, kind, CONFIG)
    assert round(flops / 1e9, 1) == gflop
    assert round(nbytes / 1e9, 2) == 1.51
    assert round(flops / PEAKS["bf16_flops"] * 1e3, 4) == flop_ms
    assert round(kernels.bound_s(flops, nbytes, PEAKS) * 1e3, 4) == bound_ms


def test_library_flops_are_the_count_without_attention():
    t = CONFIG["tile"]
    lib = hat.library_flops_per_tile(CONFIG, t, t)
    total = hat.flops_per_tile(CONFIG, t, t)
    attention = sum(hat.kernel_g(w, kind, CONFIG)[0]
                    for w, kind in hat.attention_launches(CONFIG, 1, t, t))
    assert lib + attention == total
    assert round(attention / total, 2) == 0.18


def test_library_roofline_reads_the_library_group():
    from types import SimpleNamespace

    from benchmark_torch.counts import swin_unet

    metric = harness.metric_module("library_roofline")
    t = CONFIG["tile"]
    lib = hat.library_flops_per_tile(CONFIG, t, t)
    ctx = SimpleNamespace(card={"peaks": PEAKS}, counts=hat, config=CONFIG,
                          plans=[SimpleNamespace(count=6)] * 2,
                          groups={"convs_gemms": 0.5, "other": 0.25})
    assert metric.read(ctx) == pytest.approx(
        100 * 12 * lib / (0.5 * PEAKS["bf16_flops"]))
    # nothing without a library time, or where the counts have no split
    assert metric.read(SimpleNamespace(**{**vars(ctx), "groups": {}})) is None
    assert metric.read(SimpleNamespace(**{**vars(ctx),
                                          "counts": swin_unet})) is None
