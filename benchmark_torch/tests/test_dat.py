"""CPU self-checks of the DAT configuration's counts and of kernel J's
roofline metric (not part of the repository's tier-1).

    python3 -m pytest benchmark_torch/tests/test_dat.py -q -p no:cacheprovider

- ``counts/dat.py`` against the program's own FLOP count
  (``ChunkedPipeline.flops_per_frame``, kernels G and J counted through
  their plain twins on the meta device) at 720 x 480: 2.186 TFLOP a tile
  of 256;
- 18 kernel-G launches and 18 kernel-J calls a chunk of 16 tiles;
- the kernel-G and kernel-J bounds PERF.md gives;
- the library FLOPs (the count without the attention products);
- ``kernel_j_roofline``: the plan's bound over the three kernels' time,
  and nothing where the trace's calls differ from the plan or the
  configuration has no kernel-J plan.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark_torch.counts import dat  # noqa: E402
from benchmark_torch.counts import hat  # noqa: E402
from benchmark_torch.counts import kernels  # noqa: E402
from benchmark_torch.lib import harness  # noqa: E402
from benchmark_torch.reference import tiling  # noqa: E402

PEAKS = json.loads((BENCH / "counts" / "peaks.json").read_text())[
    "cards"]["H100"]
CONFIG = harness.load_cell("dat4x-480p-stream").config


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
    per_tile = dat.flops_per_tile(c, c["tile"], c["tile"])
    assert plan.count == 6
    assert plan.count * per_tile == pytest.approx(program, rel=1e-9)
    assert round(per_tile / 1e12, 3) == 2.186
    assert round(per_tile / c["tile"] ** 2 / 1e6, 2) == 33.36


def test_launches_a_chunk():
    assert dat.attention_launches(CONFIG, 16, 256, 256) == [(4096,
                                                              "rect")] * 18
    assert dat.channel_launches(CONFIG, 16, 256, 256) == [1048576] * 18


def test_kernel_bounds_match_perf_md():
    g_flops, g_bytes = dat.kernel_g(4096, "rect", CONFIG)
    j_flops, j_bytes = dat.kernel_j(1048576, CONFIG)
    assert round(g_flops / 1e9, 1) == 193.3
    assert round(j_flops / 1e9, 1) == 22.6
    assert round(g_bytes / 1e9, 2) == round(j_bytes / 1e9, 2) == 1.51
    for work in ((g_flops, g_bytes), (j_flops, j_bytes)):
        assert round(kernels.bound_s(*work, PEAKS) * 1e3, 4) == 0.4507


def test_library_flops_are_the_count_without_attention():
    t = CONFIG["tile"]
    lib = dat.library_flops_per_tile(CONFIG, t, t)
    total = dat.flops_per_tile(CONFIG, t, t)
    attention = (sum(dat.kernel_g(w, k, CONFIG)[0]
                     for w, k in dat.attention_launches(CONFIG, 1, t, t))
                 + sum(dat.kernel_j(n, CONFIG)[0]
                       for n in dat.channel_launches(CONFIG, 1, t, t)))
    assert lib + attention == total
    assert round(attention / total, 3) == 0.111


def _ctx(events, chunks=(16, 16), counts=dat):
    notes = []
    return SimpleNamespace(card={"peaks": PEAKS}, counts=counts,
                           config=CONFIG, chunk_sizes=list(chunks),
                           device_events=events, note=notes.append), notes


def test_kernel_j_roofline_reads_the_plan():
    metric = harness.metric_module("kernel_j_roofline")
    names = ["w2x::dat::channel_attention_stats_kernel(...)",
             "w2x::dat::channel_attention_softmax_kernel(...)",
             "w2x::dat::channel_attention_apply_kernel(...)"]
    # 36 calls, 1.5 ms each (0.8 + 0.02 + 0.68), in microseconds
    events = [(n, 0.0, us) for _ in range(36)
              for n, us in zip(names, (800.0, 20.0, 680.0))]
    events.append(("sm90_xmma_gemm", 0.0, 5000.0))
    ctx, notes = _ctx(events)
    bound = 36 * kernels.bound_s(*dat.kernel_j(1048576, CONFIG), PEAKS)
    assert metric.read(ctx) == pytest.approx(100 * bound / (36 * 1.5e-3))
    assert notes == []
    # a call missing from the trace: nothing, and the run says why
    ctx, notes = _ctx(events[3:])
    assert metric.read(ctx) is None and "35 kernel J calls" in notes[0]
    # no kernel-J plan (HAT) or no kernel-J event: nothing
    assert metric.read(_ctx(events, counts=hat)[0]) is None
    assert metric.read(_ctx(events[-1:])[0]) is None
