"""CPU self-checks of the benchmark (not part of the repository's tier-1).

    python3 -m pytest benchmark_torch/tests -q -p no:cacheprovider

- the counts against the program's own FLOP count and PERF.md's kernel
  bounds;
- ``BENCHMARK.json`` against the benchmark contract's rules of form, and
  every cell's configuration, traffic, metrics and limits found by name;
- a new configuration, traffic kind, traffic mix and per-layer metric
  added as files and entries alone, with no edit to a file that is
  there;
- the generators: the same seed gives the same weights and inputs,
  another seed others;
- no module imports JAX or the JAX package, and the reference nothing of
  the program;
- ``run.py`` exits non-zero without a CUDA device;
- a run at a small size with the control (the reference in float8) in
  the program's place comes out not correct, and so does one with the
  timed path broken underneath (``faults.py``: half the batch left out,
  a tile altered where it is made, the model returning its input
  unchanged, a byte of the answer altered), while the unbroken run
  comes out correct.
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark_torch import faults  # noqa: E402
from benchmark_torch.counts import cunet as cunet_counts  # noqa: E402
from benchmark_torch.counts import kernels  # noqa: E402
from benchmark_torch.counts import swin_unet as swin_counts  # noqa: E402
from benchmark_torch.lib import harness, weights  # noqa: E402
from benchmark_torch.reference import tiling  # noqa: E402
from benchmark_torch.reference.render import fp8_round  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
PEAKS = json.loads((BENCH / "counts" / "peaks.json").read_text())[
    "cards"]["H100"]


def _config(name):
    return harness.load_cell(next(w["name"] for w in SPEC["workloads"]
                                  if w["config"] == name)).config


def _program_flops(config, frame_hw):
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
    from waifu2x_tensorrt_tpu_torch.models import registry

    module, spec = registry.create_model(
        config["family"], config["scale"], config["noise"],
        dtype=torch.bfloat16, fused_block=True, device="cpu")
    cfg = RenderConfig(precision=Precision(config["precision"]),
                       batch_size=config["batch"], height=config["tile"],
                       width=config["tile"], scaling=config["scale"],
                       overlap=(config["overlap"],) * 2)
    return ChunkedPipeline(module, spec, cfg, "cpu").flops_per_frame(
        frame_hw)


@pytest.mark.parametrize("config, frame_hw, per, want, digits", [
    ("swin_unet-art-4x-bf16", (720, 1280), "output MP", 42.72, 2),
    ("swin_unet-art-4x-bf16", (1080, 1920), "frame", 1400.0, 1),
    ("cunet-art-2x-bf16", (1080, 1920), "output MP", 592.48, 2),
])
def test_counts_match_the_programs_flop_count(config, frame_hw, per, want,
                                              digits):
    c = _config(config)
    counts = swin_counts if c["arch"] == "swin_unet" else cunet_counts
    p = tiling.plan(frame_hw, c["tile"], c["scale"],
                    36 if c["arch"] == "cunet" else 0, c["overlap"])
    ours = p.count * counts.flops_per_tile(c, c["tile"], c["tile"])
    assert ours == pytest.approx(_program_flops(c, frame_hw), rel=1e-9)
    scale = (p.out_hw[0] * p.out_hw[1] / 1e6) if per == "output MP" else 1
    assert round(ours / scale / 1e9, digits) == want


@pytest.mark.parametrize("case, want_ms", [
    (("B", 4096, 96, 3), 0.0456), (("B", 1024, 192, 6), 0.0423),
    (("C", (720, 1280)), 0.0425),
])
def test_kernel_bounds_match_perf_md(case, want_ms):
    if case[0] == "B":
        work = kernels.kernel_b(*case[1:])
    else:
        work = kernels.kernel_c(tiling.plan(case[1], 256, 4, 0, 1 / 16))
    assert round(kernels.bound_s(*work, PEAKS) * 1e3, 4) == want_ms


def test_kernel_b_launches_a_chunk():
    c = _config("swin_unet-art-4x-bf16")
    got = swin_counts.block_launches(c, 16, 256, 256)
    assert len(got) == 10
    assert sorted(set(got)) == [(1024, 192, 6), (4096, 96, 3)]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contracts_form():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["benchmark_torch"]
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"]) and len(SPEC["command"]) <= 32
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"]) and c["file"].startswith("benchmark_torch/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"] == []
        names.add(c["name"])
    assert {w["config"] for w in SPEC["workloads"]} == names
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert "roofline" not in m["name"] or (
            m["name"].endswith("_roofline") and m["unit"] == "%")
    for cell in CELLS:
        run = harness.load_cell(cell)
        reported = {m["name"] for m in run.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.per_layer
        for m in run.per_layer:
            assert m["moves"] in reported


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    run = harness.load_cell(cell)
    assert run.limits is not None
    assert set(run.limits) == {"mean_abs_lsb", "max_abs_lsb"}
    for name in ("Traffic", "warm", "drive", "chunk_sizes"):
        assert callable(getattr(run.kind, name))
    for m in run.end_to_end + run.per_layer:
        assert callable(harness.metric_module(m["name"]).read)
    arch = run.config["arch"]
    __import__(f"benchmark_torch.counts.{arch}")
    __import__(f"benchmark_torch.reference.{arch}")


@pytest.mark.parametrize("cell", CELLS)
def test_generators_follow_the_seed(cell):
    run = _small(cell)

    def draw(seed):
        p = weights.make_params(run.config, seed, "cpu")
        t = run.kind.Traffic(run.mix, seed, "cpu")
        keys = [t.next_item().key for _ in range(16)]
        return p, t.pictures, keys

    a, b, c = draw(2 ** 33 + 1), draw(2 ** 33 + 1), draw(2 ** 33 + 2)
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
    assert a[2] == b[2]
    assert not all(torch.equal(a[0][k], c[0][k]) for k in a[0])
    assert not any(np.array_equal(a[1][k], c[1][k]) for k in a[1])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_and_a_reference_of_its_own():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax",
                               "waifu2x_tensorrt_tpu"), (path, mod)
            if "reference" in path.parts:
                assert top in ("torch", "numpy", "math", "importlib",
                               "__future__", "dataclasses", "benchmark_torch")
                assert not mod.startswith("benchmark_torch.") or \
                    mod.startswith("benchmark_torch.reference"), (path, mod)


def test_run_exits_nonzero_without_a_cuda_device(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for root in (ROOT, tmp_path):
        if root == tmp_path:  # only BENCHMARK.json and the benchmark
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "benchmark_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
        proc = subprocess.run(
            [sys.executable, "benchmark_torch/run.py", "--workload",
             CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""


SINGLE_KIND = '''"""Traffic kind ``single``: one caller renders one frame at a time."""

import contextlib
import time

from benchmark_torch.lib.traffic import Item, stop
from benchmark_torch.lib.weights import generator, make_picture


class Traffic:
    def __init__(self, mix, seed, device):
        self.sizes = [tuple(s) for s in mix["sizes"]]
        g = generator(seed, 1, device)
        self.pictures = {(c, 0): make_picture(hw, g, device)
                         for c, hw in enumerate(self.sizes)}
        self._n = 0

    def next_item(self):
        c = self._n % len(self.sizes)
        self._n += 1
        return Item((c, 0), self.sizes[c])


def chunk_sizes(tiles, batch):
    return [n for t in tiles
            for n in [batch] * (t // batch) + ([t % batch] if t % batch else [])]


def warm(up, traffic, fetch, sync):
    for picture in traffic.pictures.values():
        up.render(picture)


def drive(up, traffic, sample, seconds, n_items=None,
          span=contextlib.nullcontext, fetch=None, sync=lambda: None):
    sent, done = [], []
    t0 = time.perf_counter()
    while not stop(t0, seconds, len(sent), n_items):
        item = traffic.next_item()
        sent.append(item)
        with span("bench.render"):
            out = up.render(traffic.pictures[item.key])
        done.append(item)
        sample.offer(item, out)
    return sent, done, time.perf_counter() - t0
'''


def test_a_cell_is_added_as_files_and_entries(tmp_path):
    """A new configuration, traffic kind, traffic mix and per-layer
    metric: new files and new entries in BENCHMARK.json, no edit to a
    file that is there."""
    shutil.copytree(BENCH, tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark_torch"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    conf = json.loads((b / "configs" / "cunet-art-2x-bf16.json").read_text())
    conf.update(name="cunet-art-2x-tiny", tile=128, batch=4)
    (b / "configs" / "cunet-art-2x-tiny.json").write_text(json.dumps(conf))
    (b / "traffic" / "single.py").write_text(SINGLE_KIND)
    (b / "traffic" / "tiny-single.json").write_text(json.dumps(
        {"kind": "single", "sizes": [[40, 56], [48, 40]], "trace_items": 2,
         "sample": 1}))
    (b / "metrics" / "frames_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.items))\n")
    (b / "limits" / "tiny.json").write_text(json.dumps(
        {"mean_abs_lsb": 1.5, "max_abs_lsb": 8.0}))
    spec["configs"].append({"name": "cunet-art-2x-tiny", "source": "x",
                            "file": "benchmark_torch/configs/"
                                    "cunet-art-2x-tiny.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny", "config": "cunet-art-2x-tiny",
                              "traffic": "tiny-single", "chips": 1,
                              "why": "x"})
    next(m for m in spec["end_to_end"]
         if m["name"] == "output_mp_s")["workloads"].append("tiny")
    spec["per_layer"].append({"name": "frames_done", "unit": "count",
                              "better": "higher", "source": "program_span",
                              "layer": "x", "moves": "output_mp_s",
                              "workloads": ["tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = textwrap.dedent("""
        import json, time
        from benchmark_torch.lib import harness
        run = harness.load_cell("tiny")
        r = harness.run_cell(run, 3, 0.2, True, time.perf_counter(), "cpu")
        print(json.dumps([[m["name"] for m in run.per_layer], r]))
    """)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names, result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["metrics"]["frames_done"]["value"] == 2.0
    # the per-layer metrics of output_mp_s without a cell list come along
    assert {"device_idle_pct", "mfu_pct", "kernel_c_roofline"} <= set(names)
    assert result["correct"] is True
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _small(cell):
    run = harness.load_cell(cell)
    run.config = dict(run.config, batch=4,
                      tile=64 if run.config["arch"] == "swin_unet" else 128)
    # 6 tiles a frame: every frame meets both halves of a chunk of 4
    run.mix = dict(run.mix, frame_hw=[100, 180], pool=2, warm_frames=1,
                   trace_items=3)
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    result = harness.run_cell(_small(cell), 5, 0.3, False,
                              time.perf_counter(), device="cpu",
                              control=fp8_round)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["missing"]["value"] == 0


@pytest.mark.parametrize("fault", ["none", *sorted(faults.FAULTS)])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault):
    with (faults.plant(fault) if fault != "none"
          else contextlib.nullcontext()):
        result = harness.run_cell(_small(cell), 2 ** 32 + 11, 0.3, False,
                                  time.perf_counter(), device="cpu")
    assert result["correct"] is (fault == "none"), result["checks"]
    assert list(result)[-1] == "checks"
