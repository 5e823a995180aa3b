"""The port's program spans (``utils/profiling.py``) on the CPU.

The identity ("nearest") model of ``tests/test_torch_render.py`` behind a
``TileStream`` at (223, 317), tile 64: 24 tiles a frame, batch 5, so every
frame's leftover tiles ride into the next frame's first chunk. Checked:
with no profiler session nothing is recorded and ``span`` is one shared
null context; under a CPU-only ``torch.profiler`` session the spans nest
(prepare, model and finalize under submit or flush), their counts follow
the carry arithmetic (replayed here on a list of row labels), every
``w2x.*`` event is a CPU event that is not a user annotation (so the
profiler does not copy it onto the device's timeline), stage spans on
CPU tensors record no event, ``ChunkedPipeline.render`` yields prepare,
model and finalize, and ``trace`` empties the record.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import (
    ChunkedPipeline,
    TileStream,
)
from waifu2x_tensorrt_tpu_torch.models import registry as treg
from waifu2x_tensorrt_tpu_torch.utils import profiling

HW, TILE, BATCH, N_FRAMES = (223, 317), 64, 5, 3


class NearestUp(torch.nn.Module):
    """Identity model: nearest-neighbour upsample of NHWC tiles."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        s = self.scale
        return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


def _pipeline():
    spec = treg.get_spec("swin_unet/art", 2, -1)
    cfg = RenderConfig(precision=Precision.TF32, batch_size=BATCH,
                       height=TILE, width=TILE, scaling=2,
                       overlap=(1 / 16, 1 / 16))
    return ChunkedPipeline(NearestUp(2), spec, cfg, "cpu")


def _frame():
    return np.random.default_rng(1).integers(0, 256, (*HW, 3), np.uint8)


def _stream(pl, frame):
    stream = TileStream(pl, HW)
    outs = []
    for _ in range(N_FRAMES):
        outs.extend(stream.submit(frame))
    outs.extend(stream.flush())
    return outs


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def traced():
    """(pipeline, outputs, record, the profiler's w2x.* events) of one
    traced 3-frame stream."""
    profiling.reset()
    pl = _pipeline()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = _stream(pl, _frame())
    record = profiling.records()
    profiling.reset()
    events = [e for e in prof.events() if e.name.startswith("w2x.")]
    return pl, outs, record, events


def test_no_profiler_records_nothing():
    pl = _pipeline()
    outs = _stream(pl, _frame())
    pl.render(_frame())
    assert len(outs) == N_FRAMES
    assert profiling.records() == [] and profiling.stage_seconds() == {}
    assert not profiling.active()
    first = profiling.span("submit")
    assert profiling.span("model", torch.device("cpu"), (0, 1), n=3) is first
    with first as counts:
        assert counts is None


def test_traced_outputs_are_the_untraced(traced):
    _pl, outs, _record, _events = traced
    want = np.repeat(np.repeat(_frame(), 2, 0), 2, 1)
    assert len(outs) == N_FRAMES
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)


def test_spans_nest_under_submit_and_flush(traced):
    _pl, _outs, record, events = traced
    names = [e.name for e in events]
    assert names.count("w2x.submit") == N_FRAMES
    assert names.count("w2x.flush") == 1
    assert names.count("w2x.prepare") == N_FRAMES
    assert names.count("w2x.finalize") == N_FRAMES
    for e in events:
        parent = e.cpu_parent.name if e.cpu_parent is not None else None
        if e.name in ("w2x.submit", "w2x.flush"):
            assert parent is None, e.name
        else:
            assert parent in ("w2x.submit", "w2x.flush"), (e.name, parent)
    assert [f"w2x.{s.name}" for s in record] == [e.name for e in events]


def test_counts_follow_the_carry(traced):
    """Rows labelled by their frame, run in chunks of BATCH: the spans'
    tiles, carried tiles, chunk rows and frames, ready outputs and the
    flush tail are those of the list."""
    _pl, _outs, record, _events = traced
    pl = _pipeline()
    n = pl.get(HW)[2].tile_count
    assert n == 24 and n % BATCH
    queue, expect = [], []
    finished = 0
    for f in range(N_FRAMES):
        carried = len(queue)
        queue += [f] * n
        chunks = []
        while len(queue) >= BATCH:
            chunks.append(queue[:BATCH])
            queue = queue[BATCH:]
        done = f + 1 if not queue or queue[0] > f else queue[0]
        expect.append(("submit", (f, f), {
            "tiles": n, "carried": carried, "chunks": len(chunks),
            "ready": done - finished}))
        expect.append(("prepare", (f - (carried > 0), f), {}))
        expect += [("model", (c[0], c[-1]),
                    {"n": BATCH, "program": "eager"}) for c in chunks]
        expect += [("finalize", (g, g), {"pieces": None})
                   for g in range(finished, done)]
        finished = done
    assert queue, "the flush must have a tail"
    expect.append(("flush", None, {"tail": len(queue)}))
    expect.append(("model", (queue[0], queue[-1]),
                   {"n": len(queue), "program": "eager"}))
    expect += [("finalize", (g, g), {"pieces": None})
               for g in range(finished, N_FRAMES)]
    got = [(s.name, s.frames,
            {k: (None if k == "pieces" else v) for k, v in s.counts.items()})
           for s in record]
    assert got == expect
    # a frame's finalize reads the pieces of every chunk its rows are in
    for s in record:
        if s.name == "finalize":
            f = s.frames[0]
            rows = range(f * n, (f + 1) * n)
            assert s.counts["pieces"] == len({r // BATCH for r in rows})


def test_program_spans_are_not_user_annotations(traced):
    """The profiler copies user annotations (``record_function``) onto the
    device's timeline; the program's spans must not be one."""
    _pl, _outs, _record, events = traced
    assert events
    for e in events:
        assert not e.is_user_annotation, e.name
        assert e.device_type == DeviceType.CPU, e.name
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.probe"):
            pass
    (probe,) = [e for e in prof.events() if e.name == "bench.probe"]
    assert probe.is_user_annotation


def test_stage_spans_on_cpu_tensors_record_no_event(traced):
    _pl, _outs, record, _events = traced
    assert {s.name for s in record} == {"submit", "prepare", "model",
                                        "finalize", "flush"}
    assert all(s.events is None for s in record)
    assert profiling.stage_seconds() == {}


def test_render_yields_prepare_model_and_finalize():
    pl = _pipeline()
    frame = _frame()
    with profile(activities=[ProfilerActivity.CPU]):
        out = pl.render(frame)
        pl.render(frame)
    np.testing.assert_array_equal(out.numpy(),
                                  np.repeat(np.repeat(frame, 2, 0), 2, 1))
    chunks = -(-24 // BATCH)
    per_frame = ["prepare"] + ["model"] * chunks + ["finalize"]
    record = profiling.records()
    assert [s.name for s in record] == per_frame * 2
    assert [s.frames for s in record] == [(0, 0)] * len(per_frame) + [
        (1, 1)] * len(per_frame)
    assert [s.counts["n"] for s in record if s.name == "model"] == [
        BATCH] * (chunks - 1) + [24 % BATCH] + [BATCH] * (chunks - 1) + [
        24 % BATCH]


def test_trace_empties_the_record(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        _stream(_pipeline(), _frame())
    assert profiling.records()
    with profiling.trace(str(tmp_path)):
        assert profiling.records() == []
        _pipeline().render(_frame())
        assert [s.name for s in profiling.records()][0] == "prepare"
    assert profiling.records() == []
    assert list(tmp_path.glob("*.pt.trace.json"))
