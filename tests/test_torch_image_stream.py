"""Cross-file image tile streaming of the port's CLI
(``cli._ImageStreamBatcher``) against the JAX package's, on the CPU.

The same fake engines drive both batchers: a lag-1 stream, a stream that
fails at its n-th submit, a stream that returns outputs two submits late
and two at a time. The port's fakes give torch tensors, as its stream
does; both batchers must write the same files, in the same order, with
the same messages and return codes: submission order with the stream's
lag, a flush at each geometry change, the per-image salvage of pending
images after a stream failure (the run still fails), and write failures
that consume their batch's outputs so later images keep their own pixels.
"""

import argparse

import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu import cli as jcli
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.io.image import read_image


class _Lag1Stream:
    """Each submit returns the PREVIOUS frame's output (255 - frame)."""

    def __init__(self, out, fail_on=None):
        self.q, self.n, self.out, self.fail_on = [], 0, out, fail_on

    def warm(self):
        return 0

    def submit(self, frame):
        self.n += 1
        if self.fail_on is not None and self.n >= self.fail_on:
            raise RuntimeError("boom")
        self.q.append(frame)
        return [self.out(255 - self.q.pop(0))] if len(self.q) > 1 else []

    def flush(self):
        outs = [self.out(255 - f) for f in self.q]
        self.q.clear()
        return outs


class _Lag2Stream(_Lag1Stream):
    """Returns outputs two submits late, two at a time."""

    def submit(self, frame):
        self.q.append(frame)
        if len(self.q) == 3:
            return [self.out(255 - self.q.pop(0)),
                    self.out(255 - self.q.pop(0))]
        return []


class _FakeEngine:
    can_stream = True

    def __init__(self, out, stream=_Lag1Stream, fail_on=None):
        self.out, self.stream, self.fail_on = out, stream, fail_on
        self.opened, self.rendered = [], 0

    def open_stream(self, hw):
        self.opened.append(hw)
        return self.stream(self.out, self.fail_on)

    def render(self, frame):
        self.rendered += 1
        return np.asarray(self.out(255 - frame))


def _port_out(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _drive(mod, out, tmp_path, steps, **engine_kw):
    """Run ``steps`` ((frame, output name) or "drain") through one batcher;
    returns (return codes, messages, engine, written images)."""
    engine = _FakeEngine(out, **engine_kw)
    msgs = []
    b = mod._ImageStreamBatcher(
        argparse.Namespace(crf=23, continue_on_error=False), engine,
        lambda s, m: msgs.append((int(s), m.replace(str(tmp_path), "T"))))
    rcs = [b.drain() if step == "drain" else b.submit(step[0],
                                                      tmp_path / step[1])
           for step in steps]
    written = {p.name: read_image(p) for p in sorted(tmp_path.glob("*.png"))}
    return rcs, msgs, engine, written


def _frames(n, hw=(8, 10), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), np.uint8) for _ in range(n)]


def _both(tmp_path, steps, **engine_kw):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    for name in ("jax", "port"):
        if (tmp_path / "blocker").exists():
            (tmp_path / name / "blocker").write_text("")
    want = _drive(jcli, np.asarray, tmp_path / "jax", steps, **engine_kw)
    got = _drive(cli, _port_out, tmp_path / "port", steps, **engine_kw)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        np.testing.assert_array_equal(got[3][k], want[3][k])
    assert got[2].opened == want[2].opened
    assert got[2].rendered == want[2].rendered
    return got


def test_writes_all_in_order_with_lag(tmp_path):
    imgs = _frames(3)
    rcs, msgs, engine, written = _both(
        tmp_path, [(f, f"o{i}.png") for i, f in enumerate(imgs)] + ["drain"])
    assert rcs == [0, 0, 0, 0]
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(written[f"o{i}.png"], 255 - img)
    assert engine.rendered == 0 and engine.opened == [(8, 10)]
    assert [m for _, m in msgs] == [f"Wrote T/o{i}.png" for i in range(3)]


def test_lag_leaves_the_last_output_pending(tmp_path):
    imgs = _frames(3)
    _, _, _, written = _both(
        tmp_path, [(f, f"o{i}.png") for i, f in enumerate(imgs)])
    assert sorted(written) == ["o0.png", "o1.png"]


def test_geometry_change_flushes_the_previous_run(tmp_path):
    a, c = _frames(1)[0], _frames(1, hw=(6, 6), seed=2)[0]
    rcs, _, engine, written = _both(
        tmp_path, [(a, "a.png"), (c, "c.png"), "drain"])
    assert rcs == [0, 0, 0]
    assert engine.opened == [(8, 10), (6, 6)]
    assert sorted(written) == ["a.png", "c.png"]


def test_stream_failure_salvages_pending_images(tmp_path):
    imgs = _frames(2, seed=3)
    rcs, msgs, engine, written = _both(
        tmp_path, [(imgs[0], "o0.png"), (imgs[1], "o1.png"), "drain"],
        fail_on=2)
    assert rcs == [0, -1, 0]  # the run fails; the batcher is reusable
    assert engine.rendered == 2
    for i in range(2):
        np.testing.assert_array_equal(written[f"o{i}.png"], 255 - imgs[i])
    assert any("Image stream failed" in m for s, m in msgs if s == 1)


def test_write_failure_keeps_outputs_aligned(tmp_path):
    """A failed write still consumes its batch's other outputs: a later
    drain must not write the next image's pixels to a dropped path."""
    (tmp_path / "blocker").write_text("")  # a FILE where a dir must go
    imgs = _frames(3, seed=5)
    rcs, msgs, engine, written = _both(
        tmp_path, [(imgs[0], "blocker/a.png"), (imgs[1], "b.png"),
                   (imgs[2], "c.png"), "drain"], stream=_Lag2Stream)
    assert rcs == [0, 0, -1, 0]
    np.testing.assert_array_equal(written["b.png"], 255 - imgs[1])
    np.testing.assert_array_equal(written["c.png"], 255 - imgs[2])
    assert engine.rendered == 0  # no salvage re-renders
    assert not any("fewer outputs" in m for _, m in msgs)


def test_write_failure_surfaces_at_drain(tmp_path):
    (tmp_path / "blocker").write_text("")
    rcs, msgs, _, _ = _both(
        tmp_path, [(_frames(1)[0], "blocker/o.png"), "drain"])
    assert rcs == [0, -1]
    assert any(s == 1 for s, _ in msgs)


def test_no_stream_renders_per_image(tmp_path):
    """An engine that cannot stream a geometry (rect TTA) renders the
    image alone."""
    img = _frames(1, seed=6)[0]
    engine = _FakeEngine(_port_out)
    engine.open_stream = lambda hw: None
    msgs = []
    b = cli._ImageStreamBatcher(
        argparse.Namespace(crf=23, continue_on_error=False), engine,
        lambda s, m: msgs.append(m))
    assert b.submit(img, tmp_path / "o.png") == 0
    assert engine.rendered == 1
    np.testing.assert_array_equal(read_image(tmp_path / "o.png"), 255 - img)


@pytest.mark.parametrize("make", [
    lambda a: a, lambda a: torch.from_numpy(a),
    lambda a: torch.from_numpy(a)[:, :5]])
def test_fetch_async_on_the_cpu_is_the_host_array(make):
    a = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    x = make(a)
    got = cli.fetch_async(x)
    assert got is x
    np.testing.assert_array_equal(np.asarray(got), np.asarray(x))
