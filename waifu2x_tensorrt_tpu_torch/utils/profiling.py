"""Tracing of the port: the CLI's ``--profile DIR`` session and the
program's own spans.

``trace(dir)`` is the port's counterpart of
``waifu2x_tensorrt_tpu.utils.profiling.trace`` (a ``jax.profiler`` trace
there): it records everything inside the context with ``torch.profiler``
(host ops, and the card's kernels and copies when CUDA is available) and
writes one TensorBoard-loadable Chrome trace (``*.pt.trace.json``) into
``dir`` when the context ends.

``span(name, device, frames, **counts)`` marks one step of the program.
Tracing is on exactly while a ``torch.profiler`` session is active (the
CLI's ``--profile``, or any caller's own session); with none active a
span is one check that returns a shared null context and records
nothing. While one is active a span:

- opens the host range ``w2x.<name>`` in the profiler's trace, with the
  counts (and ``frame_first`` / ``frame_last``) as its arguments. The
  range is a function-scope record, not a user annotation (unlike
  ``torch.profiler.record_function``), so the profiler does not copy it
  onto the device's timeline, where it would read as device work;
- for a stage span (one given the CUDA ``device`` its work is queued
  on), records a timing event on that device's current stream at entry
  and at exit, except while that stream is capturing a CUDA graph;
- appends a ``Span`` to the process's record: ``records()`` returns it,
  ``stage_seconds()`` sums the stages' device seconds, ``reset()``
  empties it. ``trace`` empties it on entry and on exit.

Spans sit at the call sites of the program's stages, never inside a
function that a ``CachedProgram`` captures.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

active = torch.autograd._profiler_enabled  # is a profiler session on?

_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """One span of the record: its name (without ``w2x.``), the frames its
    work belongs to (first, last) or None, its counts (a span that
    measures something while it runs adds it here), and the (start, end)
    CUDA events of a stage span on a CUDA stream, else None."""

    name: str
    frames: Optional[tuple[int, int]]
    counts: dict
    events: Optional[tuple[torch.cuda.Event, torch.cuda.Event]]


_record: list[Span] = []


class _Open:
    __slots__ = ("_range", "_stream", "_span")

    def __init__(self, name, device, frames, counts) -> None:
        args = dict(counts)
        if frames is not None:
            args["frame_first"], args["frame_last"] = frames
        self._range = _RecordFunctionFast(f"w2x.{name}", [], args)
        self._stream = None
        events = None
        if device is not None and device.type == "cuda":
            with torch.cuda.device(device):
                if not torch.cuda.is_current_stream_capturing():
                    self._stream = torch.cuda.current_stream(device)
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
        self._span = Span(name, frames, counts, events)

    def __enter__(self) -> dict:
        self._range.__enter__()
        if self._stream is not None:
            self._span.events[0].record(self._stream)
        _record.append(self._span)
        return self._span.counts

    def __exit__(self, *exc) -> None:
        if self._stream is not None:
            self._span.events[1].record(self._stream)
        self._range.__exit__(*exc)


def span(name: str, device: Optional[torch.device] = None,
         frames: Optional[tuple[int, int]] = None, **counts):
    """The span ``w2x.<name>`` (see the module docstring). Counts are
    ints, floats, bools or strings. Entering it gives its counts dict, or
    None when no profiler session is active."""
    if not active():
        return _NULL
    return _Open(name, device, frames, counts)


def records() -> list[Span]:
    """The spans recorded since the last ``reset``, in the order they
    were entered."""
    return list(_record)


def stage_seconds() -> dict[str, float]:
    """Device seconds of each stage summed over the record: between its
    two events on the stream, waiting for each end event."""
    out: dict[str, float] = {}
    for s in _record:
        if s.events is not None:
            start, end = s.events
            end.synchronize()
            out[s.name] = out.get(s.name, 0.0) + start.elapsed_time(end) / 1e3
    return out


def reset() -> None:
    """Empty the record."""
    _record.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace into ``log_dir`` (no-op when None),
    the program's spans with their counts included."""
    if not log_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    try:
        # record_shapes also writes the spans' counts into the trace
        with profile(activities=activities, record_shapes=True,
                     on_trace_ready=tensorboard_trace_handler(str(log_dir))):
            yield
    finally:
        reset()
