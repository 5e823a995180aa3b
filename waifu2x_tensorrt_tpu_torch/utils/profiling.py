"""Tracing hook of the CLI's ``--profile DIR``: the port's counterpart of
``waifu2x_tensorrt_tpu.utils.profiling.trace`` (a ``jax.profiler`` trace
there). ``trace(dir)`` records everything inside the context with
``torch.profiler`` (host ops, and the card's kernels and copies when CUDA
is available) and writes one TensorBoard-loadable Chrome trace
(``*.pt.trace.json``) into ``dir`` when the context ends.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace into ``log_dir`` (no-op when None)."""
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
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
