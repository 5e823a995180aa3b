"""Timing helpers (reference src/utilities/time.h:7-11)."""

from __future__ import annotations

import time


def now() -> float:
    return time.perf_counter()


def elapsed_milliseconds(t0: float, t1: float) -> float:
    """Microsecond-precision elapsed ms, like getElapsedMilliseconds."""
    return (t1 - t0) * 1000.0
