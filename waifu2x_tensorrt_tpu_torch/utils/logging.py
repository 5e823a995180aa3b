"""Logging / progress callback seam.

Mirrors trt::Logger (reference src/tensorrt/logger.h:8-39, logger.cpp:6-47):
an app-level severity enum, a message callback, a progress callback, and a
``log``/``LOG`` seam that stamps the call site. The CLI wires these into a
spdlog-style console formatter (reference src/main.cpp:9-15,163-194).
"""

from __future__ import annotations

import enum
import inspect
import sys
import time
from typing import Callable, Optional


class Severity(enum.IntEnum):
    critical = 0
    error = 1
    warn = 2
    info = 3
    debug = 4
    trace = 5


MessageCallback = Callable[[Severity, str], None]
# (current, total, iterations_per_second) — reference logger.h:21
ProgressCallback = Callable[[int, int, float], None]

_LEVEL_NAMES = {
    Severity.critical: "FATAL",
    Severity.error: "ERROR",
    Severity.warn: "WARN ",
    Severity.info: "INFO ",
    Severity.debug: "DEBUG",
    Severity.trace: "TRACE",
}


class Logger:
    """Bridges engine internals to user callbacks (reference trt::Logger)."""

    def __init__(self) -> None:
        self._message_cb: Optional[MessageCallback] = None
        self._progress_cb: Optional[ProgressCallback] = None

    def set_message_callback(self, cb: Optional[MessageCallback]) -> None:
        self._message_cb = cb

    def set_progress_callback(self, cb: Optional[ProgressCallback]) -> None:
        self._progress_cb = cb

    def log(self, severity: Severity, message: str, *, stamp: bool = True) -> None:
        """Emit a message; stamps ``[function@line]`` like the reference's
        LOG macro (logger.h:8)."""
        if stamp:
            frame = inspect.currentframe()
            caller = frame.f_back if frame else None
            if caller is not None:
                message = f"[{caller.f_code.co_name}@{caller.f_lineno}] {message}"
        if self._message_cb is not None:
            self._message_cb(severity, message)

    def progress(self, current: int, total: int, speed: float) -> None:
        if self._progress_cb is not None:
            self._progress_cb(current, total, speed)


def console_message_callback(stream=None) -> MessageCallback:
    """spdlog-lookalike console sink: ``[%H:%M:%S.%e] [LEVEL] msg``
    (reference src/main.cpp:15)."""
    out = stream or sys.stdout

    def cb(severity: Severity, message: str) -> None:
        now = time.time()
        ms = int((now - int(now)) * 1000)
        stamp = time.strftime("%H:%M:%S", time.localtime(now))
        print(f"[{stamp}.{ms:03d}] [{_LEVEL_NAMES[severity]}] {message}", file=out)

    return cb
