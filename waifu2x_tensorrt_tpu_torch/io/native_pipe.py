"""Python wrappers over the native framepipe runtime.

The port's copy of ``waifu2x_tensorrt_tpu.io.native_pipe``, over the
port's own build of ``framepipe.cpp`` (``utils/native_build.py``).

NativeFrameReader / NativeFrameWriter expose the C++ double-buffered pipe
rings as numpy frames (zero-copy views over the native slabs on the read
side). VideoCapture/VideoWriter use these automatically when the native
library is available; the pure-Python threads in io/video.py remain the
fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from waifu2x_tensorrt_tpu_torch.utils.native_build import load_framepipe


def native_available() -> bool:
    return load_framepipe() is not None


class NativeFrameReader:
    """Stream fixed-size raw frames from a shell command's stdout."""

    def __init__(self, cmd: str, height: int, width: int, channels: int = 3,
                 depth: int = 4) -> None:
        lib = load_framepipe()
        if lib is None:
            raise RuntimeError("native framepipe unavailable")
        self._lib = lib
        self._shape = (height, width, channels)
        self._bytes = height * width * channels
        self._h = lib.fp_reader_open(cmd.encode(), self._bytes, depth)
        if not self._h:
            raise RuntimeError(f"failed to start reader: {cmd!r}")
        self._loaned: dict[int, object] = {}  # slab addr -> ctypes ptr

    def read(self, copy: bool = True) -> Optional[np.ndarray]:
        """Next frame, or None at clean EOF. Raises RuntimeError when the
        decoder died mid-frame (truncated output) — a short stream must
        not be indistinguishable from a complete one. With copy=False the
        array is a view over a native slab that MUST be returned via
        ``release`` and must not outlive ``close()`` (the slabs are freed
        there)."""
        ptr = self._lib.fp_reader_acquire(self._h)
        if not ptr:
            if self._lib.fp_reader_error(self._h):
                raise RuntimeError(
                    "decoder emitted a truncated frame (stream died "
                    "mid-frame)")
            return None
        arr = np.ctypeslib.as_array(ptr, shape=self._shape)
        if copy:
            out = arr.copy()
            self._lib.fp_reader_release(self._h, ptr)
            return out
        self._loaned[arr.ctypes.data] = ptr
        return arr

    def release(self, arr: np.ndarray) -> None:
        self._lib.fp_reader_release(self._h, self._loaned.pop(arr.ctypes.data))

    def close(self) -> int:
        if self._h:
            # return leftover loans so close() never frees a slab the ring
            # still counts as outstanding; the numpy views become invalid
            # at this point (documented in read())
            for ptr in self._loaned.values():
                self._lib.fp_reader_release(self._h, ptr)
            self._loaned.clear()
            rc = self._lib.fp_reader_close(self._h)
            self._h = None
            return rc
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeFrameWriter:
    """Stream fixed-size raw frames into a shell command's stdin."""

    def __init__(self, cmd: str, height: int, width: int, channels: int = 3,
                 depth: int = 4) -> None:
        lib = load_framepipe()
        if lib is None:
            raise RuntimeError("native framepipe unavailable")
        self._lib = lib
        self._shape = (height, width, channels)
        self._bytes = height * width * channels
        self._h = lib.fp_writer_open(cmd.encode(), self._bytes, depth)
        if not self._h:
            raise RuntimeError(f"failed to start writer: {cmd!r}")

    def write(self, frame: np.ndarray) -> None:
        if frame.shape != self._shape or frame.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 {self._shape}, got {frame.dtype} {frame.shape}"
            )
        ptr = self._lib.fp_writer_acquire(self._h)
        if not ptr:
            raise RuntimeError("encoder pipe failed")
        dst = np.ctypeslib.as_array(ptr, shape=self._shape)
        np.copyto(dst, frame)
        self._lib.fp_writer_commit(self._h, ptr)

    def close(self) -> int:
        if self._h:
            rc = self._lib.fp_writer_close(self._h)
            self._h = None
            return rc
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
