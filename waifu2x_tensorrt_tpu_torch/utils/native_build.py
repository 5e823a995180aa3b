"""Lazy build + load of the native framepipe runtime.

The port's copy of ``waifu2x_tensorrt_tpu.utils.native_build``. g++
compiles the port's copy of ``framepipe.cpp`` (``native/`` of this
package) on first use into ``build/framepipe/`` at the root of the
checkout, under a name keyed on a hash of the source; consumers fall back
to the pure-Python pipe path when no compiler is available
(``load_framepipe() is None``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parents[1] / "native" / "framepipe.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "framepipe"

_cached: Optional[ctypes.CDLL] = None
_load_failed = False


def lib_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"framepipe_{tag}.so"


def build_framepipe(force: bool = False) -> Optional[Path]:
    if not SRC.exists():
        return None
    out = lib_path()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temp name + atomic rename: a compiler killed mid-write
    # (OOM, disk full) must not leave a truncated .so at the final
    # content-keyed path — the source hash would never change, so the
    # poisoned cache would crash every later load instead of rebuilding
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        tmp.replace(out)
    except (subprocess.CalledProcessError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def load_framepipe() -> Optional[ctypes.CDLL]:
    """The loaded framepipe library with ctypes signatures set, or None."""
    global _cached, _load_failed
    if _cached is not None or _load_failed:
        return _cached
    path = build_framepipe()
    if path is None:
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        # unloadable library (e.g. a stale artifact from a foreign arch):
        # fall back to the pure-Python pipe path per this module's contract
        _load_failed = True
        return None
    lib.fp_reader_open.restype = ctypes.c_void_p
    lib.fp_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_int]
    lib.fp_reader_acquire.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.fp_reader_acquire.argtypes = [ctypes.c_void_p]
    lib.fp_reader_release.restype = None
    lib.fp_reader_release.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_ubyte)]
    lib.fp_reader_close.restype = ctypes.c_int
    lib.fp_reader_close.argtypes = [ctypes.c_void_p]
    lib.fp_reader_error.restype = ctypes.c_int
    lib.fp_reader_error.argtypes = [ctypes.c_void_p]
    lib.fp_writer_open.restype = ctypes.c_void_p
    lib.fp_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_int]
    lib.fp_writer_acquire.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.fp_writer_acquire.argtypes = [ctypes.c_void_p]
    lib.fp_writer_commit.restype = None
    lib.fp_writer_commit.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_ubyte)]
    lib.fp_writer_close.restype = ctypes.c_int
    lib.fp_writer_close.argtypes = [ctypes.c_void_p]
    _cached = lib
    return lib
