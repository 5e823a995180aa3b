"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

``nvcc`` compiles every source into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). The library is built at first use into
``build/kernels/`` at the root of the checkout, under a name keyed on a
hash of the sources and the flags, so a changed source always rebuilds and
an unchanged one is reused. Nothing is built at import time.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; the wrappers in ``ops/`` raise on
a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (argument order of the csrc launchers)
_SIGNATURES = {
    "w2x_window_attention_qkv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "w2x_swin_block": [_P] * 15 + [_P, _I, _I, _I, _I, _I, _P],
    "w2x_finalize_gather": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "w2x_head_pack": [_P, _P, _I, _I, _I, _I, _I, _P],
    "w2x_window_attention_heads": [_P] * 6 + [_I] * 4 + [_P],
}

_lib = None


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    return BUILD_DIR / f"libw2x_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels if the hashed library is missing; returns its
    path. Raises with nvcc's output when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library (built at first call, then cached for the
    process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
