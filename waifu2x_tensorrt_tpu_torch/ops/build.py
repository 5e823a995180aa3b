"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

``nvcc`` compiles every source (one process per source, all started
together) and links them into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). The library is built at first use into
``build/kernels/`` at the root of the checkout, under a name keyed on a
hash of the sources, the flags and nvcc's version, so a changed source or
toolkit always rebuilds and an unchanged one is reused. Nothing is built
at import time.
``extra_flags`` builds a variant of the library beside it (a measurement
build, e.g. ``-DW2X_PHASE_CLOCK``); the kernels' wrappers use the plain one.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; the wrappers in ``ops/`` raise on
a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of the entry points (argument order of the csrc launchers)
_SIGNATURES = {
    "w2x_window_attention_qkv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "w2x_swin_block": [_P] * 16 + [_I] * 8 + [_P],
    "w2x_finalize_gather": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "w2x_head_pack": [_P, _P, _I, _I, _I, _I, _I, _P],
    "w2x_window_attention_heads": [_P] * 6 + [_I] * 4 + [_P],
    "w2x_attention_tc_info": [_IP, _IP],
    "w2x_attention_f32_info": [_IP, _IP, _IP],
    "w2x_swin_block_f32_info": [_I, _IP, _IP, _IP],
    "w2x_mma_probe": [_P, _P, _P] + [_I] * 5 + [_P],
    "w2x_hat_attention": [_P] * 3 + [_I] * 8 + [ctypes.c_float, _P],
    "w2x_hat_attention_rect": [_P] * 3 + [_I] * 10 + [ctypes.c_float, _P],
    "w2x_hat_attention_info": [_I, _IP, _IP],
    "w2x_channel_attention": [_P] * 5 + [_I] * 5 + [_P],
    "w2x_channel_attention_scratch": [_I] * 3,
    "w2x_bias_act": [_P] * 3 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
    "w2x_add_norm": [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P],
    "w2x_add_norm_info": [_I, _I, _IP, _IP],
}

# entry points that return other than a CUDA error code
_RESTYPES = {"w2x_channel_attention_scratch": ctypes.c_longlong}

_lib = None


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


@functools.cache
def _version_of(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the toolkit's build)."""
    return _version_of(_nvcc())


def source_hash(extra_flags=()) -> str:
    """The library's key: the sources, the flags and nvcc's version."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    h.update(nvcc_version().encode())
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


def library_path(extra_flags=()) -> Path:
    return BUILD_DIR / f"libw2x_kernels_{source_hash(extra_flags)}.so"


def build(extra_flags=()) -> Path:
    """Compile the kernels if the hashed library is missing; returns its
    path. Raises with nvcc's output when the compile fails."""
    out = library_path(extra_flags)
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objdir = BUILD_DIR / f"{tmp.name}.obj"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    try:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = objdir / f"{src.stem}.o"
            jobs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra_flags, "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        outputs = [proc.communicate() for _, proc in jobs]  # all finish
        for (_, proc), (stdout, stderr) in zip(jobs, outputs):
            _raise_on_failure(proc.returncode, stdout, stderr)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *[str(obj) for obj, _ in jobs]], capture_output=True, text=True)
        _raise_on_failure(link.returncode, link.stdout, link.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objdir, ignore_errors=True)
    return out


def _raise_on_failure(code: int, stdout: str, stderr: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{stdout}\n{stderr}")


def load_library(extra_flags=()) -> ctypes.CDLL:
    """The kernels' library (built at first call, then cached for the
    process); with ``extra_flags``, a measurement variant, loaded anew."""
    global _lib
    if _lib is not None and not extra_flags:
        return _lib
    lib = ctypes.CDLL(str(build(extra_flags)))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    if not extra_flags:
        _lib = lib
    return lib


def check(code: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
