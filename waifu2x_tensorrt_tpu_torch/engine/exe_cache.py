"""The compiled-program store of the port: CUDA graphs, captured in process.

The port's counterpart of ``waifu2x_tensorrt_tpu.engine.exe_cache``. Where
JAX compiles a traced function into an executable (``cached_jit``), the
port captures one eager run of the function into a ``torch.cuda.CUDAGraph``
(``cached_program``) and replays it: a chunk or a whole frame is then one
graph launch instead of a hundred kernel launches from the host.

Only the in-process half of the JAX store exists here. The JAX package
itself keeps its on-disk half off on GPUs (its ``enabled()`` is False on
the ``cpu`` and ``gpu`` backends, which compile locally in seconds), and a
captured CUDA graph cannot outlive its process: its kernels' parameters
are the device addresses of this process's allocations. So nothing is
serialized, ``store_dir()`` is always None, and a fresh process captures
again (``Upscaler.build`` reports how long that takes).

Key: the caller's ``tag`` (what shapes the program beyond its arguments:
``module_tag`` of the module, the spec, the render config), each
argument's shape, dtype and device, and ``fingerprint(device)``: a hash of
the port's ``.py`` sources and ``ops/csrc/``, ``torch.__version__`` and
``torch.version.cuda``, the GPU's name and compute capability and the
device count (the JAX fingerprint lacks the device count).

Capture: the first call at a key runs ``fn`` once eagerly on a side
stream, which fills the models' operand cache (``models/layers.cached``:
cast weights and kernel B's operands), cuDNN's algorithm choice and the
kernel library, and returns that result.
It then captures one graph of ``fn`` into static input and output
buffers, in the memory pool the program was given (``GraphPool``: all
programs of one pipeline share one). Replay: a later call copies its
inputs into the static buffers, replays the graph and returns a COPY of
the static output, because callers keep outputs across calls
(``TileStream`` keeps chunk outputs across submits, and kernel C reads
them by address) and the next replay overwrites the static output. A
captured program reads the module's cached operands where they lay at
capture: load weights before the first call.

Launch counts: the kernel wrappers count their launches in Python, which a
replay does not run. A capture records how many launches each counter of
``graph_counters`` counted (each kernel's, and its wrapper's extra ones)
and takes them off the counters again (nothing ran); every replay adds
them.

Under a profiler session a capture is the host span ``w2x.capture``
(``utils/profiling.py``: the tag's kind, the input's shape, and the
eager, capture and pool figures above in the record);
``trace_counts`` says what a call will run, for its caller's span.

On the CPU (``enabled`` is False there: it has no graphs) a
``CachedProgram`` calls ``fn``. Which paths are captured is decided here,
statically: a capture that fails raises; nothing falls back to eager.
"""

from __future__ import annotations

import functools
import hashlib
import time
from pathlib import Path
from typing import Optional

import torch

from waifu2x_tensorrt_tpu_torch import ops
from waifu2x_tensorrt_tpu_torch.utils import profiling

_PACKAGE = Path(__file__).resolve().parents[1]

_device: Optional[torch.device] = None


def configure(models_dir, device=None) -> None:
    """Record the device that programs run on (``Upscaler.build`` and
    ``load`` call this, as the JAX package's do). ``models_dir`` is where
    the JAX store writes; the port writes nothing there (see the module
    docstring)."""
    global _device
    _device = None if device is None else torch.device(device)


def store_dir() -> Optional[Path]:
    """Where programs are stored on disk: nowhere in the port (None), since
    a CUDA graph cannot outlive its process."""
    return None


def enabled(device=None) -> bool:
    """True when programs on ``device`` (default: the configured device)
    are captured as CUDA graphs: on a CUDA device, never on the CPU."""
    dev = torch.device(device) if device is not None else _device
    return dev is not None and dev.type == "cuda"


@functools.cache
def _code_fingerprint() -> str:
    """Content hash of the port's ``.py`` sources and its CUDA sources."""
    h = hashlib.sha256()
    files = sorted(_PACKAGE.rglob("*.py")) + sorted(
        p for p in (_PACKAGE / "ops" / "csrc").iterdir() if p.is_file())
    for p in files:
        h.update(str(p.relative_to(_PACKAGE)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def _device_fingerprint(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    props = torch.cuda.get_device_properties(device)
    return (f"cuda|{props.name}|sm_{props.major}{props.minor}"
            f"|n{torch.cuda.device_count()}")


def fingerprint(device) -> str:
    """The code, the framework and the device that a program is valid
    for."""
    return "|".join((_code_fingerprint(), torch.__version__,
                     str(torch.version.cuda),
                     _device_fingerprint(torch.device(device))))


_HYPER_TYPES = (bool, int, float, str, tuple, torch.dtype)


def module_tag(module) -> str:
    """Identity of a module's program: every submodule's type, its
    ``extra_repr`` (layer widths, kernel sizes) and its public attributes
    of plain types (dims, depths, shift, ``fused_block``, dtype, the
    packed-x head), hashed."""
    parts = []
    for name, m in module.named_modules():
        attrs = sorted((k, repr(v)) for k, v in vars(m).items()
                       if not k.startswith("_") and k != "training"
                       and isinstance(v, _HYPER_TYPES))
        parts.append(f"{name}|{type(m).__qualname__}|{m.extra_repr()}"
                     f"|{attrs}")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def graph_counters() -> dict:
    """Every launch counter a captured graph keeps, as (wrapper,
    attribute), by its name in a span's counts: ``launches_<letter>`` for
    each kernel of ``ops.kernels()`` and ``<name>_<letter>`` for each of
    its wrapper's ``extra_counters``."""
    counters = {}
    for letter, wrapper in ops.kernels().items():
        counters[f"launches_{letter}"] = (wrapper, "launches")
        for name, attr in getattr(wrapper, "extra_counters", {}).items():
            counters[f"{name}_{letter}"] = (wrapper, attr)
    return counters


def counter_values() -> dict:
    """Each of ``graph_counters`` now, by name."""
    return {name: getattr(wrapper, attr)
            for name, (wrapper, attr) in graph_counters().items()}


def take_recorded(before: dict) -> dict:
    """The launches counted since ``before`` (``counter_values``), by name,
    for each counter that moved; the counters are set back to ``before``,
    since a capture records its launches but runs none."""
    recorded = {}
    for name, (wrapper, attr) in graph_counters().items():
        n = getattr(wrapper, attr) - before[name]
        if n:
            recorded[name] = n
            setattr(wrapper, attr, before[name])
    return recorded


def _reserved_bytes(device) -> int:
    return torch.cuda.memory_stats(device).get("reserved_bytes.all.current",
                                               0)


class GraphPool:
    """The memory pool that the graphs of several programs share (one per
    pipeline), made at the first capture, with the side stream of their
    eager first runs. Graphs that share a pool must not replay
    concurrently; a pipeline replays its programs on one stream, one
    after another."""

    def __init__(self) -> None:
        self._handle = None
        self._side: dict = {}
        self.bytes = 0  # the pool's growth over every capture

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def side_stream(self, device: torch.device):
        stream = self._side.get(device)
        if stream is None:
            stream = self._side[device] = torch.cuda.Stream(device)
        return stream


class _Graph:
    """One captured graph with its static buffers and what it launches."""

    def __init__(self, graph, static_args, static_out, launches: dict,
                 pool_bytes: int, eager_s: float, capture_s: float) -> None:
        self.graph = graph
        self.static_args = static_args
        self.static_out = static_out
        self.launches = launches        # {counter name: launches a replay}
        counters = graph_counters()
        self._adds = [(*counters[name], n) for name, n in launches.items()]
        self.pool_bytes = pool_bytes    # the pool's growth at capture
        self.eager_s = eager_s          # the first, eager run (host clock)
        self.capture_s = capture_s

    def replay(self, args):
        for static, a in zip(self.static_args, args):
            static.copy_(a)
        self.graph.replay()
        for wrapper, attr, n in self._adds:
            setattr(wrapper, attr, getattr(wrapper, attr) + n)
        return self.static_out.clone()


class CachedProgram:
    """``fn`` (tensors in, one tensor out) as captured CUDA graphs, one per
    key (``key``); on the CPU, ``fn`` itself. ``fn`` stays reachable for
    eager comparison."""

    def __init__(self, fn, tag: str, pool: Optional[GraphPool] = None):
        self.fn = fn
        self.tag = tag
        self.pool = pool if pool is not None else GraphPool()
        self.graphs: dict[tuple, _Graph] = {}

    def key(self, *args) -> tuple:
        """(tag, each argument's (shape, dtype, device), fingerprint)."""
        return (self.tag,
                tuple((tuple(a.shape), a.dtype, str(a.device))
                      for a in args),
                fingerprint(args[0].device))

    def __call__(self, *args):
        with torch.inference_mode():
            if not enabled(args[0].device):
                return self.fn(*args)
            key = self.key(*args)
            entry = self.graphs.get(key)
            if entry is not None:
                return entry.replay(args)
            out, self.graphs[key] = self._capture(args)
            return out

    def trace_counts(self, *args) -> dict:
        """What a call with ``args`` runs, as counts of a trace span:
        ``program`` (``eager`` on the CPU, ``capture`` or ``replay``) and,
        for a replay, the launches its graph makes, by counter name
        (``launches_B``, ``direct_B``: ``graph_counters``)."""
        if not enabled(args[0].device):
            return {"program": "eager"}
        graph = self.graphs.get(self.key(*args))
        if graph is None:
            return {"program": "capture"}
        return {"program": "replay", **graph.launches}

    def _capture(self, args):
        device = args[0].device
        with torch.cuda.device(device), profiling.span(
                "capture", kind=self.tag.split("|", 1)[0],
                shape="x".join(map(str, args[0].shape))) as counts:
            current = torch.cuda.current_stream(device)
            side = self.pool.side_stream(device)
            t0 = time.perf_counter()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self.fn(*args)
            # later work on the current stream, and the side stream's next
            # allocations (behind its next wait_stream), follow this run
            current.wait_stream(side)
            torch.cuda.synchronize(device)
            eager_s = time.perf_counter() - t0
            if not isinstance(out, torch.Tensor):
                raise TypeError(f"{self.tag}: a captured program returns "
                                f"one tensor, not {type(out).__name__}")
            static_args = tuple(a.clone() for a in args)
            before = counter_values()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=self.pool.handle()):
                reserved = _reserved_bytes(device)
                static_out = self.fn(*static_args)
            pool_bytes = _reserved_bytes(device) - reserved
            capture_s = time.perf_counter() - t0
            launches = take_recorded(before)
            if counts is not None:
                counts.update(eager_s=eager_s, capture_s=capture_s,
                              pool_bytes=pool_bytes)
        self.pool.bytes += pool_bytes
        return out, _Graph(graph, static_args, static_out, launches,
                           pool_bytes, eager_s, capture_s)


def cached_program(fn, tag: str, pool: Optional[GraphPool] = None):
    """``fn`` as a ``CachedProgram`` (the counterpart of ``cached_jit``)."""
    return CachedProgram(fn, tag, pool)
