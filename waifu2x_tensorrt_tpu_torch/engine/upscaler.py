"""Upscaler: the engine facade (reference class trt::Img2Img,
src/tensorrt/img2img.h:14-50), the port of
``waifu2x_tensorrt_tpu.engine.upscaler``.

Owns the model module, the chunked pipeline and the message/progress
callback seams: ``build()``, ``load()``, ``render()``, ``render_async()``,
``open_stream()``, ``set_message_callback()``, ``set_progress_callback()``.
Errors raise (the CLI turns them into exit codes). ``load(...,
bucket=N)`` edge-pads every frame up to a multiple of N before it renders
and crops the output back.

Weights: a ``.npz`` under ``models/<family>/`` (``registry.weights_path``),
else a bare ``.onnx`` artifact at the same stem. An artifact is parsed and
its weights converted positionally and VERIFIED against its own graph
(``onnx_backend.verify_*_conversion``, the verdict cached in
``<artifact>.verify.json``); a verified artifact serves through the port's
modules (kernel B for swin_unet on CUDA), any other — or every one with
``graph_exact=True`` — through its own parsed graph (``GraphModule``).
Only the converters' and verifiers' ValueError selects the graph; an
error on the device raises.

``build()`` resolves the model as ``load()`` will, builds the CUDA kernel
library (on CUDA), runs one forward at each corner geometry of the
profile, captures each corner's chunk program (``engine/exe_cache.py``,
so a capture fault shows at build) and writes the engine sidecar
``<stem>_<hash16>.engine.json``; ``load()`` selects a sidecar as the
reference's getEnginePath does (``engine/cache.py``) and, with
``require_engine=True``, fails without one. Captured programs live in
their process: a later ``load`` captures again, and nothing is persisted.

Renders run through captured CUDA graphs on CUDA: one a chunk shape
(``ChunkedPipeline``), or with ``load(..., fuse_frame=True)`` one a frame
geometry (``RendererCache``: the whole frame is one graph replay, with no
cross-frame stream, so ``can_stream`` is False and ``open_stream``
returns None).

No fallback hides the device or a kernel: without a CUDA device a CUDA
render raises, the CPU serves only when asked for by name, and a kernel
that fails to build or launch raises. ``fused_block`` (kernel B for every
Swin block) is the default on CUDA.

``WAIFU2X_PACK_X=1`` in the environment adds the packed-x-head twin of the
model (kernel D, same parameters) for every pack-aligned geometry, on any
device: kernel D on CUDA, its plain twin on the CPU; not for a model made
from an ``.onnx`` artifact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.engine import cache as engine_cache
from waifu2x_tensorrt_tpu_torch.engine import exe_cache
from waifu2x_tensorrt_tpu_torch.engine.config import (
    BuildConfig,
    Precision,
    RenderConfig,
    compiled_shapes,
)
from waifu2x_tensorrt_tpu_torch.engine.renderer import (
    ChunkedPipeline,
    RendererCache,
    TileStream,
    bucket_frame,
    bucket_hw,
)
from waifu2x_tensorrt_tpu_torch.models import onnx_backend, registry
from waifu2x_tensorrt_tpu_torch.models.onnx_graph import read_graph
from waifu2x_tensorrt_tpu_torch.utils import profiling
from waifu2x_tensorrt_tpu_torch.utils.hashing import device_kind
from waifu2x_tensorrt_tpu_torch.utils.logging import Logger, Severity


class Upscaler:
    def __init__(self, models_dir: str | Path = "models",
                 allow_random_init: bool = False,
                 device: Optional[str | torch.device] = None) -> None:
        """``device``: ``"cuda:N"``, ``"cpu"``, or None for
        ``cuda:{config.device_id}`` at load. ``allow_random_init=True``
        lets load() use seeded random weights (seed 0) when no weight
        file exists; otherwise missing weights are a hard failure, as in
        the reference."""
        self.logger = Logger()
        self.models_dir = Path(models_dir)
        self.allow_random_init = allow_random_init
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._spec: Optional[registry.ModelSpec] = None
        self._pipeline: Optional[ChunkedPipeline] = None
        self._fused: Optional[RendererCache] = None
        self._bucket = 0
        # seconds of the last build(): library, model, eager, capture
        self.build_seconds: dict[str, float] = {}

    def _select_device(self, device_id: int) -> torch.device:
        dev = torch.device(self._device_arg if self._device_arg is not None
                           else f"cuda:{device_id}")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"{dev}: no CUDA device is available (pass "
                    "device='cpu' to render on the CPU)")
            index = dev.index if dev.index is not None else 0
            if not 0 <= index < torch.cuda.device_count():
                raise ValueError(
                    f"--device {index} out of range: "
                    f"{torch.cuda.device_count()} CUDA device(s) available")
            dev = torch.device("cuda", index)
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        self._device = dev
        return dev

    # -- callback seams (img2img_base.cpp:12-18) ---------------------------
    def set_message_callback(self, cb) -> None:
        self.logger.set_message_callback(cb)

    def set_progress_callback(self, cb) -> None:
        self.logger.set_progress_callback(cb)

    # -- build: kernels + corner forwards + sidecar (img2img_build.cpp) ----
    def build(self, family: str, scale: int, noise: int,
              config: BuildConfig, graph_exact: bool = False) -> None:
        """Resolve the model as ``load()`` will (``.npz``, verified
        ``.onnx`` or its graph; the verification runs or is read from
        ``.verify.json``), check every corner geometry of the profile
        against the model's tile divisor, build the CUDA kernel library
        (on CUDA), run one forward at each corner, capture each corner's
        chunk program (on CUDA) and write the engine sidecar.
        ``build_seconds`` holds the ready seconds by step: the kernel
        library's build or load, the model and its weights, the first
        (eager) forwards, and the captures."""
        registry.validate(family, scale, noise)
        self._refuse(family, scale, noise, config, graph_exact)
        device = self._select_device(config.device_id)
        exe_cache.configure(self.models_dir, device)
        fused_block = device.type == "cuda"
        t0 = time.perf_counter()
        module, spec, _, _ = self._resolve_model(
            family, scale, noise, config, device, fused_block, graph_exact)
        model_s = time.perf_counter() - t0
        shapes = compiled_shapes(config)
        for _, hh, ww in shapes:
            for dim in (hh, ww):
                if dim % spec.tile_divisor:
                    raise ValueError(
                        f"profile tile size {dim} is not a multiple of "
                        f"{spec.tile_divisor} (required by this model "
                        f"backend)")
        self.logger.log(
            Severity.info,
            f"Building engine for {family} scale={scale} noise={noise} "
            f"geometries={shapes} "
            f"precision={config.precision.cache_tag}",
        )
        t0 = time.perf_counter()
        kernels = "no kernel library on the CPU"
        if device.type == "cuda":
            from waifu2x_tensorrt_tpu_torch.ops import build as kernel_build

            kernels = f"kernel library {kernel_build.build().name}"
            kernel_build.load_library()
        library_s = time.perf_counter() - t0
        prog = exe_cache.cached_program(
            module, tag=f"model|{exe_cache.module_tag(module)}")
        t0 = time.perf_counter()
        for b, h, w in shapes:
            prog(torch.zeros((b, h, w, 3), dtype=config.precision.dtype,
                             device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        forwards_s = time.perf_counter() - t0
        capture_s = sum(g.capture_s for g in prog.graphs.values())
        self.build_seconds = {"library": library_s, "model": model_s,
                              "eager": forwards_s - capture_s,
                              "capture": capture_s}
        stem = registry.weights_path(self.models_dir, family, scale, noise)
        sidecar = engine_cache.write_engine_sidecar(
            stem, config, device_name=device_kind(device))
        captured = (f"{len(prog.graphs)} chunk programs captured as CUDA "
                    f"graphs in {capture_s:.1f}s, not persisted: a graph "
                    "lives in its process, so load() captures again"
                    if prog.graphs else "no programs captured on the CPU")
        self.logger.log(
            Severity.info,
            f"Engine built in {library_s + forwards_s:.1f}s ({kernels}; one "
            f"forward at each of {len(shapes)} corner geometries on "
            f"{device}; {captured}); sidecar {sidecar.name}",
        )

    # -- load: engine select + weights + pipeline (img2img_load.cpp) -------
    def load(self, family: str, scale: int, noise: int,
             config: RenderConfig,
             fused_block: Optional[bool] = None, bucket: int = 0,
             require_engine: bool = False,
             graph_exact: bool = False, fuse_frame: bool = False) -> None:
        """Build the model for (family, scale, noise) at ``config``'s
        precision, load its weights and prepare the pipeline. A swin_unet
        weight file gives the module its width and depths
        (``registry.checkpoint_arch``), an ``.onnx`` artifact its derived
        architecture; random weights take the flagship architecture.
        ``fused_block`` (swin_unet) defaults to True on CUDA.
        ``config.tta`` renders the 8 dihedral variants of every tile,
        ``config.height == 0`` the whole frame as one tile; ``bucket > 1``
        pads frames to multiples of ``bucket`` (``bucket_frame``).

        ``require_engine=True`` fails when no engine sidecar of a
        ``build()`` matches ``config`` (img2img_load.cpp:111-113);
        ``graph_exact=True`` serves a bare ``.onnx`` through its own graph
        even when its conversion verifies. ``fuse_frame=True`` renders a
        whole frame as one program (``RendererCache``; one per frame
        geometry, no cross-frame stream, no per-chunk progress); the
        default is the chunked pipeline, one program per chunk shape."""
        registry.validate(family, scale, noise)
        self._refuse(family, scale, noise, config, graph_exact,
                     pack_x=os.environ.get("WAIFU2X_PACK_X") == "1")
        device = self._select_device(config.device_id)
        exe_cache.configure(self.models_dir, device)
        stem = registry.weights_path(self.models_dir, family, scale, noise)
        found = engine_cache.find_engine(stem, config,
                                         device_name=device_kind(device))
        if found is None:
            msg = (f"no prebuilt engine sidecar for {family} "
                   f"(tile={config.height}, batch={config.batch_size}); ")
            if require_engine:
                # the reference hard-fails here (img2img_load.cpp:111-113)
                raise FileNotFoundError(
                    msg + "could not satisfy render configuration")
            self.logger.log(Severity.warn, msg + "compiling on first use")
        else:
            self.logger.log(Severity.info, f"Using engine {found[0].name}")
        if fused_block is None:
            fused_block = device.type == "cuda"
        module, spec, source, graph_backed = self._resolve_model(
            family, scale, noise, config, device, fused_block, graph_exact)
        if config.height % spec.tile_divisor:
            raise ValueError(
                f"tile size {config.height} is not a multiple of "
                f"{spec.tile_divisor} (required by this model backend)")
        if graph_backed and not config.height:
            # the parsed graph cannot pad itself to an arbitrary geometry
            # the way the port's modules do
            raise ValueError(
                "--tileSize 0 (whole-frame) is not supported when serving "
                "a parsed .onnx artifact directly; use a fixed tile size "
                f"(multiple of {spec.tile_divisor}), or convert the "
                "artifact to .npz (models/validate.py) for whole-frame "
                "rendering")
        self._spec = spec
        self._bucket = int(bucket)
        # packed-x-head twin (same parameters): pack-aligned geometries
        # render through kernel D, with no separate depth-to-space (not
        # under TTA, whose inverses act in pixel space, and not for a
        # model made from an .onnx artifact)
        module_px = spec_px = None
        if (os.environ.get("WAIFU2X_PACK_X") == "1" and source != "onnx"
                and spec.arch == "swin_unet" and scale > 1
                and not config.tta and not fuse_frame):
            module_px, spec_px = registry.packed_x_twin(module, spec)
        self._pipeline = self._fused = None
        if fuse_frame:
            self._fused = RendererCache(module, spec, config, device)
        else:
            self._pipeline = ChunkedPipeline(
                module, spec, config, device, module_pack_x=module_px,
                spec_pack_x=spec_px, logger=self.logger)
        self.logger.log(
            Severity.info,
            f"loaded {family} scale={scale} noise={noise} on {device} "
            f"({config.precision.cache_tag}, "
            + (f"fused_block={fused_block}, "
               if spec.arch == "swin_unet" and not graph_backed else "")
            + f"tta={'on' if config.tta else 'off'}, "
            f"tile={config.height or 'whole frame'}, bucket={bucket}, "
            f"packed_x={'on' if module_px is not None else 'off'}, "
            f"fuse_frame={'on' if fuse_frame else 'off'}, "
            f"weights={source})")

    def _refuse(self, family, scale, noise, config, graph_exact,
                pack_x=False) -> None:
        """Raise, naming the option, where the family cannot run with it
        (``registry.refused_option``, with the family's reason:
        hat/photo, dat/photo and mambair/photo are bf16 only, from their
        ``.npz``, with the pixel head)."""
        stem = registry.weights_path(self.models_dir, family, scale, noise)
        onnx = not stem.exists() and stem.with_suffix(".onnx").exists()
        option = registry.refused_option(
            family, fp32=config.precision is Precision.TF32,
            graph_exact=graph_exact, onnx=onnx, pack_x=pack_x)
        if option is not None:
            raise ValueError(f"{option}: not yet ported for {family} "
                             f"({registry.refusal_reason(family)})")

    def _resolve_model(self, family, scale, noise, config, device,
                       fused_block, graph_exact):
        """(module with its weights, spec, source, graph_backed): source is
        "file" (a .npz), "random", "onnx" (a verified artifact's weights)
        or "graph" (the artifact's parsed graph)."""
        stem = registry.weights_path(self.models_dir, family, scale, noise)
        onnx_path = stem.with_suffix(".onnx")
        if not stem.exists() and onnx_path.exists():
            return self._load_artifact(onnx_path, family, scale, noise,
                                       config, device, fused_block,
                                       graph_exact)
        arch = (registry.checkpoint_arch(stem) if stem.exists()
                and registry.widths_from_file(family) else {})
        module, spec = registry.create_model(
            family, scale, noise, dtype=config.precision.dtype,
            fused_block=fused_block, device=device, **arch)
        flat, from_file = registry.load_or_init_params(
            module, self.models_dir, family, scale, noise,
            warn=lambda m: self.logger.log(Severity.warn, m),
            allow_random=self.allow_random_init)
        registry.load_into(module, flat)
        if from_file and spec.arch == "swin_unet":
            # a converted checkpoint rides on the reconstruction: trust the
            # verdict validate recorded next to the .npz (content-hash and
            # converter-version keyed), else warn
            rec = onnx_backend.npz_verification(stem)
            if rec is not None:
                self.logger.log(
                    Severity.info,
                    f"conversion verified vs "
                    f"{rec.get('source_onnx', 'source artifact')} "
                    f"(max_err {rec.get('max_err')})")
            else:
                self.logger.log(
                    Severity.warn,
                    "swin_unet fidelity vs upstream is unverified for "
                    "converted checkpoints; validate with python -m "
                    "waifu2x_tensorrt_tpu_torch.models.validate or serve "
                    "the .onnx directly")
        return module, spec, "file" if from_file else "random", False

    def _load_artifact(self, onnx_path: Path, family, scale, noise,
                       config, device, fused_block, graph_exact):
        """Serve a bare ``.onnx``: parse, derive the architecture, and
        convert + verify its weights (TensorRT-style parse -> optimize,
        img2img_build.cpp:88); a verified artifact becomes the port's
        module, any other (or every one with ``graph_exact``) a
        ``GraphModule`` at ``config.precision`` (fp16: bf16 with fp32
        islands; tf32: the export's own fp32 math). Raises when the
        artifact's scale or architecture contradicts the request."""
        graph = read_graph(onnx_path)
        arch = onnx_backend.derive_arch(graph)
        if arch.scale != scale:
            raise ValueError(
                f"{onnx_path.name}: artifact scale {arch.scale} != "
                f"requested scale {scale}")
        fam_arch = "cunet" if family.startswith("cunet") else "swin_unet"
        if arch.arch != fam_arch:
            raise ValueError(
                f"{onnx_path.name}: artifact architecture {arch.arch!r} "
                f"does not match the requested family {family!r}")
        base = registry.get_spec(family, scale, noise)
        if not graph_exact and (
                arch.arch == "cunet"
                or (arch.arch == "swin_unet" and arch.stage_depths)):
            try:
                flat, err = self._verified_params(graph, arch, onnx_path)
            except ValueError as e:  # conversion or verification only
                self.logger.log(
                    Severity.warn,
                    f"{onnx_path.name}: optimized serving unavailable "
                    f"({e}); serving the parsed graph directly",
                )
            else:
                kw = {}
                if arch.arch == "swin_unet":
                    d = arch.stage_depths
                    kw = {"base_dim": arch.base_dim,
                          "depths": (d[0], d[0], d[1], d[2], d[2])}
                module, _ = registry.create_model(
                    family, scale, noise, dtype=config.precision.dtype,
                    fused_block=fused_block, device=device, **kw)
                registry.load_into(module, flat)
                self.logger.log(
                    Severity.info,
                    f"{onnx_path.name}: conversion VERIFIED against the "
                    f"artifact's own graph (max abs err {err:.2e} on a "
                    f"{tuple(arch.probe_hw)} probe); serving the port's "
                    f"{type(module).__name__} module (pass --graph-exact "
                    f"for the export's own math)",
                )
                return (module, dataclasses.replace(base, offset=arch.offset),
                        "onnx", False)
        compute_dtype = (config.precision.dtype
                         if config.precision is Precision.FP16 else None)
        module = onnx_backend.GraphModule(graph, compute_dtype, device)
        tile_divisor = base.tile_divisor
        if arch.arch == "swin_unet" and arch.window:
            # the graph cannot self-pad like the port's modules: tile
            # sizes must be window*4-divisible (two stride-2 stages)
            tile_divisor = max(tile_divisor, arch.window * 4)
        if arch.static_hw:
            # a RenderConfig carries one geometry, a BuildConfig the
            # min/opt/max profile: each must be the export's fixed shape
            if isinstance(config, BuildConfig):
                geoms = sorted({(hh, ww) for _, hh, ww in
                                compiled_shapes(config)})
            else:
                geoms = ([(config.height, config.width)] if config.height
                         else [])
            bad = [g for g in geoms if g != tuple(arch.static_hw)]
            if bad:
                raise ValueError(
                    f"{onnx_path.name} was exported at a FIXED geometry "
                    f"{tuple(arch.static_hw)} (requested {bad[0]}): "
                    f"graph-exact serving requires --tileSize "
                    f"{arch.static_hw[0]} (or convert the artifact "
                    f"— models/validate.py — for any tile size)")
        self.logger.log(
            Severity.info,
            f"serving parsed ONNX graph {onnx_path.name} directly at "
            f"{'bf16 (fp32 islands)' if compute_dtype is not None else 'fp32'}"
            f" (derived arch: {arch.summary()}); tile sizes must be "
            f"multiples of {tile_divisor}",
        )
        spec = dataclasses.replace(base, offset=arch.offset,
                                   tile_divisor=tile_divisor)
        return module, spec, "graph", True

    def _verified_params(self, graph, arch, onnx_path: Path):
        """(flat params, max abs err) of a conversion verified against the
        artifact's own graph. All three verdicts (success, divergence,
        parse failure) are cached in ``<artifact>.verify.json`` under the
        artifact's sha256 and the port's ``CONVERTER_VERSION``; a record
        of another version (the JAX package's, an older converter) is
        ignored and the artifact re-verified. Raises ValueError when the
        conversion or the verification fails (now or cached)."""
        sha16 = onnx_backend._sha16(onnx_path)
        sidecar = onnx_path.parent / (onnx_path.name + ".verify.json")

        def write_sidecar(payload: dict) -> None:
            try:
                sidecar.write_text(json.dumps(
                    {"sha16": sha16,
                     "converter_version": onnx_backend.CONVERTER_VERSION,
                     "arch": arch.summary(), **payload},
                    default=str))
            except OSError:
                pass

        err = cached_failure = None
        if sidecar.exists():
            try:
                cached = json.loads(sidecar.read_text())
                if (cached.get("sha16") == sha16
                        and cached.get("converter_version")
                        == onnx_backend.CONVERTER_VERSION):
                    if "error" in cached:
                        cached_failure = str(cached["error"])
                    else:
                        err = float(cached["max_err"])
                        # never trust a record past the current gate
                        if not err <= onnx_backend.VERIFY_TOL:
                            err = None
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError):
                err = None
        if cached_failure is not None:
            raise ValueError(f"{cached_failure} (cached verification)")
        is_cunet = arch.arch == "cunet"
        try:
            if is_cunet:
                flat = onnx_backend.cunet_params_from_graph(
                    graph, scale=arch.scale)
            else:
                flat = onnx_backend.swin_params_from_graph(graph)
            if err is None:
                verify = (onnx_backend.verify_cunet_conversion if is_cunet
                          else onnx_backend.verify_swin_conversion)
                err = verify(graph, arch, flat)
                write_sidecar({"max_err": err})
        except ValueError as e:
            write_sidecar({"error": str(e)})
            raise
        return flat, err

    # -- render (img2img_render.cpp:224-352) -------------------------------
    def _render_device(self, frame_u8) -> torch.Tensor:
        if self._pipeline is None and self._fused is None:
            raise RuntimeError("load() must be called before render()")
        frame_u8, (h, w) = bucket_frame(frame_u8, self._bucket)
        if self._fused is not None:
            out = self._fused.render(frame_u8)
            n = self._fused.get(frame_u8.shape[:2]).n_chunks
            self.logger.progress(n, n, 0.0)
        else:
            out = self._pipeline.render(frame_u8,
                                        progress=self.logger.progress)
        s = self._spec.scale
        return out[:h * s, :w * s]

    def render(self, frame_u8) -> np.ndarray:
        """Upscale one RGB uint8 HWC frame; returns RGB uint8 HWC (host).
        Fires the progress callback per model chunk."""
        return self._render_device(frame_u8).cpu().numpy()

    def render_async(self, frame_u8):
        """``render`` whose fetch has not waited yet: the frame's copy to the
        host is queued behind its render (``fetch_async``), and
        ``np.asarray`` of the result waits for it. Decode and encode of
        neighbouring frames overlap the device work meanwhile."""
        return fetch_async(self._render_device(frame_u8))

    def open_stream(self, frame_hw) -> Optional["_StreamSession"]:
        """A cross-frame streaming session for fixed-size frames: leftover
        tiles of each frame ride in the next frame's model batch, so every
        model call is a full batch. ``submit(frame)`` returns the outputs
        that became ready (device u8 tensors, cropped to the frame's
        size), ``flush()`` the rest. Returns None for a rect-TTA geometry
        (whole-frame TTA on a non-square frame, two tile orientations a
        frame): render such frames one by one; so does every geometry
        under ``fuse_frame`` (a frame is one program)."""
        if self._fused is not None:
            return None
        if not self.can_stream:
            raise RuntimeError("load() must be called before open_stream()")
        hw = (int(frame_hw[0]), int(frame_hw[1]))
        padded = bucket_hw(hw, self._bucket)
        if self._pipeline.get(padded)[0].flat is None:
            return None
        return _StreamSession(
            TileStream(self._pipeline, padded,
                       progress=self.logger.progress),
            hw, self._bucket, self._spec.scale)

    @property
    def can_stream(self) -> bool:
        """True once ``load()`` has built the chunked pipeline, whose
        geometries stream (all but rect-TTA ones, see ``open_stream``);
        False under ``fuse_frame``."""
        return self._pipeline is not None

    @property
    def spec(self) -> Optional[registry.ModelSpec]:
        return self._spec


class _HostCopy:
    """A device frame on its way into pinned host memory: the copy and an
    event after it are queued on the frame's stream; ``np.asarray`` waits
    on the event and returns a view of the pinned C-contiguous buffer.
    Under a profiler session the pinned allocation, the dense copy and the
    DtoH are the stage span ``w2x.fetch``."""

    def __init__(self, frame: torch.Tensor) -> None:
        with profiling.span("fetch", frame.device,
                            bytes=frame.numel() * frame.element_size()), \
                torch.cuda.device(frame.device):
            self._host = torch.empty(tuple(frame.shape), dtype=frame.dtype,
                                     pin_memory=True)
            # a cropped output is a strided view: made dense on the device
            self._host.copy_(frame.contiguous(), non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()

    def __array__(self, dtype=None, copy=None):
        self._done.synchronize()
        out = self._host.numpy()
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out.copy() if copy else out


def fetch_async(frame):
    """The host side of a device frame without waiting for it: for a CUDA
    tensor a ``_HostCopy`` (``np.asarray`` waits for its copy), for anything
    else the object itself (on the CPU the tensor is already host memory)."""
    if isinstance(frame, torch.Tensor) and frame.is_cuda:
        return _HostCopy(frame)
    return frame


class _StreamSession:
    """``TileStream`` behind ``Upscaler.open_stream``: buckets each frame
    as ``render`` does and crops the outputs back to the frame's size."""

    def __init__(self, stream: TileStream, frame_hw, bucket: int,
                 scale: int) -> None:
        self._stream = stream
        self._hw = frame_hw
        self._bucket = bucket
        self._out_hw = (frame_hw[0] * scale, frame_hw[1] * scale)

    def _crop(self, outs: list) -> list:
        oh, ow = self._out_hw
        return [o[:oh, :ow] for o in outs]

    def warm(self) -> int:
        """One carry cycle of zero frames (``TileStream.warm``)."""
        return self._stream.warm()

    def submit(self, frame_u8) -> list:
        """Feed one frame; returns the outputs that became ready (device u8
        tensors, in submission order)."""
        if tuple(frame_u8.shape[:2]) != self._hw:
            raise ValueError(f"stream expects {self._hw} frames, got "
                             f"{tuple(frame_u8.shape[:2])}")
        frame_u8, _ = bucket_frame(frame_u8, self._bucket)
        return self._crop(self._stream.submit(frame_u8))

    def flush(self) -> list:
        """Run the carried tail and return the remaining outputs."""
        return self._crop(self._stream.flush())
