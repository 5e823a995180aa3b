"""Upscaler: the engine facade (reference class trt::Img2Img,
src/tensorrt/img2img.h:14-50), the port of
``waifu2x_tensorrt_tpu.engine.upscaler``.

Owns the model module, the chunked pipeline and the message/progress
callback seams: ``load()``, ``render()``, ``render_async()``,
``open_stream()``, ``set_message_callback()``, ``set_progress_callback()``.
Errors raise (the CLI turns them into exit codes). ``load(...,
bucket=N)`` edge-pads every frame up to a multiple of N before it renders
and crops the output back.

No fallback hides the device or a kernel: without a CUDA device a CUDA
render raises, the CPU serves only when asked for by name, and a kernel
that fails to build or launch raises. ``fused_block`` (kernel B for every
Swin block) is the default on CUDA.

``WAIFU2X_PACK_X=1`` in the environment adds the packed-x-head twin of the
model (kernel D, same parameters) for every pack-aligned geometry, on any
device: kernel D on CUDA, its plain twin on the CPU.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import (
    ChunkedPipeline,
    TileStream,
    bucket_frame,
    bucket_hw,
)
from waifu2x_tensorrt_tpu_torch.models import registry
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
        self._bucket = 0

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

    # -- load: weights + pipeline (img2img_load.cpp) -----------------------
    def load(self, family: str, scale: int, noise: int,
             config: RenderConfig,
             fused_block: Optional[bool] = None, bucket: int = 0) -> None:
        """Build the model for (family, scale, noise) at ``config``'s
        precision, load its weights and prepare the pipeline. A swin_unet
        weight file gives the module its width and depths
        (``registry.checkpoint_arch``); random weights take the flagship
        architecture. ``fused_block`` (swin_unet) defaults to True on
        CUDA. ``config.tta`` renders the 8 dihedral variants of every
        tile, ``config.height == 0`` the whole frame as one tile;
        ``bucket > 1`` pads frames to multiples of ``bucket``
        (``bucket_frame``)."""
        registry.validate(family, scale, noise)
        device = self._select_device(config.device_id)
        if fused_block is None:
            fused_block = device.type == "cuda"
        path = registry.weights_path(self.models_dir, family, scale, noise)
        arch = (registry.checkpoint_arch(path)
                if path.exists() and family.startswith("swin_unet") else {})
        module, spec = registry.create_model(
            family, scale, noise, dtype=config.precision.dtype,
            fused_block=fused_block, device=device, **arch)
        flat, from_file = registry.load_or_init_params(
            module, self.models_dir, family, scale, noise,
            warn=lambda m: self.logger.log(Severity.warn, m),
            allow_random=self.allow_random_init)
        registry.load_into(module, flat)
        if config.height % spec.tile_divisor:
            raise ValueError(
                f"tile size {config.height} is not a multiple of "
                f"{spec.tile_divisor} (required by this model)")
        self._spec = spec
        self._bucket = int(bucket)
        # packed-x-head twin (same parameters): pack-aligned geometries
        # render through kernel D, with no separate depth-to-space (not
        # under TTA, whose inverses act in pixel space)
        module_px = spec_px = None
        if (os.environ.get("WAIFU2X_PACK_X") == "1"
                and spec.arch == "swin_unet" and scale > 1
                and not config.tta):
            module_px, spec_px = registry.packed_x_twin(module, spec)
        self._pipeline = ChunkedPipeline(
            module, spec, config, device, module_pack_x=module_px,
            spec_pack_x=spec_px, logger=self.logger)
        self.logger.log(
            Severity.info,
            f"loaded {family} scale={scale} noise={noise} on {device} "
            f"({config.precision.cache_tag}, "
            + (f"fused_block={fused_block}, " if spec.arch == "swin_unet"
               else "")
            + f"tta={'on' if config.tta else 'off'}, "
            f"tile={config.height or 'whole frame'}, bucket={bucket}, "
            f"packed_x={'on' if module_px is not None else 'off'}, "
            f"weights={'file' if from_file else 'random'})")

    # -- render (img2img_render.cpp:224-352) -------------------------------
    def _render_device(self, frame_u8) -> torch.Tensor:
        if self._pipeline is None:
            raise RuntimeError("load() must be called before render()")
        frame_u8, (h, w) = bucket_frame(frame_u8, self._bucket)
        out = self._pipeline.render(frame_u8, progress=self.logger.progress)
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
        frame): render such frames one by one."""
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
        geometries stream (all but rect-TTA ones, see ``open_stream``)."""
        return self._pipeline is not None

    @property
    def spec(self) -> Optional[registry.ModelSpec]:
        return self._spec


class _HostCopy:
    """A device frame on its way into pinned host memory: the copy and an
    event after it are queued on the frame's stream; ``np.asarray`` waits
    on the event and returns a view of the pinned C-contiguous buffer."""

    def __init__(self, frame: torch.Tensor) -> None:
        with torch.cuda.device(frame.device):
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
