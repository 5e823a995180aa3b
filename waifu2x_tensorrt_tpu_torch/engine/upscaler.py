"""Upscaler: the engine facade (reference class trt::Img2Img,
src/tensorrt/img2img.h:14-50), the port of
``waifu2x_tensorrt_tpu.engine.upscaler``.

Owns the model module, the chunked pipeline and the message/progress
callback seams: ``load()``, ``render()``, ``open_stream()``,
``set_message_callback()``, ``set_progress_callback()``.
Errors raise (the CLI turns them into exit codes).

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
             fused_block: Optional[bool] = None) -> None:
        """Build the model for (family, scale, noise) at ``config``'s
        precision, load its weights and prepare the pipeline. A weight
        file gives the module its width and depths
        (``registry.checkpoint_arch``); random weights take the flagship
        architecture. ``fused_block`` defaults to True on CUDA."""
        registry.validate(family, scale, noise)
        if config.tta:
            raise NotImplementedError("TTA: not yet ported")
        if config.height == 0:
            raise NotImplementedError(
                "whole-frame rendering (--tileSize 0): not yet ported")
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
        # packed-x-head twin (same parameters): pack-aligned geometries
        # render through kernel D, with no separate depth-to-space
        module_px = spec_px = None
        if (os.environ.get("WAIFU2X_PACK_X") == "1"
                and spec.arch == "swin_unet" and scale > 1):
            module_px, spec_px = registry.packed_x_twin(module, spec)
        self._pipeline = ChunkedPipeline(
            module, spec, config, device, module_pack_x=module_px,
            spec_pack_x=spec_px, logger=self.logger)
        self.logger.log(
            Severity.info,
            f"loaded {family} scale={scale} noise={noise} on {device} "
            f"({config.precision.cache_tag}, fused_block={fused_block}, "
            f"packed_x={'on' if module_px is not None else 'off'}, "
            f"weights={'file' if from_file else 'random'})")

    # -- render (img2img_render.cpp:224-352) -------------------------------
    def render(self, frame_u8) -> np.ndarray:
        """Upscale one RGB uint8 HWC frame; returns RGB uint8 HWC (host).
        Fires the progress callback per model chunk."""
        if self._pipeline is None:
            raise RuntimeError("load() must be called before render()")
        out = self._pipeline.render(frame_u8, progress=self.logger.progress)
        return out.cpu().numpy()

    def open_stream(self, frame_hw) -> TileStream:
        """A cross-frame streaming session for fixed-size frames: leftover
        tiles of each frame ride in the next frame's model batch, so every
        model call is a full batch. ``submit(frame)`` returns the outputs
        that became ready (device u8 tensors), ``flush()`` the rest."""
        if self._pipeline is None:
            raise RuntimeError("load() must be called before open_stream()")
        return TileStream(self._pipeline, frame_hw,
                          progress=self.logger.progress)

    @property
    def spec(self) -> Optional[registry.ModelSpec]:
        return self._spec
