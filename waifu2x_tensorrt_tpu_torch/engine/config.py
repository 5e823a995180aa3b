"""Build/render configuration structs.

Mirrors trt::BuildConfig / trt::RenderConfig (reference
src/tensorrt/config.h:12-43), the port's copy of
``waifu2x_tensorrt_tpu.engine.config``: ``fp16`` selects bfloat16 compute
(as the JAX package does) and ``tf32`` selects full float32 — the same CLI
surface with the same numeric meaning on both packages.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

# CLI tileSize choices (reference src/main.cpp:62-64) plus 0 = whole-frame
# (the frame as one tile, an extension of the JAX package).
TILE_CHOICES = (0, 64, 128, 256, 400, 640)


class Precision(enum.Enum):
    FP16 = "fp16"  # bfloat16 compute
    TF32 = "tf32"  # float32 compute

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self is Precision.FP16 else torch.float32

    @property
    def cache_tag(self) -> str:
        # the reference's serialized names ("FP16"/"TF32",
        # img2img_build.cpp:13-20)
        return "FP16" if self is Precision.FP16 else "TF32"


@dataclasses.dataclass
class BuildConfig:
    """Compile configuration (reference config.h:12-31)."""

    device_id: int = 0
    precision: Precision = Precision.FP16
    min_batch_size: int = 1
    opt_batch_size: int = 1
    max_batch_size: int = 4
    min_channels: int = 3
    opt_channels: int = 3
    max_channels: int = 3
    min_width: int = 64
    opt_width: int = 256
    max_width: int = 640
    min_height: int = 64
    opt_height: int = 256
    max_height: int = 640


@dataclasses.dataclass
class RenderConfig:
    """Render-time configuration (reference config.h:33-42)."""

    device_id: int = 0
    precision: Precision = Precision.FP16
    batch_size: int = 1
    channels: int = 3
    height: int = 256
    width: int = 256
    scaling: int = 4
    overlap: tuple[float, float] = (0.0625, 0.0625)
    tta: bool = False


def is_compatible(render: RenderConfig, build: BuildConfig) -> bool:
    """Range-compatibility check (reference img2img_load.cpp:9-20).

    Device identity is not compared here: engines are keyed on the device
    *name* (img2img_build.cpp:12), which ``find_engine`` matches against
    the sidecar's recorded name, so a render on ``--device N>0`` still
    finds an engine built on device 0 of the same kind.
    """
    return (
        render.precision == build.precision
        and build.min_batch_size <= render.batch_size <= build.max_batch_size
        and build.min_channels <= render.channels <= build.max_channels
        and build.min_width <= render.width <= build.max_width
        and build.min_height <= render.height <= build.max_height
    )


def compiled_shapes(build: BuildConfig) -> tuple[tuple[int, int, int], ...]:
    """Distinct (batch, height, width) corner geometries of a profile
    (min, opt, max) that ``Upscaler.build`` checks and runs once each."""
    shapes: list[tuple[int, int, int]] = []
    for b, h, w in (
        (build.min_batch_size, build.min_height, build.min_width),
        (build.opt_batch_size, build.opt_height, build.opt_width),
        (build.max_batch_size, build.max_height, build.max_width),
    ):
        if (b, h, w) not in shapes:
            shapes.append((b, h, w))
    return tuple(shapes)


def is_warm(render: RenderConfig, build: BuildConfig) -> bool:
    """True iff the render geometry is one of the build's corners."""
    return (
        render.batch_size,
        render.height,
        render.width,
    ) in compiled_shapes(build)


def is_optimized(render: RenderConfig, build: BuildConfig) -> bool:
    """Exact-opt match check (reference img2img_load.cpp:22-27)."""
    return (
        render.batch_size == build.opt_batch_size
        and render.channels == build.opt_channels
        and render.width == build.opt_width
        and render.height == build.opt_height
    )
