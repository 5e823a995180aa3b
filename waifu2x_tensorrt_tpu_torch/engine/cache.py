"""Engine sidecars: ``<stem>_<hash16>.engine.json`` next to the weights.

The port's copy of ``waifu2x_tensorrt_tpu.engine.cache`` (reference
Img2Img::build, src/tensorrt/img2img_build.cpp:54-173; engine selection in
Img2Img::load / getEnginePath, src/tensorrt/img2img_load.cpp:79-114):

- ``write_engine_sidecar``: the JSON descriptor of a built profile, field
  for field serializeConfig (img2img_build.cpp:29-50,151-166), with the
  CUDA device name (``"cpu"`` on the CPU) as ``deviceName``;
- ``find_engine``: directory scan + sidecar deserialize + exact-opt vs
  compatible-range selection (getEnginePath semantics).

The port keeps no compiled-program store: its ``build`` compiles the CUDA
kernel library and runs the profile's corners (``Upscaler.build``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from waifu2x_tensorrt_tpu_torch.engine.config import (
    BuildConfig,
    Precision,
    RenderConfig,
    is_compatible,
    is_optimized,
    is_warm,
)
from waifu2x_tensorrt_tpu_torch.utils.hashing import device_kind, short_hash

ENGINE_SUFFIX = ".engine.json"  # the sidecar IS the engine descriptor


def serialize_config(config: BuildConfig,
                     device_name: Optional[str] = None) -> dict:
    """Sidecar JSON payload (field for field serializeConfig,
    img2img_build.cpp:29-50)."""
    return {
        "deviceName": device_name or device_kind(config.device_id),
        "precision": config.precision.cache_tag,
        "minBatchSize": config.min_batch_size,
        "optBatchSize": config.opt_batch_size,
        "maxBatchSize": config.max_batch_size,
        "minChannels": config.min_channels,
        "optChannels": config.opt_channels,
        "maxChannels": config.max_channels,
        "minWidth": config.min_width,
        "optWidth": config.opt_width,
        "maxWidth": config.max_width,
        "minHeight": config.min_height,
        "optHeight": config.opt_height,
        "maxHeight": config.max_height,
    }


def deserialize_config(path: str | Path) -> tuple[BuildConfig, str]:
    """A sidecar back as a BuildConfig and its device name
    (deserializeConfig, img2img_load.cpp:54-77)."""
    with open(path) as f:
        j = json.load(f)
    cfg = BuildConfig(
        device_id=0,
        precision=(Precision.FP16 if j["precision"] == "FP16"
                   else Precision.TF32),
        min_batch_size=j["minBatchSize"],
        opt_batch_size=j["optBatchSize"],
        max_batch_size=j["maxBatchSize"],
        min_channels=j["minChannels"],
        opt_channels=j["optChannels"],
        max_channels=j["maxChannels"],
        min_width=j["minWidth"],
        opt_width=j["optWidth"],
        max_width=j["maxWidth"],
        min_height=j["minHeight"],
        opt_height=j["optHeight"],
        max_height=j["maxHeight"],
    )
    return cfg, j["deviceName"]


def engine_sidecar_path(weights_stem_path: Path, config: BuildConfig,
                        device_name: Optional[str] = None) -> Path:
    """``<model_stem>_<sha256(cfg)[:16]>.engine.json`` next to the weights
    (naming per img2img_build.cpp:151-155)."""
    tag = short_hash(config, device_name)
    return (weights_stem_path.parent
            / f"{weights_stem_path.stem}_{tag}{ENGINE_SUFFIX}")


def write_engine_sidecar(weights_stem_path: Path, config: BuildConfig,
                         device_name: Optional[str] = None) -> Path:
    path = engine_sidecar_path(weights_stem_path, config, device_name)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(serialize_config(config, device_name), f, indent=4)
    return path


def find_engine(
    weights_stem_path: Path,
    render_config: RenderConfig,
    device_name: Optional[str] = None,
) -> Optional[tuple[Path, BuildConfig]]:
    """Scan the model dir for a matching engine sidecar.

    getEnginePath (img2img_load.cpp:79-114): files must start with the
    model stem; an exact-opt match wins, else the first compatible one.
    The device is matched by its recorded name. A profile claims only the
    geometries its build ran (the min/opt/max corners, ``is_warm``), as
    in the JAX package.
    """
    stem = weights_stem_path.stem
    directory = weights_stem_path.parent
    if not directory.is_dir():
        return None
    want_device = device_name or device_kind(render_config.device_id)
    best: Optional[tuple[Path, BuildConfig]] = None
    for path in sorted(directory.iterdir()):
        if not path.is_file():
            continue
        if (not path.name.startswith(stem)
                or not path.name.endswith(ENGINE_SUFFIX)):
            continue
        try:
            build_cfg, dev = deserialize_config(path)
        except (json.JSONDecodeError, KeyError):
            continue
        if dev != want_device:
            continue
        if is_compatible(render_config, build_cfg) and is_warm(
            render_config, build_cfg
        ):
            if is_optimized(render_config, build_cfg):
                return path, build_cfg
            if best is None:
                best = (path, build_cfg)
    return best
