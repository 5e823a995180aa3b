"""Config hashing for engine sidecars.

The port's copy of ``waifu2x_tensorrt_tpu.utils.hashing``. Reference:
getConfigHash (src/tensorrt/img2img_build.cpp:8-27) hashes
``deviceName.PRECISION.minB.optB.maxB.minC...maxH`` with SHA-256 and uses
the first 16 hex chars in the engine file name. The string layout is the
JAX package's, with the CUDA device name (``torch.cuda.get_device_name``)
as the device name, and ``"cpu"`` for a CPU device as in the JAX package,
so on the CPU both packages name a profile's sidecar alike.
"""

from __future__ import annotations

import hashlib

import torch

from waifu2x_tensorrt_tpu_torch.engine.config import BuildConfig


def device_kind(device=0) -> str:
    """The device name folded into the key: ``"cpu"`` for a CPU device
    (or a device index when no CUDA device exists), else the CUDA device's
    name (reference cudaGetDeviceName, helper.h:12-57)."""
    if not isinstance(device, int):
        device = torch.device(device)
        if device.type == "cpu":
            return "cpu"
        device = device.index or 0
    if not torch.cuda.is_available():
        return "cpu"
    n = torch.cuda.device_count()
    if not 0 <= device < n:
        # fail loudly like the reference (cudaSetDevice on a bad id):
        # clamping would key engines on a device the user did not select
        raise ValueError(f"device id {device} out of range (have {n})")
    return torch.cuda.get_device_name(device)


def config_hash(config: BuildConfig, device_name: str | None = None) -> str:
    name = (device_name if device_name is not None
            else device_kind(config.device_id))
    name = "".join(name.split())  # strip whitespace like the reference
    parts = [
        name,
        config.precision.cache_tag,
        str(config.min_batch_size),
        str(config.opt_batch_size),
        str(config.max_batch_size),
        str(config.min_channels),
        str(config.opt_channels),
        str(config.max_channels),
        str(config.min_width),
        str(config.opt_width),
        str(config.max_width),
        str(config.min_height),
        str(config.opt_height),
        str(config.max_height),
    ]
    return hashlib.sha256(".".join(parts).encode()).hexdigest()


def short_hash(config: BuildConfig, device_name: str | None = None) -> str:
    """First 16 hex chars — the engine file name tag
    (img2img_build.cpp:151)."""
    return config_hash(config, device_name)[:16]
