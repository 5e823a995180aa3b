"""Weight bridge: the JAX package's flat flax param store -> torch state_dict.

The port reads the same weight files as the JAX package (flat ``.npz`` of
float32 arrays keyed by '/'-joined flax paths, ``registry.load_params``) and
maps them onto its ``nn.Module`` names with ``swin_mapping``, a copy of
``waifu2x_tensorrt_tpu.models.convert.swin_mapping``: the torch names are
the table's left column (``swin1.block0.attn.qkv``, ...), the flax paths its
right column.

Layout rules (exact inverses of the JAX package's converters):
- flax Conv kernel (kH, kW, I, O) -> torch Conv2d weight (O, I, kH, kW);
- flax Dense kernel (I, O)        -> torch Linear weight (O, I);
- LayerNorm ``scale`` -> ``weight``; relative-position tables unchanged.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "inv_conv_weight",
    "inv_dense_weight",
    "swin_mapping",
    "swin_depths_from_flax",
    "params_from_flax",
]


def inv_conv_weight(k: np.ndarray) -> np.ndarray:
    """flax (kH, kW, I, O) -> torch (O, I, kH, kW)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def inv_dense_weight(k: np.ndarray) -> np.ndarray:
    """flax (I, O) -> torch (O, I)."""
    return np.ascontiguousarray(np.asarray(k).T)


def swin_mapping(scale: int,
                 depths=(2, 2, 6, 2, 2)) -> list[tuple[str, str, str]]:
    """(torch_path, flax_path, kind) for the SwinUNet reconstruction.
    kind: conv | dense | norm | table. ``scale`` does not change the
    table (the head width follows from the weights)."""
    entries: list[tuple[str, str, str]] = [
        ("patch_conv1", "patch_conv1", "conv"),
        ("patch_conv2", "patch_conv2", "conv"),
        ("down1", "down1", "conv"),
        ("down2", "down2", "conv"),
        ("up2", "up2", "dense"),
        ("up1", "up1", "dense"),
        ("to_image", "to_image", "conv"),
    ]
    for stage, depth in (("swin1", depths[0]), ("swin2", depths[2]),
                         ("swin3", depths[3])):
        for i in range(depth):
            b = f"{stage}.block{i}"
            fb = f"{stage}/block{i}"
            entries += [
                (f"{b}.norm1", f"{fb}/norm1", "norm"),
                (f"{b}.attn.qkv", f"{fb}/attn/qkv", "dense"),
                (f"{b}.attn.proj", f"{fb}/attn/proj", "dense"),
                (f"{b}.attn.relative_position_bias_table",
                 f"{fb}/attn/relative_position_bias", "table"),
                (f"{b}.norm2", f"{fb}/norm2", "norm"),
                (f"{b}.mlp_fc1", f"{fb}/mlp_fc1", "dense"),
                (f"{b}.mlp_fc2", f"{fb}/mlp_fc2", "dense"),
            ]
    return entries


def swin_depths_from_flax(flat: Mapping[str, np.ndarray]) -> tuple:
    """The 5-slot ``depths`` tuple of a flat flax swin tree, counted from
    its ``swinK/blockI`` keys (slot 1 is unused by the architecture and
    mirrors slot 0, as the JAX loader builds it)."""
    count = {"swin1": 0, "swin2": 0, "swin3": 0}
    for key in flat:
        m = re.match(r"(swin[123])/block(\d+)/", key)
        if m:
            count[m.group(1)] = max(count[m.group(1)], int(m.group(2)) + 1)
    d1, d2, d3 = count["swin1"], count["swin2"], count["swin3"]
    return (d1, d1, d2, d3, d3)


def params_from_flax(flat: Mapping[str, np.ndarray],
                     scale: int = 4) -> dict[str, torch.Tensor]:
    """torch state_dict (float32 CPU tensors) of the port's ``SwinUNet`` from
    a flat flax param dict (``registry.load_params`` layout) — the port's
    copy of ``state_from_flax(flat, swin_mapping(...))``."""
    mapping = swin_mapping(scale, swin_depths_from_flax(flat))
    state: dict[str, np.ndarray] = {}
    for src, dst, kind in mapping:
        if kind == "table":
            state[src] = np.asarray(flat[dst])
            continue
        if kind == "conv":
            state[f"{src}.weight"] = inv_conv_weight(flat[f"{dst}/kernel"])
        elif kind == "dense":
            state[f"{src}.weight"] = inv_dense_weight(flat[f"{dst}/kernel"])
        elif kind == "norm":
            state[f"{src}.weight"] = np.asarray(flat[f"{dst}/scale"])
        state[f"{src}.bias"] = np.asarray(flat[f"{dst}/bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state.items()}
