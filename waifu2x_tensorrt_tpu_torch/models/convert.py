"""Weight bridge: the JAX package's flat flax param store -> torch state_dict.

The port reads the same weight files as the JAX package (flat ``.npz`` of
float32 arrays keyed by '/'-joined flax paths, ``registry.load_params``) and
maps them onto its ``nn.Module`` names with ``swin_mapping`` and
``cunet_mapping``, copies of the tables of
``waifu2x_tensorrt_tpu.models.convert``: the torch names are a table's left
column (``swin1.block0.attn.qkv``, ``unet1.conv2.conv.4.conv1``, ...,
upstream's names), the flax paths its right column.

Layout rules (exact inverses of the JAX package's converters):
- flax Conv kernel (kH, kW, I, O) -> torch Conv2d weight (O, I, kH, kW);
- flax ConvTranspose kernel (kH, kW, I, O) -> torch ConvTranspose2d
  weight (I, O, kH, kW) with the spatial taps flipped (flax applies the
  kernel unflipped, ``transpose_kernel=False``; torch's transposed conv is
  the gradient of a conv and applies it flipped);
- flax Dense kernel (I, O)        -> torch Linear weight (O, I); the cunet
  squeeze-and-excitation Dense layers are 1x1 Conv2d upstream and in the
  port, weight (O, I, 1, 1);
- LayerNorm ``scale`` -> ``weight``; relative-position tables unchanged.

The forward direction (torch/ONNX layouts -> flat flax-named dicts:
``conv_weight``, ``conv_transpose_weight``, ``dense_weight``,
``swin_from_torch``, ``cunet_from_torch``, ``cunet_from_onnx``) and
``state_from_flax`` (the inverse, used by load-time artifact
verification to re-export converted weights) are copies of the JAX
package's converters. Every converter here returns or takes the FLAT
dict ('/'-joined flax paths -> float32 arrays) that ``registry.load_into``
and the ``.npz`` store use, never a nested tree.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "conv_transpose_weight",
    "conv_weight",
    "cunet_from_onnx",
    "cunet_from_torch",
    "cunet_mapping",
    "dense_weight",
    "inv_conv_transpose_weight",
    "inv_conv_weight",
    "inv_dense_weight",
    "is_cunet_tree",
    "params_from_flax",
    "state_from_flax",
    "swin_depths_from_flax",
    "swin_from_torch",
    "swin_mapping",
]


def conv_weight(w: np.ndarray) -> np.ndarray:
    """(O, I, kH, kW) -> (kH, kW, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def conv_transpose_weight(w: np.ndarray) -> np.ndarray:
    """(I, O, kH, kW) -> (kH, kW, I, O), spatial taps flipped."""
    w = w[:, :, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def dense_weight(w: np.ndarray) -> np.ndarray:
    """(O, I) or (O, I, 1, 1) -> (I, O)."""
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    return np.ascontiguousarray(w.T)


def inv_conv_weight(k: np.ndarray) -> np.ndarray:
    """flax (kH, kW, I, O) -> torch (O, I, kH, kW)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def inv_conv_transpose_weight(k: np.ndarray) -> np.ndarray:
    """flax (kH, kW, I, O) -> torch (I, O, kH, kW), spatial taps flipped."""
    w = np.transpose(k, (2, 3, 0, 1))
    return np.ascontiguousarray(w[:, :, ::-1, ::-1])


def inv_dense_weight(k: np.ndarray) -> np.ndarray:
    """flax (I, O) -> torch (O, I)."""
    return np.ascontiguousarray(np.asarray(k).T)


def _unet_conv_entries(src_prefix: str, dst_prefix: str, se: bool):
    """UNetConv: nn.Sequential(conv, lrelu, conv, lrelu[, SEBlock])."""
    entries = [
        (f"{src_prefix}.conv.0", f"{dst_prefix}/conv0", "conv"),
        (f"{src_prefix}.conv.2", f"{dst_prefix}/conv1", "conv"),
    ]
    if se:
        entries += [
            (f"{src_prefix}.conv.4.conv1", f"{dst_prefix}/se/fc1", "dense"),
            (f"{src_prefix}.conv.4.conv2", f"{dst_prefix}/se/fc2", "dense"),
        ]
    return entries


def _unet1_entries(prefix: str):
    return (
        _unet_conv_entries(f"{prefix}.conv1", f"{prefix}/conv1", se=False)
        + [(f"{prefix}.conv1_down", f"{prefix}/conv1_down", "conv")]
        + _unet_conv_entries(f"{prefix}.conv2", f"{prefix}/conv2", se=True)
        + [
            (f"{prefix}.conv2_up", f"{prefix}/conv2_up", "deconv"),
            (f"{prefix}.conv3", f"{prefix}/conv3", "conv"),
        ]
    )


def _unet2_entries(prefix: str):
    return (
        _unet_conv_entries(f"{prefix}.conv1", f"{prefix}/conv1", se=False)
        + [(f"{prefix}.conv1_down", f"{prefix}/conv1_down", "conv")]
        + _unet_conv_entries(f"{prefix}.conv2", f"{prefix}/conv2", se=True)
        + [(f"{prefix}.conv2_down", f"{prefix}/conv2_down", "conv")]
        + _unet_conv_entries(f"{prefix}.conv3", f"{prefix}/conv3", se=True)
        + [(f"{prefix}.conv3_up", f"{prefix}/conv3_up", "deconv")]
        + _unet_conv_entries(f"{prefix}.conv4", f"{prefix}/conv4", se=True)
        + [
            (f"{prefix}.conv4_up", f"{prefix}/conv4_up", "deconv"),
            (f"{prefix}.conv5", f"{prefix}/conv5", "conv"),
        ]
    )


def cunet_mapping(scale: int) -> list[tuple[str, str, str]]:
    """(torch_path, flax_path, kind) for CUNet (1x) / UpCUNet (2x).
    kind: conv | deconv | dense; UNet1's conv_bottom is a deconv for the
    2x model (k4s2p3 head) and a conv for 1x."""
    entries = _unet1_entries("unet1")
    entries.append(
        ("unet1.conv_bottom", "unet1/conv_bottom",
         "deconv" if scale == 2 else "conv")
    )
    entries += _unet2_entries("unet2")
    entries.append(("unet2.conv_bottom", "unet2/conv_bottom", "conv"))
    return entries


_KIND_TRANSFORM = {
    "conv": conv_weight,
    "deconv": conv_transpose_weight,
    "dense": dense_weight,
}


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def cunet_from_torch(state_dict: Mapping[str, "object"],
                     scale: int) -> dict[str, np.ndarray]:
    """Flat flax dict of a torch CUNet/UpCUNet state_dict (names of
    ``cunet_mapping``'s left column)."""
    flat: dict[str, np.ndarray] = {}
    for src, dst, kind in cunet_mapping(scale):
        w = _to_np(state_dict[f"{src}.weight"])
        flat[f"{dst}/kernel"] = _KIND_TRANSFORM[kind](w).astype(np.float32)
        bias_key = f"{src}.bias"
        if bias_key in state_dict:
            flat[f"{dst}/bias"] = _to_np(
                state_dict[bias_key]).astype(np.float32)
    return flat


def cunet_from_onnx(path, scale: int) -> dict[str, np.ndarray]:
    """Flat flax dict of an ONNX export whose initializer names follow the
    torch module paths."""
    from waifu2x_tensorrt_tpu_torch.models.onnx_reader import (
        read_initializers,
    )

    return cunet_from_torch(read_initializers(path), scale)


def is_cunet_tree(flat: Mapping[str, np.ndarray]) -> bool:
    """True for the flat tree of a cunet model (its keys start with
    ``unet1/``), False for a swin tree."""
    return any(k.startswith("unet1/") for k in flat)


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


def swin_from_torch(state_dict: Mapping[str, "object"], scale: int,
                    depths=(2, 2, 6, 2, 2),
                    strict: bool = True) -> dict[str, np.ndarray]:
    """Flat flax dict of a torch SwinUNet state_dict (names of
    ``swin_mapping``'s left column). ``strict=False`` skips mapping
    entries absent from the state_dict."""
    flat: dict[str, np.ndarray] = {}
    for src, dst, kind in swin_mapping(scale, depths):
        probe_key = src if kind == "table" else f"{src}.weight"
        if probe_key not in state_dict:
            if strict:
                raise KeyError(f"missing source weight {probe_key!r}")
            continue
        if kind == "table":
            flat[dst] = _to_np(state_dict[src]).astype(np.float32)
            continue
        w = _to_np(state_dict[f"{src}.weight"]).astype(np.float32)
        if kind == "conv":
            flat[f"{dst}/kernel"] = conv_weight(w)
        elif kind == "dense":
            flat[f"{dst}/kernel"] = dense_weight(w)
        elif kind == "norm":
            flat[f"{dst}/scale"] = w
        bias_key = f"{src}.bias"
        if bias_key in state_dict:
            flat[f"{dst}/bias"] = _to_np(
                state_dict[bias_key]).astype(np.float32)
    return flat


def state_from_flax(flat: Mapping[str, np.ndarray],
                    mapping: list) -> dict[str, np.ndarray]:
    """The torch-style state_dict arrays an upstream checkpoint or export
    would hold, from a flat flax dict and a (torch_prefix, flax_path,
    kind) mapping: the exact inverse of ``swin_from_torch`` /
    ``cunet_from_torch``."""
    state: dict[str, np.ndarray] = {}
    for src, dst, kind in mapping:
        if kind == "table":
            state[src] = np.asarray(flat[dst])
            continue
        if kind == "conv":
            state[f"{src}.weight"] = inv_conv_weight(flat[f"{dst}/kernel"])
        elif kind == "deconv":
            state[f"{src}.weight"] = inv_conv_transpose_weight(
                flat[f"{dst}/kernel"])
        elif kind == "dense":
            w = inv_dense_weight(flat[f"{dst}/kernel"])
            if ".conv.4." in src:  # SE blocks are 1x1 convs upstream
                w = w[:, :, None, None]
            state[f"{src}.weight"] = np.ascontiguousarray(w)
        elif kind == "norm":
            state[f"{src}.weight"] = np.asarray(flat[f"{dst}/scale"])
        bias = flat.get(f"{dst}/bias")
        if bias is not None:
            state[f"{src}.bias"] = np.asarray(bias)
    return state


def params_from_flax(flat: Mapping[str, np.ndarray],
                     scale: int = 4) -> dict[str, torch.Tensor]:
    """torch state_dict (float32 CPU tensors) of the port's ``SwinUNet`` or
    ``CUNet``/``UpCUNet`` (by the tree's keys, ``is_cunet_tree``) from a
    flat flax param dict (``registry.load_params`` layout):
    ``state_from_flax`` with the module's mapping."""
    mapping = (cunet_mapping(scale) if is_cunet_tree(flat)
               else swin_mapping(scale, swin_depths_from_flax(flat)))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state_from_flax(flat, mapping).items()}
