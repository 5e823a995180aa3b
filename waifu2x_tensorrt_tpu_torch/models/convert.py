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
    "dat_arch_from_flax",
    "dat_from_torch",
    "dat_mapping",
    "dense_weight",
    "hat_arch_from_flax",
    "hat_mapping",
    "inv_conv_transpose_weight",
    "inv_conv_weight",
    "inv_dense_weight",
    "is_cunet_tree",
    "is_dat_tree",
    "is_hat_tree",
    "is_mambair_tree",
    "mambair_arch_from_flax",
    "mambair_from_torch",
    "mambair_mapping",
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


def hat_mapping(depths=(6,) * 6) -> list[tuple[str, str, str]]:
    """(torch_path, flax_path, kind) for HAT (``models/hat.py``), whose
    torch paths are those of HAT's own state dict (XPixelGroup/HAT
    ``hat_arch.py``): the flat path is the torch path '/'-joined, and a
    relative-position table ``relative_position_bias_table`` is flat
    ``relative_position_bias``. kind: conv | dense | norm | table; the
    channel attention's 1x1 convs are dense."""
    names: list[tuple[str, str]] = [("conv_first", "conv"),
                                    ("patch_embed.norm", "norm")]
    mlp = [("norm2", "norm"), ("mlp.fc1", "dense"), ("mlp.fc2", "dense")]
    hab = [("norm1", "norm"), ("attn.qkv", "dense"), ("attn.proj", "dense"),
           ("attn.relative_position_bias_table", "table"),
           ("conv_block.cab.0", "conv"), ("conv_block.cab.2", "conv"),
           ("conv_block.cab.3.attention.1", "dense"),
           ("conv_block.cab.3.attention.3", "dense")] + mlp
    ocab = [("norm1", "norm"), ("qkv", "dense"),
            ("relative_position_bias_table", "table"),
            ("proj", "dense")] + mlp
    for i, depth in enumerate(depths):
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            names += [(f"{g}.blocks.{j}.{n}", k) for n, k in hab]
        names += [(f"{g}.overlap_attn.{n}", k) for n, k in ocab]
        names.append((f"layers.{i}.conv", "conv"))
    names += [("norm", "norm"), ("conv_after_body", "conv"),
              ("conv_before_upsample.0", "conv")]
    names += [("upsample.0", "conv"), ("upsample.2", "conv"),
              ("conv_last", "conv")]
    return [(src, src.replace(".", "/").replace(
        "relative_position_bias_table", "relative_position_bias"), kind)
        for src, kind in names]


def is_hat_tree(keys) -> bool:
    """True for the flat tree (or its keys) of a HAT model."""
    return not is_mambair_tree(keys) and any(
        k.startswith("layers/") and "/residual_group/" in k for k in keys)


def mambair_mapping(depths=(6,) * 6) -> list[tuple[str, str, str]]:
    """(torch_path, flax_path, kind) for MambaIR (``models/mambair.py``),
    whose torch paths are those of MambaIR's own state dict
    (csguoh/MambaIR ``mambair_arch.py``). kind: conv | dense | norm |
    table | stack. The flat path is the torch path '/'-joined, except for
    the parameters that are no layer's weight and bias (their torch path is
    the parameter's): ``A_logs`` and ``dt_projs_bias`` are tables at
    ``.../A_logs/value`` and ``.../dt_projs_bias/value``, ``Ds``,
    ``skip_scale`` and ``skip_scale2`` tables at ``.../<name>/scale``, and
    the stacked per-direction projections ``x_proj_weight`` (4, R + 2N,
    D) and ``dt_projs_weight`` (4, D, R) are ``stack`` entries, one dense
    kernel a direction at ``.../x_proj/<k>/kernel`` (D, R + 2N) and
    ``.../dt_projs/<k>/kernel`` (R, D). ``in_proj`` and ``out_proj`` have
    no bias; the CAB's pooled-gate 1x1 convs are dense."""
    names: list[tuple[str, str, str]] = [
        ("conv_first", "conv_first", "conv"),
        ("patch_embed.norm", "patch_embed/norm", "norm")]
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            a = f"{b}.self_attention"
            fa = a.replace(".", "/")
            names += [(f"{b}.ln_1", "", "norm"),
                      (f"{a}.in_proj", "", "dense"),
                      (f"{a}.conv2d", "", "conv"),
                      (f"{a}.x_proj_weight", f"{fa}/x_proj", "stack"),
                      (f"{a}.dt_projs_weight", f"{fa}/dt_projs", "stack"),
                      (f"{a}.dt_projs_bias", f"{fa}/dt_projs_bias/value",
                       "table"),
                      (f"{a}.A_logs", f"{fa}/A_logs/value", "table"),
                      (f"{a}.Ds", f"{fa}/Ds/scale", "table"),
                      (f"{a}.out_norm", "", "norm"),
                      (f"{a}.out_proj", "", "dense"),
                      (f"{b}.skip_scale", f"{b}/skip_scale/scale"
                       .replace(".", "/"), "table"),
                      (f"{b}.conv_blk.cab.0", "", "conv"),
                      (f"{b}.conv_blk.cab.2", "", "conv"),
                      (f"{b}.conv_blk.cab.3.attention.1", "", "dense"),
                      (f"{b}.conv_blk.cab.3.attention.3", "", "dense"),
                      (f"{b}.ln_2", "", "norm"),
                      (f"{b}.skip_scale2", f"{b}/skip_scale2/scale"
                       .replace(".", "/"), "table")]
        names.append((f"layers.{i}.conv", "", "conv"))
    names += [("norm", "", "norm"), ("conv_after_body", "", "conv"),
              ("conv_before_upsample.0", "", "conv"),
              ("upsample.0", "", "conv"), ("upsample.2", "", "conv"),
              ("conv_last", "", "conv")]
    return [(src, dst or src.replace(".", "/"), kind)
            for src, dst, kind in names]


def is_mambair_tree(keys) -> bool:
    """True for the flat tree (or its keys) of a MambaIR model."""
    return any("/self_attention/" in k for k in keys)


def mambair_arch_from_flax(flat: Mapping[str, np.ndarray]) -> dict:
    """``models.mambair.MambaIR``'s widths of a flat MambaIR tree: width,
    state size and expansion from the first block's arrays, the group
    depths counted from its keys."""
    depths: dict[int, int] = {}
    for key in flat:
        m = re.match(r"layers/(\d+)/residual_group/blocks/(\d+)/", key)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            depths[i] = max(depths.get(i, 0), j + 1)
    a = "layers/0/residual_group/blocks/0/self_attention"
    c = int(flat["conv_first/kernel"].shape[-1])
    return {"embed_dim": c,
            "depths": tuple(depths[i] for i in sorted(depths)),
            "d_state": int(flat[f"{a}/A_logs/value"].shape[-1]),
            "expand": int(flat[f"{a}/in_proj/kernel"].shape[-1]) // (2 * c)}


def mambair_from_torch(state_dict: Mapping[str, "object"],
                       depths=(6,) * 6) -> dict[str, np.ndarray]:
    """Flat flax dict of a MambaIR checkpoint's state dict (MambaIR's own
    names; the CAB's 1x1 convs (O, I, 1, 1) or dense (O, I))."""
    flat: dict[str, np.ndarray] = {}
    for src, dst, kind in mambair_mapping(depths):
        if kind == "table":
            flat[dst] = _to_np(state_dict[src]).astype(np.float32)
            continue
        if kind == "stack":
            for k, w in enumerate(_to_np(state_dict[src])):
                flat[f"{dst}/{k}/kernel"] = dense_weight(
                    w.astype(np.float32))
            continue
        w = _to_np(state_dict[f"{src}.weight"]).astype(np.float32)
        if kind == "norm":
            flat[f"{dst}/scale"] = w
        else:
            flat[f"{dst}/kernel"] = _KIND_TRANSFORM[kind](w)
        if f"{src}.bias" in state_dict:
            flat[f"{dst}/bias"] = _to_np(
                state_dict[f"{src}.bias"]).astype(np.float32)
    return flat


BN_EPS = 1e-5  # DAT's BatchNorm2d eps


def dat_mapping(depths=(6,) * 6) -> list[tuple[str, str, str]]:
    """(torch_path, flax_path, kind) for DAT (``models/dat.py``), whose
    torch paths are those of DAT's own state dict (zhengchen1999/DAT
    ``dat_arch.py``): the flat path is the torch path '/'-joined. kind:
    conv | dense | norm | bn | table; the interaction maps' 1x1 convs are
    dense, a BatchNorm (``bn``) is held folded (flat ``scale`` and
    ``bias``, ``dat_from_torch``), a DCTB's ``temperature`` is a table
    (copied as it is)."""
    names: list[tuple[str, str]] = [("conv_first", "conv"),
                                    ("before_RG.1", "norm")]
    aim = [("attn.qkv", "dense"), ("attn.proj", "dense"),
           ("attn.dwconv.0", "conv"), ("attn.dwconv.1", "bn"),
           ("attn.channel_interaction.1", "dense"),
           ("attn.channel_interaction.2", "bn"),
           ("attn.channel_interaction.4", "dense"),
           ("attn.spatial_interaction.0", "dense"),
           ("attn.spatial_interaction.1", "bn"),
           ("attn.spatial_interaction.3", "dense")]
    pos = [("pos_proj", "dense"), ("pos1.0", "norm"), ("pos1.2", "dense"),
           ("pos2.0", "norm"), ("pos2.2", "dense"), ("pos3.0", "norm"),
           ("pos3.2", "dense")]
    ffn = [("norm2", "norm"), ("ffn.fc1", "dense"), ("ffn.sg.norm", "norm"),
           ("ffn.sg.conv", "conv"), ("ffn.fc2", "dense")]
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            names += [(f"{b}.norm1", "norm")]
            names += [(f"{b}.{n}", k) for n, k in aim]
            if j % 2 == 0:
                names += [(f"{b}.attn.attns.{a}.pos.{n}", k)
                          for a in range(2) for n, k in pos]
            else:
                names.append((f"{b}.attn.temperature", "table"))
            names += [(f"{b}.{n}", k) for n, k in ffn]
        names.append((f"layers.{i}.conv", "conv"))
    names += [("norm", "norm"), ("conv_after_body", "conv"),
              ("conv_before_upsample.0", "conv")]
    names += [("upsample.0", "conv"), ("upsample.2", "conv"),
              ("conv_last", "conv")]
    return [(src, src.replace(".", "/"), kind) for src, kind in names]


def is_dat_tree(keys) -> bool:
    """True for the flat tree (or its keys) of a DAT model."""
    return any(k.startswith("before_RG/") for k in keys)


def dat_arch_from_flax(flat: Mapping[str, np.ndarray]) -> dict:
    """``models.dat.DAT``'s widths of a flat DAT tree: width, heads (twice
    a branch's position-MLP outputs) and expansion from the first block's
    arrays, the group depths counted from its keys."""
    depths: dict[int, int] = {}
    for key in flat:
        m = re.match(r"layers/(\d+)/blocks/(\d+)/", key)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            depths[i] = max(depths.get(i, 0), j + 1)
    b = "layers/0/blocks/0"
    c = int(flat["conv_first/kernel"].shape[-1])
    heads = flat[f"{b}/attn/attns/0/pos/pos3/2/kernel"].shape[-1]
    return {"embed_dim": c,
            "depths": tuple(depths[i] for i in sorted(depths)),
            "num_heads": 2 * int(heads),
            "expansion": int(flat[f"{b}/ffn/fc1/kernel"].shape[-1]) // c}


def dat_from_torch(state_dict: Mapping[str, "object"],
                   depths=(6,) * 6) -> dict[str, np.ndarray]:
    """Flat flax dict of a DAT checkpoint's state dict (DAT's own names;
    buffers such as ``rpe_biases``, ``relative_position_index``,
    ``attn_mask_*`` and ``num_batches_tracked`` are not read). A
    BatchNorm is folded into its inference form: ``scale`` = weight /
    sqrt(running_var + 1e-5), ``bias`` = bias - running_mean scale."""
    flat: dict[str, np.ndarray] = {}
    for src, dst, kind in dat_mapping(depths):
        if kind == "table":
            flat[dst] = _to_np(state_dict[src]).astype(np.float32)
            continue
        w = _to_np(state_dict[f"{src}.weight"]).astype(np.float64)
        b = _to_np(state_dict[f"{src}.bias"]).astype(np.float64)
        if kind == "bn":
            var = _to_np(state_dict[f"{src}.running_var"]).astype(np.float64)
            mean = _to_np(state_dict[f"{src}.running_mean"]).astype(
                np.float64)
            scale = w / np.sqrt(var + BN_EPS)
            flat[f"{dst}/scale"] = scale.astype(np.float32)
            flat[f"{dst}/bias"] = (b - mean * scale).astype(np.float32)
            continue
        if kind == "conv":
            flat[f"{dst}/kernel"] = conv_weight(w.astype(np.float32))
        elif kind == "dense":
            flat[f"{dst}/kernel"] = dense_weight(w.astype(np.float32))
        else:  # norm
            flat[f"{dst}/scale"] = w.astype(np.float32)
        flat[f"{dst}/bias"] = b.astype(np.float32)
    return flat


def hat_arch_from_flax(flat: Mapping[str, np.ndarray]) -> dict:
    """``models.hat.HAT``'s widths of a flat HAT tree: width and heads
    from the first group's arrays, the group depths counted from its
    keys."""
    depths: dict[int, int] = {}
    for key in flat:
        m = re.match(r"layers/(\d+)/residual_group/blocks/(\d+)/", key)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            depths[i] = max(depths.get(i, 0), j + 1)
    table = flat["layers/0/residual_group/blocks/0/attn/"
                 "relative_position_bias"].shape
    return {"embed_dim": int(flat["conv_first/kernel"].shape[-1]),
            "depths": tuple(depths[i] for i in sorted(depths)),
            "num_heads": int(table[-1])}


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
        if kind == "stack":  # one dense kernel a slice of the stack
            state[src] = np.stack([
                inv_dense_weight(flat[f"{dst}/{k}/kernel"])
                for k in range(sum(key.startswith(f"{dst}/")
                                   for key in flat))])
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
        elif kind in ("norm", "bn"):  # a bn is held folded
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
