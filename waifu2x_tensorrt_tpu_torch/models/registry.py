"""Model registry: families, scale/noise validation, weight files.

The port's copy of ``waifu2x_tensorrt_tpu.models.registry``: the
reference's model-choice surface (src/main.cpp:26-53), its weight-path
convention (``models/{family}/[noise{N}_][scale{S}x].npz``) and the same
flat ``.npz`` weight store ('/'-joined flax paths -> float32 arrays), so
both packages read each other's files.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

MODEL_FAMILIES = (
    "cunet/art",
    "swin_unet/art",
    "swin_unet/art_scan",
    "swin_unet/photo",
)
# families of the port alone (the JAX package has no counterpart), beside
# the reference's surface above: each a 4x model without denoising, by
# its tile divisor (tiles are whole windows: nothing is padded inside)
# and the reason it refuses what ``refused_option`` names
_PORT = {
    "hat/photo": (16, "its attention kernel G is bf16 only and it serves "
                      "from .npz weights with the pixel head"),
    "dat/photo": (32, "its attention kernels G and J are bf16 only and it "
                      "serves from .npz weights with the pixel head"),
    "mambair/photo": (1, "its selective-scan kernel K is bf16 only and it "
                         "serves from .npz weights with the pixel head"),
}
PORT_FAMILIES = tuple(_PORT)
FAMILIES = MODEL_FAMILIES + PORT_FAMILIES

NOISE_LEVELS = (-1, 0, 1, 2, 3)
SCALES = (1, 2, 4)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static geometry contract between a model and the tiler."""

    family: str
    scale: int
    noise: int
    offset: int  # per-side output-space context shrink (0 for swin_unet)
    tile_divisor: int  # input tile size must be a multiple of this
    # pack_x > 1: the model emits (oh, ow/pack_x, 3*pack_x) tiles whose
    # bytes are the (oh, ow, 3) pixel tiles' (ops/head_pack.py). Requires
    # all output x-origins % pack_x == 0.
    pack_x: int = 1

    def output_tile(self, input_tile: int) -> int:
        """Model output spatial size for a given input tile."""
        return input_tile * self.scale - 2 * self.offset

    @property
    def arch(self) -> str:
        return self.family.split("/")[0]


def validate(family: str, scale: int, noise: int) -> None:
    """CLI-parity semantic validation (src/main.cpp:142-145)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown model {family!r}; choices: {FAMILIES}")
    if scale not in SCALES:
        raise ValueError(f"scale must be one of {SCALES}, got {scale}")
    if noise not in NOISE_LEVELS:
        raise ValueError(f"noise must be one of {NOISE_LEVELS}, got {noise}")
    if family == "cunet/art" and scale == 4:
        raise ValueError("cunet/art does not support scale factor 4.")
    if noise == -1 and scale == 1:
        raise ValueError("Noise level -1 does not support scale factor 1.")
    if family in PORT_FAMILIES and (scale, noise) != (4, -1):
        raise ValueError(f"{family} is a 4x model without denoising: "
                         "scale 4 and noise -1 only.")


def refused_option(family: str, *, fp32: bool = False,
                   graph_exact: bool = False, onnx: bool = False,
                   pack_x: bool = False) -> Optional[str]:
    """The first option the family cannot run with, by its CLI name, or
    None. The port's own families (hat/photo: kernel G; dat/photo:
    kernels G and J; mambair/photo: kernel K; all bf16 only) run through
    their own modules: no ``--precision tf32``, no ``.onnx`` artifact
    (``build``, ``--graph-exact``) and no packed-x head
    (``refusal_reason`` says why)."""
    if family not in PORT_FAMILIES:
        return None
    for hit, name in ((fp32, "--precision tf32"),
                      (graph_exact, "--graph-exact"),
                      (onnx, ".onnx artifacts"),
                      (pack_x, "the packed-x head (WAIFU2X_PACK_X=1)")):
        if hit:
            return name
    return None


def refusal_reason(family: str) -> str:
    """Why a family refuses the options ``refused_option`` names."""
    return _PORT[family][1]


def widths_from_file(family: str) -> bool:
    """Does the family take its widths from its weight file
    (``checkpoint_arch``)? Every family but cunet, whose widths are
    fixed."""
    return family.split("/")[0] != "cunet"


def get_spec(family: str, scale: int, noise: int = -1) -> ModelSpec:
    validate(family, scale, noise)
    if family.split("/")[0] == "cunet":
        return ModelSpec(family, scale, noise, offset={1: 28, 2: 36}[scale],
                         tile_divisor=4)
    if family in PORT_FAMILIES:
        # no padding inside: tiles are whole windows
        return ModelSpec(family, scale, noise, offset=0,
                         tile_divisor=_PORT[family][0])
    # swin_unet pads internally to /32; any tile size works, offset 0
    return ModelSpec(family, scale, noise, offset=0, tile_divisor=1)


def model_file_stem(scale: int, noise: int) -> str:
    """Weight-file stem: ``[noise{N}_][scale{S}x]`` (src/main.cpp:201-204)."""
    stem = ""
    if noise != -1:
        stem += f"noise{noise}_"
    if scale != 1:
        stem += f"scale{scale}x"
    return stem.rstrip("_") if stem else "noise-1"


def create_model(family: str, scale: int, noise: int = -1,
                 dtype: Optional[torch.dtype] = None,
                 fused_block: bool = False,
                 base_dim: Optional[int] = None,
                 depths: Optional[tuple] = None,
                 device=None, packed_x_head: bool = False,
                 hat_arch: Optional[dict] = None,
                 dat_arch: Optional[dict] = None,
                 mambair_arch: Optional[dict] = None):
    """Build the torch module + spec for a (family, scale, noise) choice.

    cunet/art gives ``CUNet`` (scale 1) or ``UpCUNet`` (scale 2); the
    swin_unet options below do not apply to it. hat/photo gives ``HAT``
    at its published widths, or those of ``hat_arch`` (``HAT``'s keyword
    arguments, ``checkpoint_arch``), dat/photo ``DAT`` at its published
    widths or those of ``dat_arch``, mambair/photo ``MambaIR`` at its
    published widths or those of ``mambair_arch``; none has a packed-x
    head.
    ``fused_block`` routes every Swin block through kernel B
    (ops/swin_block.py); otherwise the blocks are dense math around
    kernel A (ops/window_attention.py).
    ``base_dim``/``depths`` override the flagship architecture (96,
    (2, 2, 6, 2, 2)). ``packed_x_head`` (scale > 1 only) gives the
    packed-x head (``packed_x_twin``)."""
    from waifu2x_tensorrt_tpu_torch.models.cunet import CUNet, UpCUNet
    from waifu2x_tensorrt_tpu_torch.models.dat import DAT
    from waifu2x_tensorrt_tpu_torch.models.hat import HAT
    from waifu2x_tensorrt_tpu_torch.models.mambair import MambaIR
    from waifu2x_tensorrt_tpu_torch.models.swin_unet import SwinUNet

    spec = get_spec(family, scale, noise)
    if family in PORT_FAMILIES:
        if packed_x_head:
            raise ValueError(f"{family} has no packed-x head")
        cls, arch = {"hat": (HAT, hat_arch), "dat": (DAT, dat_arch),
                     "mambair": (MambaIR, mambair_arch)}[spec.arch]
        module = cls(dtype=dtype or torch.float32, device=device,
                     **(arch or {})).eval()
        return module, spec
    if spec.arch == "cunet":
        module = (CUNet if scale == 1 else UpCUNet)(
            dtype=dtype or torch.float32, device=device).eval()
        return module, spec
    kw = {}
    if base_dim is not None:
        kw["base_dim"] = int(base_dim)
    if depths is not None:
        kw["depths"] = tuple(int(d) for d in depths)
    module = SwinUNet(scale=scale, dtype=dtype or torch.float32,
                      fused_block=fused_block, device=device, **kw).eval()
    if packed_x_head and scale > 1:
        return packed_x_twin(module, spec)
    return module, spec


def packed_x_twin(module, spec: ModelSpec):
    """(module, spec) of the packed-x head over the SAME parameters as the
    pixel-head ``module``: the twin shares its submodules and parameters
    (one copy of the weights; loading into either loads both), and its
    spec has ``pack_x = PACK_X``."""
    from waifu2x_tensorrt_tpu_torch.ops.head_pack import PACK_X

    return (module.packed_x_twin(),
            dataclasses.replace(spec, pack_x=PACK_X))


def _mapping(module) -> list[tuple[str, str, str]]:
    """The (torch path, flax path, kind) table of the module."""
    from waifu2x_tensorrt_tpu_torch.models.convert import (
        cunet_mapping,
        dat_mapping,
        hat_mapping,
        mambair_mapping,
        swin_mapping,
    )
    from waifu2x_tensorrt_tpu_torch.models.cunet import CUNet
    from waifu2x_tensorrt_tpu_torch.models.dat import DAT
    from waifu2x_tensorrt_tpu_torch.models.hat import HAT
    from waifu2x_tensorrt_tpu_torch.models.mambair import MambaIR

    if isinstance(module, CUNet):
        return cunet_mapping(module.scale)
    if isinstance(module, HAT):
        return hat_mapping(module.depths)
    if isinstance(module, DAT):
        return dat_mapping(module.depths)
    if isinstance(module, MambaIR):
        return mambair_mapping(module.depths)
    return swin_mapping(module.scale, module.depths)


def _flax_leaves(module) -> dict[str, tuple]:
    """{flax path: shape} of the module's parameters, in the JAX package's
    naming (the right column of its mapping)."""
    state = module.state_dict()
    leaves: dict[str, tuple] = {}
    for src, dst, kind in _mapping(module):
        if kind == "table":
            leaves[dst] = tuple(state[src].shape)
            continue
        if kind == "stack":  # (slices, O, I) -> a (I, O) kernel a slice
            n, o, i = state[src].shape
            leaves.update({f"{dst}/{k}/kernel": (i, o) for k in range(n)})
            continue
        w = tuple(state[f"{src}.weight"].shape)
        if kind == "conv":  # torch (O, I, kH, kW) -> flax (kH, kW, I, O)
            leaves[f"{dst}/kernel"] = (w[2], w[3], w[1], w[0])
        elif kind == "deconv":  # torch (I, O, kH, kW) -> flax (kH, kW, I, O)
            leaves[f"{dst}/kernel"] = (w[2], w[3], w[0], w[1])
        elif kind == "dense":  # torch (O, I[, 1, 1]) -> flax (I, O)
            leaves[f"{dst}/kernel"] = (w[1], w[0])
        elif kind in ("norm", "bn"):
            leaves[f"{dst}/scale"] = w
        if f"{src}.bias" in state:
            leaves[f"{dst}/bias"] = tuple(state[f"{src}.bias"].shape)
    return leaves


def init_params(module, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded random parameters as a flat flax-keyed dict, N(0, 0.02) for
    every leaf — array for array the JAX package's ``init_params_host``
    with the same seed (leaves drawn in jax's sorted-key flatten order)."""
    leaves = _flax_leaves(module)
    rng = np.random.default_rng(seed)
    flat = {}
    for key in sorted(leaves, key=lambda k: tuple(k.split("/"))):
        flat[key] = (rng.standard_normal(leaves[key]) * 0.02).astype(
            np.float32)
    return flat


# ---------------------------------------------------------------------------
# Weight store: flat .npz of float32 arrays keyed by '/'-joined flax paths.
# ---------------------------------------------------------------------------


def save_params(path: str | Path, flat: dict[str, np.ndarray]) -> None:
    """Write a flat {flax path: array} dict as a weight file (keys in the
    JAX package's flatten order, so both packages write the same file)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    keys = sorted(flat, key=lambda k: tuple(k.split("/")))
    np.savez(path, **{k: np.asarray(flat[k], np.float32) for k in keys})


def load_params(path: str | Path) -> dict[str, np.ndarray]:
    """The flat {flax path: array} dict of a weight file."""
    with np.load(Path(path)) as data:
        return {k: data[k] for k in data.files}


def weights_path(models_dir: str | Path, family: str, scale: int,
                 noise: int) -> Path:
    return Path(models_dir) / family / f"{model_file_stem(scale, noise)}.npz"


def checkpoint_arch(path: str | Path) -> dict:
    """``create_model``'s ``base_dim`` and ``depths`` for the swin_unet
    weight file at ``path``: the depths counted from its block keys, the
    width twice ``patch_conv1``'s output channels (flax kernel (3, 3, 3,
    base_dim / 2)); for a HAT file its ``hat_arch``
    (``convert.hat_arch_from_flax``), for a DAT file its ``dat_arch``
    (``convert.dat_arch_from_flax``), for a MambaIR file its
    ``mambair_arch`` (``convert.mambair_arch_from_flax``). Reads the keys
    and one array a size only."""
    from waifu2x_tensorrt_tpu_torch.models.convert import (
        dat_arch_from_flax,
        hat_arch_from_flax,
        is_dat_tree,
        is_hat_tree,
        is_mambair_tree,
        mambair_arch_from_flax,
        swin_depths_from_flax,
    )

    with np.load(Path(path)) as data:
        if is_mambair_tree(data.files):
            return {"mambair_arch": mambair_arch_from_flax(data)}
        if is_hat_tree(data.files):
            return {"hat_arch": hat_arch_from_flax(data)}
        if is_dat_tree(data.files):
            return {"dat_arch": dat_arch_from_flax(data)}
        return {"base_dim": 2 * int(data["patch_conv1/kernel"].shape[-1]),
                "depths": swin_depths_from_flax(dict.fromkeys(data.files))}


def load_or_init_params(module, models_dir: Optional[str | Path],
                        family: str, scale: int, noise: int, warn=None,
                        allow_random: bool = False):
    """(flat params, loaded_from_file). Missing weights are a hard failure
    (the reference fails when its ONNX artifact is absent) unless
    ``allow_random`` opts into seeded random initialization (seed 0)."""
    p = weights_path(models_dir or "models", family, scale, noise)
    if models_dir is not None and p.exists():
        return load_params(p), True
    if not allow_random:
        raise FileNotFoundError(
            f"no model weights at {p}; convert upstream weights with "
            "models/convert.py, or pass --allow-random-weights to render "
            "with random initialization (test pattern output)")
    if warn is not None:
        warn(f"no weights at {p}; using random initialization (seed 0)")
    return init_params(module, seed=0), False


def load_into(module, flat: dict[str, np.ndarray]) -> None:
    """Load a flat flax param dict into the port's module (strict)."""
    from waifu2x_tensorrt_tpu_torch.models.convert import (
        params_from_flax,
        state_from_flax,
    )
    from waifu2x_tensorrt_tpu_torch.models.dat import DAT
    from waifu2x_tensorrt_tpu_torch.models.hat import HAT
    from waifu2x_tensorrt_tpu_torch.models.mambair import MambaIR

    if isinstance(module, (HAT, DAT, MambaIR)):
        state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
                 for k, v in state_from_flax(flat, _mapping(module)).items()}
    else:
        state = params_from_flax(flat, module.scale)
    module.load_state_dict(state, strict=True)
