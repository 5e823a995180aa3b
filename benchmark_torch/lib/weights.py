"""Seeded weights and inputs, made on the device from ``--seed``.

Weights: one float32 normal draw of every parameter's size from a
generator on the device, cut into the configuration's parameters
(``reference.<arch>.param_shapes``) and scaled by the configuration's
``weights`` rule: kernels N(0, gain^2 / fan_in) (fan_in: all axes but
the last), biases N(0, bias_std^2), LayerNorm scales 1 + N(0,
norm_std^2) and biases N(0, norm_std^2), relative-position tables
N(0, rel_std^2); a ``head`` entry sets a layer's own kernel gain and a
constant bias. The program reads them as the weight file it serves
(``<models>/<family>/<stem>.npz``, the published layout); the reference
takes the same tensors.

Inputs: smooth RGB u8 pictures, low-resolution uniform noise upsampled
bicubically plus fine noise, as frames or stills of the traffic's sizes.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark_torch.reference.render import model_module


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def make_params(config: dict, seed: int, device) -> dict:
    shapes = model_module(config).param_shapes(config)
    rule = config["weights"]
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, 0, device),
                       device=device, dtype=torch.float32)
    params = {}
    heads = rule.get("head", {})
    for (name, shape), piece in zip(shapes.items(), flat.split(sizes)):
        layer, leaf = name.rsplit("/", 1)
        head = heads.get(layer, {})
        t = piece.reshape(shape)
        if leaf == "kernel":
            gain = head.get("gain", rule["kernel_gain"])
            t = t * (gain / math.sqrt(math.prod(shape[:-1])))
        elif leaf == "scale":
            t = 1.0 + rule["norm_std"] * t
        elif leaf == "relative_position_bias":
            t = rule["rel_std"] * t
        elif "bias" in head:
            t = torch.full_like(t, head["bias"])
        elif "/norm" in name:
            t = rule["norm_std"] * t
        else:
            t = rule["bias_std"] * t
        params[name] = t
    return params


def write_weight_file(models_dir: Path, config: dict, params: dict) -> None:
    """The program's weight file for the configuration's model."""
    family, scale, noise = config["family"], config["scale"], config["noise"]
    stem = (f"noise{noise}_" if noise != -1 else "") + (
        f"scale{scale}x" if scale != 1 else "")
    path = Path(models_dir) / family / f"{stem.rstrip('_')}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    sizes = [v.numel() for v in params.values()]
    host = torch.cat([v.flatten() for v in params.values()]).cpu().numpy()
    pieces = np.split(host, np.cumsum(sizes)[:-1])
    np.savez(path, **{k: a.reshape(v.shape)
                      for (k, v), a in zip(params.items(), pieces)})


def make_picture(hw, g: torch.Generator, device) -> np.ndarray:
    """One (H, W, 3) u8 picture on the host."""
    h, w = hw
    low = torch.rand((1, 3, h // 16 + 2, w // 16 + 2), generator=g,
                     device=device)
    x = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
    x = x + 0.08 * torch.randn((1, 3, h, w), generator=g, device=device)
    x = torch.round(x.clamp(0, 1) * 255).to(torch.uint8)
    return x[0].permute(1, 2, 0).contiguous().cpu().numpy()
