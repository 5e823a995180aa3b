"""The models' layer math on NHWC activations, over operands cast once.

Every model of the port (``swin_unet``, ``cunet``, ``hat``) runs its
layers through these helpers: a conv on a ``channels_last`` NCHW view of
the (B, H, W, C) activation (no copy either way), a linear map, a
LayerNorm, and the depth-to-space ``pixel_shuffle`` (``ops/kernel_math``,
which kernel D's twin shares). Parameters stay float32 as loaded; each
helper reads its layer's weight and bias in the activation's dtype (a
conv weight channels_last) through ``weights``.

``cached`` is the one operand cache: a value built for a dtype is kept in
the module's private ``_operands`` (``engine.exe_cache.module_tag``
hashes no private attribute), stamped with the device and each
parameter's ``(data_ptr, _version)``. So ``.to(device)`` and
``load_state_dict`` (``registry.load_into``, which copies in place and
bumps the version) both cause a rebuild. Kernel B's prepared operands
(``SwinBlock.operands``) are kept the same way. A model's first call,
eager, builds all it reads, so a CUDA graph captured after it replays no
cast or re-lay of a parameter; a shallow copy of a model
(``SwinUNet.packed_x_twin``) holds the same layers and their operands.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.ops.kernel_math import pixel_shuffle

__all__ = ["cached", "conv", "layer_norm", "linear", "pixel_shuffle",
           "weights"]


def cached(module: nn.Module, dtype: torch.dtype, build):
    """``build()`` for ``dtype``, made once (without autograd, outside
    inference mode, never inside a graph capture) and kept on ``module``
    until one of its parameters changes or moves."""
    params = tuple(module.parameters())
    stamp = (params[0].device,
             tuple((p.data_ptr(), p._version) for p in params))
    cache = vars(module).setdefault("_operands", {})
    hit = cache.get(dtype)
    if hit is None or hit[0] != stamp:
        if params[0].is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("operands built inside a CUDA graph capture:"
                               " run the module eagerly first")
        with torch.inference_mode(False), torch.no_grad():
            hit = cache[dtype] = (stamp, build())
    return hit[1]


def weights(layer: nn.Module, dtype: torch.dtype):
    """``layer``'s (weight, bias) in ``dtype``, a conv weight
    channels_last."""
    def build():
        w = layer.weight.to(dtype)
        if w.dim() == 4:
            w = w.contiguous(memory_format=torch.channels_last)
        return w, layer.bias.to(dtype)

    return cached(layer, dtype, build)


def conv(x, layer: nn.Module, *, bias: bool = True):
    """NHWC conv, or transposed conv for an ``nn.ConvTranspose2d``; with
    ``bias=False`` the bias is left to an epilogue (cunet's kernel H)."""
    w, b = weights(layer, x.dtype)
    fn = (F.conv_transpose2d if isinstance(layer, nn.ConvTranspose2d)
          else F.conv2d)
    y = fn(x.permute(0, 3, 1, 2), w, b if bias else None,
           stride=layer.stride, padding=layer.padding)
    return y.permute(0, 2, 3, 1)


def linear(x, layer: nn.Module):
    """``layer``, an ``nn.Linear`` or a 1x1 ``nn.Conv2d``, over the last
    axis of x."""
    w, b = weights(layer, x.dtype)
    return F.linear(x, w.flatten(1), b)


def layer_norm(x, layer: nn.LayerNorm):
    """``layer`` over the last axis of x, its parameters in x's dtype."""
    w, b = weights(layer, x.dtype)
    return F.layer_norm(x, layer.normalized_shape, w, b, layer.eps)
