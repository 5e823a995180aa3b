"""The models' layer math on NHWC activations, over operands cast once.

Every model of the port (``swin_unet``, ``cunet``, ``hat``, ``dat``) runs
its layers through these helpers: a conv on a ``channels_last`` NCHW view of
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

HAT and DAT carry their ``embed_dim``-wide trunk maps at a row pitch
(``pitch``), so that a bf16 row is whole 16-byte vectors and cuBLAS and
cuDNN take their Hopper kernels (at C = 180, rows of 360 bytes kept
cuBLAS on Ampere's ``align2`` GEMMs and made cuDNN copy every input to
padded channels). The pad channels are zero.
Such a model asks for it per call (``pad``): each of a layer's parts
that reads or writes a trunk map gets its weight and bias zero-padded to
the pitch (``widen``), built once per dtype as every operand; zeros in,
zero weights and zero bias give zeros out. No other caller pads.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.ops.kernel_math import pixel_shuffle

__all__ = ["cached", "conv", "layer_norm", "linear", "pitch",
           "pixel_shuffle", "weights", "widen", "widened"]

ALIGN = 8    # values of a 16-byte bf16 vector
K_STEP = 64  # values of the K step of the Hopper GEMMs cuBLAS picks


def cached(module: nn.Module, key, build):
    """``build()`` for ``key`` (a dtype, or a tuple that starts with
    one), made once (without autograd, outside inference mode, never
    inside a graph capture) and kept on ``module`` until one of its
    parameters changes or moves."""
    params = tuple(module.parameters())
    stamp = (params[0].device,
             tuple((p.data_ptr(), p._version) for p in params))
    cache = vars(module).setdefault("_operands", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        if params[0].is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("operands built inside a CUDA graph capture:"
                               " run the module eagerly first")
        with torch.inference_mode(False), torch.no_grad():
            hit = cache[key] = (stamp, build())
    return hit[1]


def pitch(c: int, device) -> int:
    """The row pitch of HAT's and DAT's c-wide trunk maps on ``device``:
    c where its bf16 rows are whole 16-byte vectors (c a multiple of
    ``ALIGN``), else c rounded up to a multiple of ``K_STEP``. At c = 180
    (H100, a chunk of 16 tiles of 256 x 256) the trunk's four GEMMs took
    5.02 ms a block at 180, 3.19 at 184 and 2.00 at 192, where cuBLAS
    picks 192 x 192 tiles (PERF.md). c itself on the meta device, whose
    forward counts the model's work (``FlopCounterMode``), not the
    pad's."""
    if torch.device(device).type == "meta" or c % ALIGN == 0:
        return c
    return -(-c // K_STEP) * K_STEP


def widen(t: torch.Tensor, dim: int, parts: int, p: int) -> torch.Tensor:
    """``t`` with each of its ``parts`` equal blocks along ``dim`` (>= 0)
    zero-padded at its end to ``p``; ``t`` itself where they are ``p``
    wide."""
    c = t.shape[dim] // parts
    if c == p:
        return t
    blocks = t.unflatten(dim, (parts, c))
    pad = [0, 0] * (blocks.dim() - dim - 2) + [0, p - c]
    return F.pad(blocks, pad).flatten(dim, dim + 1)


def widened(w: torch.Tensor, b: torch.Tensor, pad):
    """A layer's weight and bias for ``pad`` = (p, out, inp), the layer
    writing ``out`` and reading ``inp`` parts of trunk maps carried at
    pitch p: each such part of the weight's rows and the bias (out) and of
    its columns (inp) zero-padded to p. A depthwise conv takes (p, 1, 0)."""
    p, out, inp = pad
    if out:
        w, b = widen(w, 0, out, p), widen(b, 0, out, p)
    if inp:
        w = widen(w, 1, inp, p)
    return w, b


def weights(layer: nn.Module, dtype: torch.dtype, pad=None):
    """``layer``'s (weight, bias) in ``dtype``, a conv weight
    channels_last; ``pad``: as ``widened``."""
    def build():
        w, b = layer.weight, layer.bias
        if pad is not None:
            w, b = widened(w, b, pad)
        w = w.to(dtype)
        if w.dim() == 4:
            w = w.contiguous(memory_format=torch.channels_last)
        return w, b.to(dtype)

    return cached(layer, dtype if pad is None else (dtype, *pad), build)


def _depthwise(layer: nn.Module) -> bool:
    return isinstance(layer, nn.Conv2d) and layer.groups > 1 and (
        layer.groups == layer.in_channels == layer.out_channels)


def conv(x, layer: nn.Module, *, bias: bool = True, operands=None,
         pad=None):
    """NHWC conv, or transposed conv for an ``nn.ConvTranspose2d``, with
    the layer's stride, padding and groups (a depthwise conv's widened
    to its padded channels); with ``bias=False`` the bias is left to an
    epilogue (cunet's kernel H); ``operands``: the (weight, bias) in x's
    dtype to apply in place of the layer's own (DAT's convs with their
    BatchNorm folded in); ``pad``: as ``weights``."""
    w, b = (operands if operands is not None
            else weights(layer, x.dtype, pad))
    fn = (F.conv_transpose2d if isinstance(layer, nn.ConvTranspose2d)
          else F.conv2d)
    groups = w.shape[0] if _depthwise(layer) else layer.groups
    y = fn(x.permute(0, 3, 1, 2), w, b if bias else None,
           stride=layer.stride, padding=layer.padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def linear(x, layer: nn.Module, pad=None):
    """``layer``, an ``nn.Linear`` or a 1x1 ``nn.Conv2d``, over the last
    axis of x; ``pad``: as ``weights``."""
    w, b = weights(layer, x.dtype, pad)
    return F.linear(x, w.flatten(1), b)


def layer_norm(x, layer: nn.LayerNorm):
    """``layer`` over the last axis of x, its parameters in x's dtype."""
    w, b = weights(layer, x.dtype)
    return F.layer_norm(x, layer.normalized_shape, w, b, layer.eps)
