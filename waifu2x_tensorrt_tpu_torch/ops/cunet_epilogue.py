"""Kernel H: cunet's convolution epilogue in one pass.

``bias_act`` is the wrapper of the CUDA kernel ``csrc/cunet_epilogue.cu``;
``bias_act_plain`` is its plain PyTorch twin. It replaces no TPU kernel:
XLA fused this epilogue into the convolutions on the TPU. On the card,
cuDNN leaves a convolution's bias to PyTorch, which adds it in a pass of
its own, and the leaky ReLU and the skip adds of ``models/cunet.py`` took
three more; kernel H reads the bias-free conv output once and writes the
finished activation once, in place:

  y = c + bias                       the bias, broadcast over C
  act:   y = max(y, y * a)           ``leaky_relu``, a = 0.1 in y's dtype
  skip:  y = skip[crop] + y          the skip, cropped by ``crop`` a side
  clamp: y = clamp(y, 0, 1)          the cascade's last step

each step rounded to the dtype as the torch op it replaces rounds, so the
kernel's bytes are those of the torch ops on the card, in bf16 and fp32.
"""

from __future__ import annotations

import functools

import torch

from waifu2x_tensorrt_tpu_torch.ops import build

NEG_SLOPE = 0.1


@functools.cache
def slope(dtype: torch.dtype) -> float:
    """The leaky ReLU's slope 0.1 rounded to ``dtype``."""
    return float(torch.tensor(NEG_SLOPE, dtype=dtype))


def leaky_relu(x):
    """max(x, a*x) with ``a`` rounded to x's dtype, the reference's form
    (in bf16 not bit-equal to ``F.leaky_relu``, whose slope stays fp32)."""
    return torch.maximum(x, x * slope(x.dtype))


def _crop(x, p: int):
    """Center crop by p on each spatial side (NHWC)."""
    return x[:, p:x.shape[1] - p, p:x.shape[2] - p, :]


def _check(c, bias, skip, crop):
    if c.dim() != 4:
        raise ValueError(f"c must be (N, H, W, C), got {tuple(c.shape)}")
    n, h, w, ch = c.shape
    if tuple(bias.shape) != (ch,):
        raise ValueError(f"bias must be ({ch},), got {tuple(bias.shape)}")
    if crop < 0:
        raise ValueError(f"crop {crop} must be >= 0")
    if skip is not None and tuple(skip.shape) != (n, h + 2 * crop,
                                                  w + 2 * crop, ch):
        raise ValueError(f"skip must be {(n, h + 2 * crop, w + 2 * crop, ch)}"
                         f" for crop {crop}, got {tuple(skip.shape)}")
    for name, t in (("bias", bias), ("skip", skip)):
        if t is not None and t.dtype != c.dtype:
            raise TypeError(f"{name} is {t.dtype}, c is {c.dtype}")


def epilogue_ops(c, bias, *, act=True, skip=None, crop=0, clamp=False):
    """The torch ops kernel H replaces, as ``models/cunet.py`` ran them
    after a conv: a new tensor."""
    y = c + bias
    if act:
        y = leaky_relu(y)
    if skip is not None:
        y = _crop(skip, crop) + y
    if clamp:
        y = torch.clamp(y, 0.0, 1.0)
    return y


def bias_act_plain(c, bias, *, act=True, skip=None, crop=0, clamp=False):
    """Plain twin, on any device: ``epilogue_ops`` written over ``c``,
    which is returned."""
    _check(c, bias, skip, crop)
    return c.copy_(epilogue_ops(c, bias, act=act, skip=skip, crop=crop,
                                clamp=clamp))


def bias_act(c, bias, *, act=True, skip=None, crop=0, clamp=False):
    """Kernel H on the (N, H, W, C) conv output ``c`` (its bias not added):
    the bias, with ``act`` the leaky ReLU, with ``skip`` (N, H + 2 crop,
    W + 2 crop, C) the add of its centre crop, with ``clamp`` [0, 1];
    written over ``c``, which is returned. The CUDA kernel for CUDA
    tensors (bf16 or fp32, contiguous), the plain twin for CPU and meta
    tensors. Counts kernel launches in ``bias_act.launches``."""
    _check(c, bias, skip, crop)
    if c.device.type in ("cpu", "meta"):
        return bias_act_plain(c, bias, act=act, skip=skip, crop=crop,
                              clamp=clamp)
    if c.device.type != "cuda":
        raise ValueError(f"unsupported device {c.device}")
    if c.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"c is {c.dtype}: kernel H takes bf16 or fp32")
    for name, t in (("c", c), ("bias", bias), ("skip", skip)):
        if t is not None and (t.device != c.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {c.device}")
    # the kernel's index math is 32-bit (see the source's note)
    if max(c.numel(), 0 if skip is None else skip.numel()) >= 2 ** 31:
        raise ValueError("kernel H indexes fewer than 2**31 values")
    n, h, w, ch = c.shape
    lib = build.load_library()
    code = lib.w2x_bias_act(
        c.data_ptr(), bias.data_ptr(),
        None if skip is None else skip.data_ptr(), n, h, w, ch, crop,
        slope(c.dtype), int(act), int(clamp), int(c.dtype == torch.bfloat16),
        build.stream_handle(c.device))
    build.check(code, "cunet epilogue kernel")
    bias_act.launches += 1
    return c


bias_act.launches = 0
