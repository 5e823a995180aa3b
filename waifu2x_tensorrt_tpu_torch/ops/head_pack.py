"""Kernel D: the packed-x head — [0,1] clamp + depth-to-space into the
packed-x16 layout.

``pack_head_x16`` is the wrapper of the CUDA kernel ``csrc/head_pack.cu``
(the port of the TPU kernel ``waifu2x_tensorrt_tpu.ops.head_pack.
pack_head_x16``); ``pack_head_plain`` is its plain PyTorch twin.

z (B, H, W, 3r^2), the head conv's output, becomes (B, rH, rW/16, 48):
lane ``3 * (x % 16) + c`` of group ``x // 16``. Its row-major bytes are
those of the (B, rH, rW, 3) pixel tensor, so a consumer may view one as
the other without a copy. The TPU kernel does the shuffle as one-hot
matrix products (a lane permutation on the MXU); the CUDA kernel is a
clamp plus a gather, and both are exact: the result equals the plain
twin's bit for bit.
"""

from __future__ import annotations

import torch

from waifu2x_tensorrt_tpu_torch.ops import build
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import pixel_shuffle

PACK_X = 16


def pack_head_plain(z, r: int):
    """Plain twin: clamp, pixel shuffle (torch CRD order), then the free
    reshape to (B, rH, rW/16, 48)."""
    y = pixel_shuffle(torch.clamp(z, 0.0, 1.0), r)  # (B, rH, rW, 3)
    b, oh, ow, c = y.shape
    return y.reshape(b, oh, ow // PACK_X, PACK_X * c)


def _check(z, r):
    if r not in (2, 4):
        raise ValueError(f"upscale factor {r}: 2 or 4 only")
    if z.dim() != 4 or z.shape[3] != 3 * r * r:
        raise ValueError(f"z must be (B, H, W, {3 * r * r}), got "
                         f"{tuple(z.shape)}")
    if z.shape[2] % (PACK_X // r):
        raise ValueError(f"width {z.shape[2]} * {r} is not a multiple of "
                         f"{PACK_X}")
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"z dtype {z.dtype}: float32 or bfloat16 only")


def pack_head_x16(z, *, r: int):
    """Clamp + depth-to-space(r) + pack-x16: the CUDA kernel for CUDA
    tensors, the plain twin for CPU (and meta) tensors. Returns (B, rH,
    rW/16, 48) in z's dtype. Counts kernel launches in
    ``pack_head_x16.launches``."""
    _check(z, r)
    if z.device.type in ("cpu", "meta"):
        return pack_head_plain(z, r)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    b, h, w, _ = z.shape
    out = torch.empty((b, h * r, (w * r) // PACK_X, 3 * PACK_X),
                      dtype=z.dtype, device=z.device)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    code = lib.w2x_head_pack(z.data_ptr(), out.data_ptr(), b, h, w, r,
                             int(z.dtype == torch.bfloat16),
                             build.stream_handle(z.device))
    build.check(code, "head pack kernel")
    pack_head_x16.launches += 1
    return out


pack_head_x16.launches = 0
