"""Kernel A: shifted-window attention over the packed qkv layout.

``fused_window_attention_qkv`` is the wrapper of the CUDA kernel
``csrc/window_attention.cu`` (the port of the TPU kernel
``waifu2x_tensorrt_tpu.ops.window_attention.fused_window_attention_qkv``);
``window_attention_qkv_plain`` is its plain PyTorch twin, the dense
``WindowAttention`` math of ``models/swin_unet.py`` on the same layout.

Layout (as the JAX package's): qkv (BW, 64, 3C) with heads interleaved as
[q_0..q_{nh-1} | k_0.. | v_0..] along the last axis, head dim 32; bias
(nh, 64, 64) fp32; flags (BW,) int32 shift-boundary bits (bit0 bottom,
bit1 right). Returns (BW, 64, C) in qkv's dtype.
"""

from __future__ import annotations

import torch

from waifu2x_tensorrt_tpu_torch.ops import build
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import (
    keep_mask,
    softmax_lastdim,
)

HEAD_DIM = 32
MAX_DIM = 192  # shared-memory bound of kernels A and B (fp32 at C=192)


def window_attention_qkv_plain(qkv, bias, flags, *, num_heads: int,
                               shift: int = 0, ws: int = 8):
    """Eager PyTorch attention with the kernel's rounding points: q*scale
    rounded to qkv's dtype, fp32 scores and softmax, probabilities rounded
    to qkv's dtype before the fp32-accumulated PV product."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    nh = num_heads
    hd = c // nh
    dt = qkv.dtype
    scale = torch.tensor(hd ** -0.5, dtype=dt, device=qkv.device)

    def heads(t):  # (BW, N, C) -> (BW, nh, N, hd)
        return t.reshape(bw, n, nh, hd).permute(0, 2, 1, 3)

    q = heads(qkv[..., :c] * scale).float()
    k = heads(qkv[..., c:2 * c]).float()
    v = heads(qkv[..., 2 * c:]).float()
    attn = q @ k.transpose(-1, -2) + bias.float()[None]
    keep = keep_mask(flags, ws, shift)
    attn = softmax_lastdim(attn, None if keep is None else keep[:, None])
    out = attn.to(dt).float() @ v
    return out.to(dt).permute(0, 2, 1, 3).reshape(bw, n, c)


def _check(qkv, bias, flags, num_heads, shift, ws):
    if qkv.dim() != 3 or qkv.shape[1] != ws * ws or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (BW, {ws * ws}, 3C), got "
                         f"{tuple(qkv.shape)}")
    c = qkv.shape[2] // 3
    if c != num_heads * HEAD_DIM or c > MAX_DIM:
        raise ValueError(f"C={c} with {num_heads} heads: the kernel takes "
                         f"head dim {HEAD_DIM} and C <= {MAX_DIM}")
    if ws != 8 or shift not in (0, ws // 2):
        raise ValueError(f"window {ws} / shift {shift} not supported "
                         "(window 8, shift 0 or 4)")
    if tuple(bias.shape) != (num_heads, ws * ws, ws * ws):
        raise ValueError(f"bias must be ({num_heads}, 64, 64), got "
                         f"{tuple(bias.shape)}")
    if tuple(flags.shape) != (qkv.shape[0],):
        raise ValueError(f"flags must be ({qkv.shape[0]},), got "
                         f"{tuple(flags.shape)}")


def fused_window_attention_qkv(qkv, bias, flags, *, num_heads: int,
                               shift: int = 0, ws: int = 8):
    """Window attention: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors. Counts kernel launches in
    ``fused_window_attention_qkv.launches``."""
    _check(qkv, bias, flags, num_heads, shift, ws)
    if qkv.device.type == "cpu":
        return window_attention_qkv_plain(qkv, bias, flags,
                                          num_heads=num_heads, shift=shift,
                                          ws=ws)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv dtype {qkv.dtype}: float32 or bfloat16 only")
    if bias.dtype != torch.float32 or flags.dtype != torch.int32:
        raise TypeError("bias must be float32 and flags int32")
    for name, t in (("qkv", qkv), ("bias", bias), ("flags", flags)):
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {qkv.device}")
    bw = qkv.shape[0]
    c = qkv.shape[2] // 3
    out = torch.empty((bw, ws * ws, c), dtype=qkv.dtype, device=qkv.device)
    if bw == 0:
        return out
    lib = build.load_library()
    code = lib.w2x_window_attention_qkv(
        qkv.data_ptr(), bias.data_ptr(), flags.data_ptr(), out.data_ptr(),
        bw, c, num_heads, shift, int(qkv.dtype == torch.bfloat16),
        build.stream_handle(qkv.device))
    build.check(code, "window attention kernel")
    fused_window_attention_qkv.launches += 1
    return out


fused_window_attention_qkv.launches = 0
