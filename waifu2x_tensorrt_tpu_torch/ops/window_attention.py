"""Kernels A and E: shifted-window attention.

Kernel A, over the packed qkv layout: ``fused_window_attention_qkv`` is
the wrapper of the CUDA kernel in ``csrc/window_attention.cu`` (the port
of the TPU kernel
``waifu2x_tensorrt_tpu.ops.window_attention.fused_window_attention_qkv``);
``window_attention_qkv_plain`` is its plain PyTorch twin, the dense
``WindowAttention`` math of ``models/swin_unet.py`` on the same layout.
Layout (as the JAX package's): qkv (BW, 64, 3C) with heads interleaved as
[q_0..q_{nh-1} | k_0.. | v_0..] along the last axis, head dim 32. Returns
(BW, 64, C) in qkv's dtype.

Kernel E, over unpacked heads: ``fused_window_attention`` wraps the second
kernel of ``csrc/window_attention.cu`` (the port of the TPU kernel
``fused_window_attention``), ``window_attention_plain`` is its plain twin.
q, k, v (BW, nh, 64, 32) -> (BW, nh, 64, 32) in q's dtype.

Both take bias (nh, 64, 64) fp32 and flags (BW,) int32 shift-boundary bits
(bit0 bottom, bit1 right). On the card, bf16 runs one tensor-core kernel
for both (``attention_tc_kernel``: (window, head) units through a
cp.async ring, scores in registers), fp32 its CUDA-core counterpart
(``attention_f32_kernel``: the same units and ring, fp32 FMA, the
attention core kernel B's fp32 block shares); both want their tensors
16-byte aligned.
"""

from __future__ import annotations

import torch

from waifu2x_tensorrt_tpu_torch.ops import build
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import (
    keep_mask,
    softmax_lastdim,
)

HEAD_DIM = 32
MAX_DIM = 192  # the widest C kernel B is instantiated for


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
    scale = torch.tensor(hd ** -0.5, dtype=dt)  # a host scalar operand

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


def window_attention_plain(q, k, v, bias, flags, *, shift: int = 0,
                           ws: int = 8):
    """Eager PyTorch attention on unpacked heads with kernel A's rounding
    points (see ``window_attention_qkv_plain``): the JAX package's
    ``window_attention_reference``."""
    dt = q.dtype
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=dt)
    attn = (q * scale).float() @ k.float().transpose(-1, -2)
    attn = attn + bias.float()[None]
    keep = keep_mask(flags, ws, shift)
    attn = softmax_lastdim(attn, None if keep is None else keep[:, None])
    return (attn.to(dt).float() @ v.float()).to(dt)


def _check_geometry(nh, c, shift, ws):
    if c != nh * HEAD_DIM or c > MAX_DIM:
        raise ValueError(f"C={c} with {nh} heads: the kernel takes "
                         f"head dim {HEAD_DIM} and C <= {MAX_DIM}")
    if ws != 8 or shift not in (0, ws // 2):
        raise ValueError(f"window {ws} / shift {shift} not supported "
                         "(window 8, shift 0 or 4)")


def _check_device(x, bias, flags, **tensors):
    """The checks of a CUDA launch; raises on what the kernels do not
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype}: float32 or bfloat16 only")
    if bias.dtype != torch.float32 or flags.dtype != torch.int32:
        raise TypeError("bias must be float32 and flags int32")
    for name, t in (*tensors.items(), ("bias", bias), ("flags", flags)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
        if name in tensors and t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype}")
        if name != "flags" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check(qkv, bias, flags, num_heads, shift, ws):
    if qkv.dim() != 3 or qkv.shape[1] != ws * ws or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (BW, {ws * ws}, 3C), got "
                         f"{tuple(qkv.shape)}")
    _check_geometry(num_heads, qkv.shape[2] // 3, shift, ws)
    if tuple(bias.shape) != (num_heads, ws * ws, ws * ws):
        raise ValueError(f"bias must be ({num_heads}, 64, 64), got "
                         f"{tuple(bias.shape)}")
    if tuple(flags.shape) != (qkv.shape[0],):
        raise ValueError(f"flags must be ({qkv.shape[0]},), got "
                         f"{tuple(flags.shape)}")


def fused_window_attention_qkv(qkv, bias, flags, *, num_heads: int,
                               shift: int = 0, ws: int = 8):
    """Window attention: the CUDA kernel for CUDA tensors, the plain twin
    for CPU (and meta) tensors. Counts kernel launches in
    ``fused_window_attention_qkv.launches``."""
    _check(qkv, bias, flags, num_heads, shift, ws)
    if qkv.device.type in ("cpu", "meta"):
        return window_attention_qkv_plain(qkv, bias, flags,
                                          num_heads=num_heads, shift=shift,
                                          ws=ws)
    _check_device(qkv, bias, flags, qkv=qkv)
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


def fused_window_attention(q, k, v, bias, flags, *, shift: int = 0,
                           ws: int = 8):
    """Window attention on unpacked heads: kernel E for CUDA tensors, the
    plain twin for CPU tensors. Counts kernel launches in
    ``fused_window_attention.launches``."""
    if q.dim() != 4 or q.shape[2] != ws * ws or q.shape[3] != HEAD_DIM:
        raise ValueError(f"q must be (BW, nh, {ws * ws}, {HEAD_DIM}), got "
                         f"{tuple(q.shape)}")
    bw, nh = q.shape[0], q.shape[1]
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError("q, k and v must have one shape")
    _check_geometry(nh, nh * HEAD_DIM, shift, ws)
    if tuple(bias.shape) != (nh, ws * ws, ws * ws):
        raise ValueError(f"bias must be ({nh}, 64, 64), got "
                         f"{tuple(bias.shape)}")
    if tuple(flags.shape) != (bw,):
        raise ValueError(f"flags must be ({bw},), got {tuple(flags.shape)}")
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, flags, shift=shift,
                                      ws=ws)
    _check_device(q, bias, flags, q=q, k=k, v=v)
    out = torch.empty_like(q)
    if bw == 0:
        return out
    lib = build.load_library()
    code = lib.w2x_window_attention_heads(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        flags.data_ptr(), out.data_ptr(), bw, nh, shift,
        int(q.dtype == torch.bfloat16), build.stream_handle(q.device))
    build.check(code, "window attention (unpacked heads) kernel")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0


def tc_occupancy() -> dict:
    """Registers per thread, resident CTAs and warps per SM of the bf16
    tensor-core kernel (one kernel serves A and E). Needs the card."""
    import ctypes

    lib = build.load_library()
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    build.check(lib.w2x_attention_tc_info(ctypes.byref(regs),
                                          ctypes.byref(ctas)),
                "attention kernel info")
    return {"registers": regs.value, "ctas_per_sm": ctas.value,
            "warps_per_sm": 4 * ctas.value}


def f32_occupancy() -> dict:
    """Registers and spilled (local) bytes per thread, resident CTAs and
    warps per SM of the fp32 kernel of A and E. Needs the card."""
    import ctypes

    lib = build.load_library()
    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check(lib.w2x_attention_f32_info(
        ctypes.byref(regs), ctypes.byref(local), ctypes.byref(ctas)),
        "attention kernel info")
    return {"registers": regs.value, "local_bytes": local.value,
            "ctas_per_sm": ctas.value, "warps_per_sm": 4 * ctas.value}
