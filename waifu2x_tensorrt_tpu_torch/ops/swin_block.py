"""Kernel B: one whole pre-norm Swin block over window tokens.

``fused_swin_block`` is the wrapper of the CUDA kernel
``csrc/swin_block.cu`` (the port of the TPU kernel
``waifu2x_tensorrt_tpu.ops.swin_block.fused_swin_block``);
``swin_block_plain`` is its plain PyTorch twin: LN1 -> qkv -> window
attention -> proj -> residual -> LN2 -> fc1 -> erf GELU -> fc2 -> residual,
with the kernel's rounding points.

Inputs (as the JAX package's): x (BW, 64, C) window tokens, already
partitioned (and cyclically rolled) by the caller; ``params`` with
n1_scale, n1_bias, qkv_kernel (C, 3C), qkv_bias, proj_kernel (C, C),
proj_bias, n2_scale, n2_bias, fc1_kernel (C, 2C), fc1_bias, fc2_kernel
(2C, C), fc2_bias — GEMM kernels in (in, out) layout; bias (nh, 64, 64)
fp32 relative-position bias; flags (BW,) int32 shift-boundary bits.

The kernel reads its operands in its own layout: ``block_operands`` builds
them once (``BlockOperands``), ``swin_block_prepared`` runs the block on
them. ``fused_swin_block`` builds them per call, for the tests and the
``ops`` API; the model caches them (``models/swin_unet.SwinBlock``).

``swin_block_bhwc`` runs the block on the model's (B, H, W, C) activation
itself: the kernel reads each window's tokens where the cyclic roll and
the window partition would put them and writes each result back to the
address it came from, so no roll, split or merge surrounds it. The
windowed (BW, 64, C) layout of ``swin_block_prepared`` is the kernel's
case H = W = 8, no roll.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.ops import build
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import gelu, layernorm
from waifu2x_tensorrt_tpu_torch.ops.window_attention import (
    HEAD_DIM,
    MAX_DIM,
    window_attention_qkv_plain,
)

PARAM_NAMES = ("n1_scale", "n1_bias", "qkv_kernel", "qkv_bias",
               "proj_kernel", "proj_bias", "n2_scale", "n2_bias",
               "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")
_GEMM = ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel")


def window_split(x, ws: int):
    """(B, H, W, C) -> (B, nH*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // ws) * (w // ws), ws * ws, c)


def window_merge(x, h: int, w: int, ws: int):
    """Inverse of window_split."""
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_flags(n_wy: int, n_wx: int) -> np.ndarray:
    """Per-window boundary flags for the analytic shift mask: bit0 = window
    is in the last (rolled) row, bit1 = last column."""
    flags = np.zeros((n_wy, n_wx), dtype=np.int32)
    flags[-1, :] |= 1
    flags[:, -1] |= 2
    return flags.reshape(-1)


@functools.lru_cache(maxsize=64)
def flags_tensor(b: int, n_wy: int, n_wx: int, device: torch.device):
    """``shift_flags`` of b images on ``device``, uploaded once per
    geometry (so a captured graph reads no host memory)."""
    return torch.from_numpy(np.tile(shift_flags(n_wy, n_wx), b)).to(device)


def _dense(a, kernel, bias, dt):
    """fp32-accumulated GEMM of compute-dtype operands, fp32 bias, fp32
    result (the caller rounds)."""
    return a.float() @ kernel.to(dt).float() + bias.float()


def swin_block_plain(x, params, bias, flags, *, num_heads: int,
                     shift: int = 0, ws: int = 8):
    """Eager PyTorch Swin block with the kernel's rounding points."""
    dt = x.dtype
    p = params
    h = layernorm(x, p["n1_scale"], p["n1_bias"]).to(dt)
    qkv = _dense(h, p["qkv_kernel"], p["qkv_bias"], dt).to(dt)
    a = window_attention_qkv_plain(qkv, bias, flags, num_heads=num_heads,
                                   shift=shift, ws=ws)
    x1 = x + _dense(a, p["proj_kernel"], p["proj_bias"], dt).to(dt)
    m = layernorm(x1, p["n2_scale"], p["n2_bias"]).to(dt)
    g = gelu(_dense(m, p["fc1_kernel"], p["fc1_bias"], dt)).to(dt)
    return x1 + _dense(g, p["fc2_kernel"], p["fc2_bias"], dt).to(dt)


def _check_geometry(c, num_heads, shift, ws):
    if c != num_heads * HEAD_DIM or c > MAX_DIM:
        raise ValueError(f"C={c} with {num_heads} heads: the kernel takes "
                         f"head dim {HEAD_DIM} and C <= {MAX_DIM}")
    if ws != 8 or shift not in (0, ws // 2):
        raise ValueError(f"window {ws} / shift {shift} not supported "
                         "(window 8, shift 0 or 4)")


def _check_params(params, bias, c, num_heads, ws):
    shapes = {
        "n1_scale": (c,), "n1_bias": (c,), "qkv_kernel": (c, 3 * c),
        "qkv_bias": (3 * c,), "proj_kernel": (c, c), "proj_bias": (c,),
        "n2_scale": (c,), "n2_bias": (c,), "fc1_kernel": (c, 2 * c),
        "fc1_bias": (2 * c,), "fc2_kernel": (2 * c, c), "fc2_bias": (c,),
    }
    for name, shape in shapes.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(params[name].shape)}")
    if tuple(bias.shape) != (num_heads, ws * ws, ws * ws):
        raise ValueError(f"bias must be ({num_heads}, 64, 64), got "
                         f"{tuple(bias.shape)}")


def _check_x(x, flags, ws):
    if x.dim() != 3 or x.shape[1] != ws * ws:
        raise ValueError(f"x must be (BW, {ws * ws}, C), got "
                         f"{tuple(x.shape)}")
    if tuple(flags.shape) != (x.shape[0],):
        raise ValueError(f"flags must be ({x.shape[0]},), got "
                         f"{tuple(flags.shape)}")


@dataclasses.dataclass(frozen=True)
class BlockOperands:
    """Kernel B's operands for one block, in the layout and dtype that the
    kernel for ``dtype`` reads (``block_operands`` builds them).

    ``tensors`` follow ``PARAM_NAMES``: GEMM weights in ``dtype``,
    (out, in) — nn.Linear's layout, K contiguous — when ``out_in`` (the
    bf16 tensor-core kernel on the card), else (in, out) as the JAX
    params; biases and LayerNorm parameters fp32. ``bias`` is the
    (nh, 64, 64) fp32 relative-position bias."""

    tensors: tuple
    bias: torch.Tensor
    dtype: torch.dtype
    out_in: bool

    @property
    def num_heads(self) -> int:
        return self.bias.shape[0]

    @property
    def dim(self) -> int:
        return self.tensors[0].shape[0]

    def params(self) -> dict:
        """The JAX-layout parameter dict (GEMM kernels (in, out)), for the
        plain twin."""
        return {name: (t.t().contiguous() if self.out_in and name in _GEMM
                       else t)
                for name, t in zip(PARAM_NAMES, self.tensors)}


def block_operands(params, bias, dtype: torch.dtype, *,
                   ws: int = 8) -> BlockOperands:
    """Kernel B's operands from JAX-layout ``params`` and the (nh, 64, 64)
    bias, on the params' device: at most one copy of each tensor, made
    without autograd history."""
    c = params["n1_scale"].shape[0]
    nh = bias.shape[0]
    _check_geometry(c, nh, 0, ws)
    _check_params(params, bias, c, nh, ws)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype}: float32 or bfloat16 only")
    device = params["qkv_kernel"].device
    out_in = dtype == torch.bfloat16 and device.type == "cuda"
    with torch.inference_mode(False), torch.no_grad():
        tensors = []
        for name in PARAM_NAMES:
            t = params[name]
            if t.device != device:
                raise ValueError(f"{name} must lie on {device}")
            if name in _GEMM:
                t = (t.t() if out_in else t).to(dtype).contiguous()
            else:
                t = t.to(torch.float32).contiguous()
            tensors.append(t)
        bias = bias.to(device, torch.float32).contiguous()
    ops = BlockOperands(tuple(tensors), bias, dtype, out_in)
    if device.type == "cuda":
        for name, t in zip(PARAM_NAMES + ("bias",), ops.tensors + (bias,)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    return ops


def swin_block_prepared(x, operands: BlockOperands, flags, *,
                        shift: int = 0, ws: int = 8):
    """One Swin block on prepared operands: the CUDA kernel for CUDA
    tensors (bf16: tensor cores; fp32: register-tiled FMA on the CUDA
    cores, no TF32), the plain twin for CPU
    tensors (and meta ones, which count FLOPs). Counts kernel launches in
    ``fused_swin_block.launches``."""
    _check_x(x, flags, ws)
    _check_operands(x, operands, shift, ws)
    if x.device.type in ("cpu", "meta"):
        return swin_block_plain(x, operands.params(), operands.bias, flags,
                                num_heads=operands.num_heads, shift=shift,
                                ws=ws)
    return _launch(x, operands, flags, x.shape[0], shift, (ws, ws, 0))


def swin_block_bhwc(x, operands: BlockOperands, *, shift: int = 0,
                    ws: int = 8):
    """One Swin block on a (B, H, W, C) activation, H and W multiples of
    ``ws``: the block of the windows of x rolled by -shift, rolled back
    (the model's shifted-window block). On CUDA tensors (contiguous) the
    kernel reads and writes x's layout itself, into a new tensor; on CPU
    and meta tensors it is the plain twin ``swin_block_bhwc_plain``.
    Counts kernel launches in ``fused_swin_block.launches`` and
    ``fused_swin_block.direct_launches``."""
    if x.dim() != 4 or x.shape[1] % ws or x.shape[2] % ws:
        raise ValueError(f"x must be (B, H, W, C) with H and W multiples "
                         f"of {ws}, got {tuple(x.shape)}")
    _check_operands(x, operands, shift, ws)
    if x.device.type in ("cpu", "meta"):
        return swin_block_bhwc_plain(x, operands, shift=shift, ws=ws)
    b, h, w, _ = x.shape
    flags = flags_tensor(b, h // ws, w // ws, x.device)
    out = _launch(x, operands, flags, flags.shape[0], shift, (h, w, shift))
    if flags.shape[0]:
        fused_swin_block.direct_launches += 1
    return out


def swin_block_bhwc_plain(x, operands: BlockOperands, *, shift: int = 0,
                          ws: int = 8):
    """``swin_block_bhwc``'s plain twin on any device: roll by -shift,
    window split, ``swin_block_plain``, window merge, roll back."""
    b, h, w, c = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    out = swin_block_plain(
        window_split(x, ws).reshape(-1, ws * ws, c), operands.params(),
        operands.bias, flags_tensor(b, h // ws, w // ws, x.device),
        num_heads=operands.num_heads, shift=shift, ws=ws)
    out = window_merge(out.reshape(b, -1, ws * ws, c), h, w, ws)
    return torch.roll(out, (shift, shift), dims=(1, 2)) if shift else out


def _check_operands(x, operands, shift, ws):
    _check_geometry(x.shape[-1], operands.num_heads, shift, ws)
    if x.shape[-1] != operands.dim:
        raise ValueError(f"x has C={x.shape[-1]}, the operands "
                         f"C={operands.dim}")


def _launch(x, operands, flags, bw, shift, geometry):
    """Kernel B on CUDA tensors into a new tensor: ``bw`` windows of x laid
    out as ``geometry`` (H, W, roll) of the kernel's address function."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != operands.dtype:
        raise TypeError(f"x is {x.dtype}, the operands {operands.dtype}")
    if operands.bias.device != x.device:
        raise ValueError(f"the operands must lie on {x.device}")
    if flags.dtype != torch.int32:
        raise TypeError("flags must be int32")
    for name, t in (("x", x), ("flags", flags)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{x.numel()} values: the kernel indexes fewer "
                         "than 2**31")
    out = torch.empty_like(x)
    if bw == 0:
        return out
    lib = build.load_library()
    code = lib.w2x_swin_block(
        x.data_ptr(), *[t.data_ptr() for t in operands.tensors],
        operands.bias.data_ptr(), flags.data_ptr(), out.data_ptr(),
        bw, x.shape[-1], operands.num_heads, shift, *geometry,
        int(x.dtype == torch.bfloat16), build.stream_handle(x.device))
    build.check(code, "swin block kernel")
    fused_swin_block.launches += 1
    return out


def fused_swin_block(x, params, bias, flags, *, num_heads: int,
                     shift: int = 0, ws: int = 8):
    """One Swin block on JAX-layout params: builds the operands for x's
    dtype, then ``swin_block_prepared``. Counts kernel launches in
    ``fused_swin_block.launches``."""
    _check_x(x, flags, ws)
    _check_geometry(x.shape[2], num_heads, shift, ws)
    _check_params(params, bias, x.shape[2], num_heads, ws)
    if x.device.type == "cpu":
        return swin_block_plain(x, params, bias, flags, num_heads=num_heads,
                                shift=shift, ws=ws)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16 only")
    if bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    if bias.device != x.device:
        raise ValueError(f"bias must lie on {x.device}")
    return swin_block_prepared(x, block_operands(params, bias, x.dtype),
                               flags, shift=shift, ws=ws)


fused_swin_block.launches = 0
fused_swin_block.direct_launches = 0  # those of swin_block_bhwc
fused_swin_block.extra_counters = {"direct": "direct_launches"}


def f32_occupancy(c: int) -> dict:
    """Registers and spilled (local) bytes per thread, resident CTAs and
    warps per SM of the fp32 kernel at width ``c``. Needs the card."""
    import ctypes

    lib = build.load_library()
    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check(lib.w2x_swin_block_f32_info(
        c, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(ctas)),
        "swin block kernel info")
    return {"registers": regs.value, "local_bytes": local.value,
            "ctas_per_sm": ctas.value, "warps_per_sm": 8 * ctas.value}
