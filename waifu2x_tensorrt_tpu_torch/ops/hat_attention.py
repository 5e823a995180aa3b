"""Kernel G: HAT's window attention, self and overlapping, on qkv.

``hat_attention`` is the wrapper of the CUDA kernel
``csrc/hat_attention.cu``; ``hat_attention_plain`` is its plain PyTorch
twin. It replaces no TPU kernel: the JAX package has no HAT. It was added
because no kernel of the port computes this attention (kernels A, B and E
take 64-token windows at head dim 32).

Both read q, k and v from the (B, H, W, 3C) output of the qkv GEMM, heads
interleaved as [q_0..q_{nh-1} | k_0.. | v_0..] along the last axis (HAT's
``reshape(b, n, 3, nh, d)``), and return the (B, H, W, C) attention
output in qkv's dtype, every token where it came from. Two geometries,
over ``window`` x ``window`` query windows (HAT: 16):

- self (``overlap=0``; HAT's HAB): the keys are the query window's own
  tokens, after the cyclic roll by -``shift``; the output is rolled back.
  Scores get Swin's region mask (-100 between regions of the rolled map)
  when ``shift`` is set, and the relative bias of ``_self_index``;
- overlapping (``overlap=o``; HAT's OCAB, ``o = window * overlap_ratio /
  2``): the keys are the (window + 2o)^2 tokens of the window that shares
  the query window's centre, with k = v = 0 outside the tile (HAT's
  zero-padded ``nn.Unfold``), and the bias of ``_overlap_index``.

Rounding points (those of kernels A and B): q * scale rounded to qkv's
dtype with the scale d^-0.5 itself rounded, fp32 scores and an exact
max-subtracted fp32 softmax, probabilities rounded to qkv's dtype before
the fp32-accumulated p v, one final rounding.

``table``: the (nt, nh) fp32 relative-position table, nt = (2 window -
1)^2 for self and (2 window + 2o - 1)^2 for overlapping attention.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.ops import build
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import softmax_lastdim

WINDOW = 16        # the window side kernel G is built for
MAX_HEAD_DIM = 32  # head dims up to 32 are padded to 32 in the kernel
MASK = -100.0      # Swin's and HAT's score between regions of the roll


def table_rows(window: int, overlap: int) -> int:
    """Rows of the relative-position table of a geometry."""
    return (2 * window + 2 * overlap - 1) ** 2


@functools.lru_cache(maxsize=None)
def _self_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index of query token i and key token j of one window
    into the (2 ws - 1)^2 table: Swin's and HAT's ``calculate_rpi_sa``,
    (dy + ws - 1)(2 ws - 1) + dx + ws - 1 with (dy, dx) = query - key."""
    y, x = np.divmod(np.arange(ws * ws), ws)
    dy = y[:, None] - y[None, :] + ws - 1
    dx = x[:, None] - x[None, :] + ws - 1
    return (dy * (2 * ws - 1) + dx).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _overlap_index(ws: int, ov: int) -> np.ndarray:
    """(ws^2, we^2) index of query token (oy, ox) and key token (ey, ex) of
    the we = ws + 2 ov wide key window into the (ws + we - 1)^2 table:
    HAT's ``calculate_rpi_oca``, (ey - oy + ws - we + 1)(ws + we - 1) +
    ex - ox + ws - we + 1, which can be negative and is used as a Python
    index (negative values count from the end). The one place this rule
    is written; a one-to-one map of the offsets onto the table."""
    we = ws + 2 * ov
    n = (ws + we - 1) ** 2
    oy, ox = np.divmod(np.arange(ws * ws), ws)
    ey, ex = np.divmod(np.arange(we * we), we)
    ry = ey[None, :] - oy[:, None] + ws - we + 1
    rx = ex[None, :] - ox[:, None] + ws - we + 1
    return ((ry * (ws + we - 1) + rx) % n).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _index_tensor(ws: int, ov: int, device: torch.device) -> torch.Tensor:
    """The geometry's bias index on ``device``, uploaded once."""
    idx = _overlap_index(ws, ov) if ov else _self_index(ws)
    return torch.from_numpy(idx).to(device)


@functools.lru_cache(maxsize=64)
def region_mask(h: int, w: int, ws: int, shift: int,
                device: torch.device) -> torch.Tensor:
    """(nW, ws^2, ws^2) fp32 additive mask of the windows of an (h, w) map
    rolled by -shift: -100 between tokens of different regions (HAT's
    ``calculate_mask``: slices [0, -ws), [-ws, -shift), [-shift, h) of
    each axis), else 0. Made once a geometry and device."""
    region = np.zeros((h, w), np.int64)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    n = 0
    for ys in cuts:
        for xs in cuts:
            region[ys, xs] = n
            n += 1
    r = region.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    r = r.reshape(-1, ws * ws)
    mask = np.where(r[:, :, None] != r[:, None, :], MASK, 0.0)
    return torch.from_numpy(mask.astype(np.float32)).to(device)


def _windows(x, ws: int):
    """(B, H, W, C) -> (B, nW, ws^2, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // ws) * (w // ws), ws * ws, c)


def _unwindow(x, h: int, w: int, ws: int):
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _overlap_windows(kv, ws: int, ov: int):
    """(B, H, W, C) -> (B, nW, we^2, C): the we = ws + 2 ov wide window
    around each ws window, zeros outside the map (HAT's ``nn.Unfold`` of
    kernel we, stride ws, padding ov)."""
    b, h, w, c = kv.shape
    we = ws + 2 * ov
    p = F.pad(kv, (0, 0, ov, ov, ov, ov))
    p = p.unfold(1, we, ws).unfold(2, we, ws)  # (B, nWy, nWx, C, we, we)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b, -1, we * we, c)


def hat_attention_plain(qkv, table, *, num_heads: int, window: int = WINDOW,
                        shift: int = 0, overlap: int = 0):
    """Eager PyTorch attention with the kernel's rounding points on any
    device (the meta device counts its FLOPs at the published head dim)."""
    _check_geometry(qkv, table, num_heads, window, shift, overlap)
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    nh, ws = num_heads, window
    d = c // nh
    dt = qkv.dtype
    scale = torch.tensor(d ** -0.5, dtype=dt)  # a host scalar operand
    x = torch.roll(qkv, (-shift, -shift), dims=(1, 2)) if shift else qkv
    qw = _windows(x[..., :c] * scale, ws)
    if overlap:
        kvw = _overlap_windows(x[..., c:], ws, overlap)
    else:
        kvw = _windows(x[..., c:], ws)

    def heads(t):  # (B, nW, N, C) -> (B, nW, nh, N, d)
        return t.reshape(*t.shape[:3], nh, d).transpose(2, 3)

    q = heads(qw).float()
    k = heads(kvw[..., :c]).float()
    v = heads(kvw[..., c:]).float()
    idx = _index_tensor(ws, overlap, qkv.device)
    bias = table.float()[idx].permute(2, 0, 1)  # (nh, N, Nk)
    s = q @ k.transpose(-1, -2) + bias
    if shift:
        s = s + region_mask(h, w, ws, shift, qkv.device)[None, :, None]
    p = softmax_lastdim(s)
    o = (p.to(dt).float() @ v).to(dt)  # (B, nW, nh, N, d)
    o = _unwindow(o.transpose(2, 3).reshape(b, -1, ws * ws, c), h, w, ws)
    return torch.roll(o, (shift, shift), dims=(1, 2)) if shift else o


def _check_geometry(qkv, table, num_heads, window, shift, overlap):
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, H, W, 3C) with C a multiple of "
                         f"{num_heads} heads, got {tuple(qkv.shape)}")
    h, w = qkv.shape[1], qkv.shape[2]
    if h % window or w % window or not h or not w:
        raise ValueError(f"H and W must be multiples of the window "
                         f"{window}, got {h}x{w}")
    if shift not in (0, window // 2) or (shift and overlap):
        raise ValueError(f"shift {shift}: 0 or {window // 2}, and 0 with "
                         "overlapping windows")
    if overlap < 0 or overlap > window // 2:
        raise ValueError(f"overlap {overlap}: 0 to {window // 2}")
    want = (table_rows(window, overlap), num_heads)
    if tuple(table.shape) != want:
        raise ValueError(f"table must be {want}, got {tuple(table.shape)}")


@functools.lru_cache(maxsize=None)
def _scale(d: int) -> float:
    """d^-0.5 rounded to bf16, as the twin's host scalar operand."""
    return float(torch.tensor(d ** -0.5, dtype=torch.bfloat16))


def occupancy(overlap: int) -> dict:
    """Registers a thread and resident CTAs an SM of the kernel for
    ``overlap`` 0 or 4. Needs the card."""
    import ctypes

    lib = build.load_library()
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    build.check(lib.w2x_hat_attention_info(
        overlap, ctypes.byref(regs), ctypes.byref(ctas)),
        "hat attention kernel info")
    return {"registers": regs.value, "ctas_per_sm": ctas.value}


def hat_attention(qkv, table, *, num_heads: int, window: int = WINDOW,
                  shift: int = 0, overlap: int = 0):
    """HAT's window attention on the (B, H, W, 3C) qkv activation: the CUDA
    kernel for CUDA tensors (bf16 only), the plain twin for CPU and meta
    tensors. Counts kernel launches in ``hat_attention.launches``, those
    of overlapping windows also in ``hat_attention.overlap_launches``."""
    _check_geometry(qkv, table, num_heads, window, shift, overlap)
    if qkv.device.type in ("cpu", "meta"):
        return hat_attention_plain(qkv, table, num_heads=num_heads,
                                   window=window, shift=shift,
                                   overlap=overlap)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv is {qkv.dtype}: kernel G is bf16 only")
    if table.dtype != torch.float32:
        raise TypeError("table must be float32")
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if window != WINDOW or overlap not in (0, WINDOW // 4):
        raise ValueError(f"window {window} / overlap {overlap}: the kernel "
                         f"takes window {WINDOW}, overlap 0 or "
                         f"{WINDOW // 4}")
    if d > MAX_HEAD_DIM or d % 2:
        raise ValueError(f"head dim {d}: the kernel takes even head dims "
                         f"up to {MAX_HEAD_DIM}")
    for name, t in (("qkv", qkv), ("table", table)):
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {qkv.device}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    if qkv.numel() >= 2 ** 31:
        raise ValueError(f"{qkv.numel()} values: the kernel indexes fewer "
                         "than 2**31")
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    lib = build.load_library()
    code = lib.w2x_hat_attention(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, c,
        num_heads, shift, overlap, _scale(d), build.stream_handle(qkv.device))
    build.check(code, "hat attention kernel")
    hat_attention.launches += 1
    if overlap:
        hat_attention.overlap_launches += 1
    return out


hat_attention.launches = 0
hat_attention.overlap_launches = 0
