"""Kernel G: HAT's and DAT's window attention on qkv.

``hat_attention`` is the wrapper of the CUDA kernel
``csrc/hat_attention.cu``; ``hat_attention_plain`` is its plain PyTorch
twin. It replaces no TPU kernel: the JAX package has no HAT. It was added
because no kernel of the port computes this attention (kernels A, B and E
take 64-token windows at head dim 32).

Both read q, k and v from the (B, H, W, 3C) output of the qkv GEMM, heads
interleaved as [q_0..q_{nh-1} | k_0.. | v_0..] along the last axis (HAT's
``reshape(b, n, 3, nh, d)``), and return the (B, H, W, C) attention
output in qkv's dtype, every token where it came from. Query windows
are ``window`` = (wh, ww) (a side: square; HAT 16 x 16), in two
geometries:

- self (``overlap=0``; HAT's HAB, DAT's DSTB): the keys are the query
  window's own tokens, after the cyclic roll by -``shift`` = (sh, sw);
  the output is rolled back. Scores get Swin's region mask (-100 between
  regions of the rolled map) when the shift is set, and the relative
  bias of ``_self_index``. With ``split`` (DAT's two branches) heads [0,
  nh/2) read channels [0, C/2) of q, k and v in (wh, ww) windows rolled
  by (sh, sw), heads [nh/2, nh) the rest in (ww, wh) windows rolled by
  (sw, sh); each head's column of the table is indexed in its own
  geometry;
- overlapping (``overlap=o``; HAT's OCAB, ``o = window * overlap_ratio /
  2``): the keys are the (window + 2o)^2 tokens of the window that shares
  the query window's centre, with k = v = 0 outside the tile (HAT's
  zero-padded ``nn.Unfold``), and the bias of ``_overlap_index``.

Rounding points (those of kernels A and B): q * scale rounded to qkv's
dtype with the scale d^-0.5 itself rounded, fp32 scores and an exact
max-subtracted fp32 softmax, probabilities rounded to qkv's dtype before
the fp32-accumulated p v, one final rounding.

``table``: the (nt, nh) fp32 relative-position table, nt = (2 wh - 1)
(2 ww - 1) for self and (2 window + 2o - 1)^2 for overlapping
attention.

``channels``: C, where q, k and v are carried at a pitch P > C (HAT's and
DAT's trunk at 16-byte rows, ``models/layers.pitch``): qkv is then (B, H,
W, 3P), each part's C real channels first, and the output (B, H, W, P),
zeros in its pad [C, P).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.ops import build
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import (
    qkv_channels,
    softmax_lastdim,
)

WINDOW = 16        # HAT's window side, which kernel G is built for
RECT = (8, 32)     # DAT's first-half window (rows, columns), the other
                   # half's transposed
MAX_HEAD_DIM = 32  # head dims up to 32 are padded to 32 in the kernel
MASK = -100.0      # Swin's and HAT's score between regions of the roll


def table_rows(window, overlap: int) -> int:
    """Rows of the relative-position table of a geometry: ``window`` a
    side or a (wh, ww) pair."""
    wh, ww = _pair(window)
    return (2 * wh + 2 * overlap - 1) * (2 * ww + 2 * overlap - 1)


def _pair(v) -> tuple:
    """An (h, w) pair of a side or shift given as one int or a pair."""
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


@functools.lru_cache(maxsize=None)
def _self_index(wh: int, ww: int | None = None) -> np.ndarray:
    """(wh ww, wh ww) index of query token i and key token j of one wh x
    ww window (ww None: square) into the (2 wh - 1)(2 ww - 1) table:
    Swin's and HAT's ``calculate_rpi_sa``, DAT's ``relative_position_
    index``, (dy + wh - 1)(2 ww - 1) + dx + ww - 1 with (dy, dx) = query
    - key."""
    ww = wh if ww is None else ww
    y, x = np.divmod(np.arange(wh * ww), ww)
    dy = y[:, None] - y[None, :] + wh - 1
    dx = x[:, None] - x[None, :] + ww - 1
    return (dy * (2 * ww - 1) + dx).astype(np.int64)


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
def _index_tensor(win, ov: int, device: torch.device) -> torch.Tensor:
    """The geometry's bias index on ``device``, uploaded once; ``win`` a
    side or a (wh, ww) pair."""
    win = _pair(win)
    idx = _overlap_index(win[0], ov) if ov else _self_index(*win)
    return torch.from_numpy(idx).to(device)


@functools.lru_cache(maxsize=64)
def region_mask(h: int, w: int, ws, shift,
                device: torch.device) -> torch.Tensor:
    """(nW, wh ww, wh ww) fp32 additive mask of the wh x ww windows
    (``ws`` a side or a (wh, ww) pair) of an (h, w) map rolled by -shift
    (an int or a (sh, sw) pair): -100 between tokens of different regions
    (HAT's ``calculate_mask``, DAT's per branch: slices [0, -wh), [-wh,
    -sh), [-sh, h) of the rows and [0, -ww), [-ww, -sw), [-sw, w) of the
    columns), else 0. Made once a geometry and device."""
    (wh, ww), (sh, sw) = _pair(ws), _pair(shift)
    region = np.zeros((h, w), np.int64)
    n = 0
    for ys in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for xs in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            region[ys, xs] = n
            n += 1
    r = region.reshape(h // wh, wh, w // ww, ww).transpose(0, 2, 1, 3)
    r = r.reshape(-1, wh * ww)
    mask = np.where(r[:, :, None] != r[:, None, :], MASK, 0.0)
    return torch.from_numpy(mask.astype(np.float32)).to(device)


def _windows(x, wh: int, ww: int | None = None):
    """(B, H, W, C) -> (B, nW, wh ww, C) (ww None: square windows)."""
    ww = wh if ww is None else ww
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // wh) * (w // ww), wh * ww, c)


def _unwindow(x, h: int, w: int, wh: int, ww: int | None = None):
    ww = wh if ww is None else ww
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
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


def hat_attention_plain(qkv, table, *, num_heads: int, window=WINDOW,
                        shift=0, overlap: int = 0, split: bool = False,
                        channels: int | None = None):
    """Eager PyTorch attention with the kernel's rounding points on any
    device (the meta device counts its FLOPs at the published head dim).
    ``split``: heads [nh/2, nh), on the second half of the channels of
    q, k and v, take the transposed window and shift. ``channels``: as
    the module says."""
    c = _check_geometry(qkv, table, num_heads, window, shift, overlap,
                        split, channels)
    p = qkv.shape[-1] // 3
    if c < p:
        out = hat_attention_plain(qkv_channels(qkv, c), table,
                                  num_heads=num_heads, window=window,
                                  shift=shift, overlap=overlap, split=split)
        return F.pad(out, (0, p - c))
    if not split:
        return _attend(qkv, table, num_heads, _pair(window), _pair(shift),
                       overlap)
    b, h, w, c3 = qkv.shape
    half, nh = c3 // 6, num_heads // 2
    parts = qkv.reshape(b, h, w, 3, 2, half)
    (wh, ww), (sh, sw) = _pair(window), _pair(shift)
    return torch.cat([
        _attend(parts[:, :, :, :, g].reshape(b, h, w, 3 * half),
                table[:, g * nh:(g + 1) * nh], nh, win, sft, 0)
        for g, (win, sft) in enumerate((((wh, ww), (sh, sw)),
                                        ((ww, wh), (sw, sh))))], dim=-1)


def _attend(qkv, table, nh: int, win: tuple, shift: tuple, overlap: int):
    """The twin of one geometry: every head in (wh, ww) windows rolled by
    -(sh, sw)."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    (wh, ww), (sh, sw) = win, shift
    d = c // nh
    dt = qkv.dtype
    scale = torch.tensor(d ** -0.5, dtype=dt)  # a host scalar operand
    x = torch.roll(qkv, (-sh, -sw), dims=(1, 2)) if sh or sw else qkv
    qw = _windows(x[..., :c] * scale, wh, ww)
    if overlap:
        kvw = _overlap_windows(x[..., c:], wh, overlap)
    else:
        kvw = _windows(x[..., c:], wh, ww)

    def heads(t):  # (B, nW, N, C) -> (B, nW, nh, N, d)
        return t.reshape(*t.shape[:3], nh, d).transpose(2, 3)

    q = heads(qw).float()
    k = heads(kvw[..., :c]).float()
    v = heads(kvw[..., c:]).float()
    idx = _index_tensor(win, overlap, qkv.device)
    bias = table.float()[idx].permute(2, 0, 1)  # (nh, N, Nk)
    s = q @ k.transpose(-1, -2) + bias
    if sh or sw:
        s = s + region_mask(h, w, win, shift, qkv.device)[None, :, None]
    p = softmax_lastdim(s)
    o = (p.to(dt).float() @ v).to(dt)  # (B, nW, nh, N, d)
    o = _unwindow(o.transpose(2, 3).reshape(b, -1, wh * ww, c), h, w, wh,
                  ww)
    return torch.roll(o, (sh, sw), dims=(1, 2)) if sh or sw else o


def _check_geometry(qkv, table, num_heads, window, shift, overlap,
                    split=False, channels=None) -> int:
    """Raises unless the geometry is one the twin takes; returns C (the
    pitch qkv.shape[-1] / 3 where ``channels`` is None)."""
    p = qkv.shape[-1] // 3 if qkv.dim() == 4 else 0
    c = p if channels is None else int(channels)
    if (qkv.dim() != 4 or qkv.shape[-1] % 3 or not 0 < c <= p
            or c % num_heads):
        raise ValueError(f"qkv must be (B, H, W, 3C) with C a multiple of "
                         f"{num_heads} heads, or (B, H, W, 3P) with C "
                         f"(channels {channels}) at most the pitch P, got "
                         f"{tuple(qkv.shape)}")
    (wh, ww), (sh, sw) = _pair(window), _pair(shift)
    if split and (num_heads % 2 or overlap):
        raise ValueError(f"split: an even number of heads, got "
                         f"{num_heads}, on self windows")
    h, w = qkv.shape[1], qkv.shape[2]
    side = max(wh, ww) if split else None
    if (h % (side or wh) or w % (side or ww) or not h or not w
            or min(wh, ww) < 1):
        raise ValueError(f"H and W must be multiples of the window "
                         f"{(wh, ww) if not split else (side, side)}, got "
                         f"{h}x{w}")
    if (sh, sw) != (0, 0) and ((sh, sw) != (wh // 2, ww // 2) or overlap):
        raise ValueError(f"shift {(sh, sw)}: 0 or half the window "
                         f"{(wh // 2, ww // 2)}, and 0 with overlapping "
                         "windows")
    if overlap < 0 or overlap > wh // 2 or (overlap and wh != ww):
        raise ValueError(f"overlap {overlap}: 0 to {wh // 2}, on square "
                         "windows")
    want = (table_rows((wh, ww), overlap), num_heads)
    if tuple(table.shape) != want:
        raise ValueError(f"table must be {want}, got {tuple(table.shape)}")
    return c


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


def hat_attention(qkv, table, *, num_heads: int, window=WINDOW, shift=0,
                  overlap: int = 0, split: bool = False,
                  channels: int | None = None):
    """Window attention on the (B, H, W, 3C) qkv activation (3P with
    ``channels`` C at pitch P): the CUDA kernel for CUDA tensors (bf16
    only), the plain twin for CPU and meta tensors. The kernel takes
    HAT's 16 x 16 windows (self, shift 0 or 8, or overlapping, overlap 4)
    and DAT's split rectangular windows (``window=RECT``, ``split=True``:
    heads [0, nh/2) in 8 x 32 windows, the rest in 32 x 8, shift 0 or
    half the window). Counts kernel launches in
    ``hat_attention.launches``, those of overlapping windows also in
    ``.overlap_launches``, those of rectangular ones in
    ``.rect_launches`` and those at a pitch P > C in
    ``.padded_launches``."""
    c = _check_geometry(qkv, table, num_heads, window, shift, overlap,
                        split, channels)
    p = qkv.shape[-1] // 3
    if qkv.device.type in ("cpu", "meta"):
        return hat_attention_plain(qkv, table, num_heads=num_heads,
                                   window=window, shift=shift,
                                   overlap=overlap, split=split,
                                   channels=channels)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv is {qkv.dtype}: kernel G is bf16 only")
    if table.dtype != torch.float32:
        raise TypeError("table must be float32")
    b, h, w = qkv.shape[:3]
    d = c // num_heads
    win, (sh, sw) = _pair(window), _pair(shift)
    rect = win != (WINDOW, WINDOW)
    if rect and (win != RECT or not split):
        raise ValueError(f"window {win}: the kernel takes {WINDOW} x "
                         f"{WINDOW}, or {RECT} split")
    if not rect and (split or overlap not in (0, WINDOW // 4)):
        raise ValueError(f"window {win} / overlap {overlap}: the kernel "
                         f"takes overlap 0 or {WINDOW // 4}, unsplit")
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
    if p % 2:
        raise ValueError(f"pitch {p}: the kernel takes even pitches")
    out = torch.empty((b, h, w, p), dtype=qkv.dtype, device=qkv.device)
    lib = build.load_library()
    stream = build.stream_handle(qkv.device)
    if rect:
        code = lib.w2x_hat_attention_rect(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, c,
            p, num_heads, win[0], win[1], sh, sw, _scale(d), stream)
    else:
        code = lib.w2x_hat_attention(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, c,
            p, num_heads, sh, overlap, _scale(d), stream)
    build.check(code, "hat attention kernel")
    hat_attention.launches += 1
    if overlap:
        hat_attention.overlap_launches += 1
    if rect:
        hat_attention.rect_launches += 1
    hat_attention.padded_launches += p > c
    return out


hat_attention.launches = 0
hat_attention.overlap_launches = 0
hat_attention.rect_launches = 0
hat_attention.padded_launches = 0
hat_attention.extra_counters = {"overlap": "overlap_launches",
                                "rect": "rect_launches",
                                "padded": "padded_launches"}
