"""Plain PyTorch forms of the math inside kernels A, B and D.

The port's counterpart of ``waifu2x_tensorrt_tpu.ops.kernel_math``. The
JAX package's bf16 fast forms (polynomial erf, clamped no-max softmax,
MXU-dot LayerNorm) answered costs of the v5e vector unit and are not
ported: the CUDA kernels and these plain versions use the exact forms for
every dtype —

- erf-GELU, ``0.5 * z * (1 + erf(z / sqrt(2)))`` in fp32;
- max-subtracted softmax in fp32, the shift mask applied as ``keep``
  AFTER exp, so masked entries get weight exactly 0;
- two-pass fp32 LayerNorm (mean, then the mean of squared deviations),
  eps 1e-5.

``pixel_shuffle`` is the depth-to-space of kernel D's plain twin and of
the models' heads; ``qkv_channels`` the real channels of a qkv map carried
at a row pitch (kernels G's and J's twins).

The shift-mask law (``shift_crossing`` / ``keep_from_flags``) is bit-exact
with the JAX package's; ``ops/csrc/common.cuh`` holds the same law for the
kernels.
"""

from __future__ import annotations

import functools

import torch


def shift_crossing(tok, tok_m, ws: int, shift: int):
    """Does entry (tok, tok_m) pair tokens from opposite sides of the
    cyclic-shift ROW (resp. COLUMN) seam? ``tok``/``tok_m`` are
    window-local token indices (broadcastable int tensors)."""
    row_cross = ((tok // ws) >= (ws - shift)) != (
        (tok_m // ws) >= (ws - shift))
    col_cross = ((tok % ws) >= (ws - shift)) != (
        (tok_m % ws) >= (ws - shift))
    return row_cross, col_cross


def keep_from_flags(bottom, right, row_cross, col_cross):
    """keep = NOT((bottom & row_cross) | (right & col_cross)): an entry is
    masked only in windows wrapping the frame's bottom (flag bit 1) /
    right (bit 2) edge, and only when it crosses the matching seam."""
    return ~((bottom & row_cross) | (right & col_cross))


@functools.lru_cache(maxsize=None)
def _crossings(ws: int, shift: int, device: torch.device):
    """The seam crossings on ``device``, made once (so a captured graph
    reads no host memory)."""
    t = torch.arange(ws * ws, device=device)
    return shift_crossing(t[:, None], t[None, :], ws, shift)


def keep_mask(flags: torch.Tensor, ws: int, shift: int):
    """(BW, N, N) bool keep mask from per-window flag bits, or None when
    ``shift`` is 0 (nothing is masked)."""
    if not shift:
        return None
    row_cross, col_cross = _crossings(ws, shift, flags.device)
    bottom = ((flags & 1) > 0)[:, None, None]
    right = ((flags & 2) > 0)[:, None, None]
    return keep_from_flags(bottom, right, row_cross[None], col_cross[None])


def gelu(z: torch.Tensor) -> torch.Tensor:
    """Exact erf-GELU, fp32 in/out."""
    return 0.5 * z * (1.0 + torch.erf(z * 0.7071067811865476))


def softmax_lastdim(attn: torch.Tensor, keep=None) -> torch.Tensor:
    """Max-subtracted softmax over the last axis, fp32 in/out; entries
    where ``keep`` is False get weight exactly 0. Every row must keep at
    least one entry (Swin shift masks always do)."""
    if keep is not None:
        attn = attn.masked_fill(~keep, -3e38)
    e = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    if keep is not None:
        e = e * keep.to(e.dtype)
    return e / e.sum(dim=-1, keepdim=True)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Two-pass fp32 LayerNorm over the last axis (nn.LayerNorm
    semantics); returns fp32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space (B, H, W, C r r) -> (B, H r, W r, C), channel order
    (C, r, r) as torch.nn.PixelShuffle (CRD)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def qkv_channels(qkv: torch.Tensor, c: int) -> torch.Tensor:
    """The (..., 3C) real channels of a (..., 3P) qkv map whose q, k and
    v each hold C channels at pitch P: a copy, or qkv itself at P = C."""
    p = qkv.shape[-1] // 3
    if c == p:
        return qkv
    return qkv.unflatten(-1, (3, p))[..., :c].flatten(-2)
