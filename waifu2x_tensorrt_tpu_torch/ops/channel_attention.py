"""Kernel J: DAT's channel attention on qkv.

``channel_attention`` is the wrapper of the CUDA kernel
``csrc/dat_channel_attention.cu``; ``channel_attention_plain`` is its
plain PyTorch twin. It replaces no TPU kernel: the JAX package has no
DAT. It was added because no kernel of the port computes this attention,
DAT's DCTB (XCiT's "transposed" attention): per tile and head, a d x d
attention matrix from q and k L2-normalised over all the tile's tokens,
applied to v at every token.

Both read q, k and v from the (B, H, W, 3C) output of the qkv GEMM, heads
interleaved as [q_0..q_{nh-1} | k_0.. | v_0..] along the last axis (DAT's
``reshape(B, N, 3, nh, d)``), and return the (B, H, W, C) output in
qkv's dtype:

  G = q^T k over the N = H W tokens (d x d), n_q = max(|q_i|, 1e-12),
  n_k = max(|k_j|, 1e-12) (``F.normalize`` along the tokens),
  A = softmax_j(tau_h (G_ij / (n_q,i n_k,j))),
  a[:, :, :, h d + i] = sum_j A_ij v[:, :, :, h d + j].

Rounding points: G and the sums of squares in fp32 from q and k as they
are (no rounding of the normalised q and k), then sqrt, the clamp, the
division, tau and an exact max-subtracted softmax in fp32; A rounded to
qkv's dtype before the fp32-accumulated A v; one final rounding. The
kernel differs only in the order of its fp32 sums.

``tau``: the (nh,) fp32 temperatures (DAT's ``temperature``, (nh, 1, 1),
flattened).
"""

from __future__ import annotations

import torch

from waifu2x_tensorrt_tpu_torch.ops import build
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import softmax_lastdim

MAX_HEADS = 8      # the kernel's heads a CTA (a warp each)
MAX_HEAD_DIM = 32  # head dims up to 32 are padded to 32 in the kernel
EPS = 1e-12        # F.normalize's


def _check(qkv, tau, num_heads):
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, H, W, 3C) with C a multiple of "
                         f"{num_heads} heads, got {tuple(qkv.shape)}")
    if tuple(tau.shape) != (num_heads,):
        raise ValueError(f"tau must be ({num_heads},), got "
                         f"{tuple(tau.shape)}")


def channel_attention_plain(qkv, tau, *, num_heads: int):
    """Eager PyTorch channel attention with the kernel's rounding points,
    on any device (the meta device counts its FLOPs: the Gram matrix and
    A v)."""
    _check(qkv, tau, num_heads)
    b, h, w, c3 = qkv.shape
    c, nh = c3 // 3, num_heads
    d = c // nh
    dt = qkv.dtype
    t = qkv.reshape(b, h * w, 3, nh, d).float()
    q, k, v = t.unbind(2)  # (B, N, nh, d)
    q, k = q.permute(0, 2, 3, 1), k.permute(0, 2, 3, 1)  # (B, nh, d, N)
    gram = q @ k.transpose(-1, -2)  # (B, nh, d, d)
    nq = (q * q).sum(-1).sqrt().clamp_min(EPS)
    nk = (k * k).sum(-1).sqrt().clamp_min(EPS)
    s = tau.float()[:, None, None] * (gram / (nq[..., :, None]
                                              * nk[..., None, :]))
    a = softmax_lastdim(s).to(dt).float()  # (B, nh, d, d)
    o = v.permute(0, 2, 1, 3) @ a.transpose(-1, -2)  # (B, nh, N, d)
    return o.to(dt).permute(0, 2, 1, 3).reshape(b, h, w, c)


def channel_attention(qkv, tau, *, num_heads: int):
    """DAT's channel attention on the (B, H, W, 3C) qkv activation: the
    CUDA kernel for CUDA tensors (bf16 qkv, fp32 tau; at most
    ``MAX_HEADS`` heads of an even head dim up to ``MAX_HEAD_DIM``), the
    plain twin for CPU and meta tensors. Counts calls in
    ``channel_attention.launches`` (three kernels each)."""
    _check(qkv, tau, num_heads)
    if qkv.device.type in ("cpu", "meta"):
        return channel_attention_plain(qkv, tau, num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv is {qkv.dtype}: kernel J is bf16 only")
    if tau.dtype != torch.float32:
        raise TypeError("tau must be float32")
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if num_heads > MAX_HEADS or d > MAX_HEAD_DIM or d % 2:
        raise ValueError(f"{num_heads} heads of dim {d}: the kernel takes "
                         f"up to {MAX_HEADS} heads of an even dim up to "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("qkv", qkv), ("tau", tau)):
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {qkv.device}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    if qkv.numel() >= 2 ** 31 or b > 65535:
        raise ValueError(f"{tuple(qkv.shape)}: the kernel indexes fewer "
                         "than 2**31 values and 65535 tiles")
    lib = build.load_library()
    # the partials and the attention matrices, made per call as ``out``
    # is: inside a CUDA graph capture they come from the graph's pool
    part = torch.empty(lib.w2x_channel_attention_scratch(b, h * w,
                                                         num_heads),
                       dtype=torch.float32, device=qkv.device)
    attn = torch.empty((b, num_heads, MAX_HEAD_DIM, MAX_HEAD_DIM),
                       dtype=torch.bfloat16, device=qkv.device)
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    code = lib.w2x_channel_attention(
        qkv.data_ptr(), tau.data_ptr(), part.data_ptr(), attn.data_ptr(),
        out.data_ptr(), b, h * w, c, num_heads,
        build.stream_handle(qkv.device))
    build.check(code, "channel attention kernel")
    channel_attention.launches += 1
    return out


channel_attention.launches = 0
