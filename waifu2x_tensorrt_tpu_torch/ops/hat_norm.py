"""Kernel I: HAT's, DAT's and MambaIR's residual sums and their LayerNorm in
one pass.

``add_norm`` is the wrapper of the CUDA kernel ``csrc/hat_norm.cu``;
``add_norm_plain`` is its plain PyTorch twin. It replaces no TPU kernel:
the JAX package has no HAT. In ``models/hat.py`` each LayerNorm reads the
residual sum that the block before it left pending; kernel I forms that
sum and its LayerNorm over C in one read of the (B, H, W, C) maps:

  norm (``r`` None):   n = LN(x)
  add:                 y = x + r, n = LN(y)
  scaled add (``z``):  y = addcmul(x + r, z, s[b]), n = LN(y)
  skip (``k``, ``r``): y = x k + r, n = LN(y)
  skip gate (``k``, ``z``, no ``r``): y = addcmul(x k, z, s[b]), n = LN(y)

with ``s`` the (B, C) per-image channel weights of ``z`` (HAB's channel
attention times its conv scale, MambaIR's CAB gate) and ``k`` the (C,)
per-channel weight of x (MambaIR's ``skip_scale`` and ``skip_scale2``).
Each product and sum is rounded to bf16 where the torch op it replaces
rounds (``x * k``, ``add``, then ``addcmul``'s fp32 product and sum), so
y is bit-equal to the twin's; LN is computed in fp32 from the
rounded y, as torch's bf16 ``layer_norm``, and n differs from the twin's
only by the order of the fp32 sums (within one bf16 ulp).

The maps' rows may be wider than the C channels of ``weight`` and
``bias``: a row of pitch P > C (HAT's and DAT's trunk at 16-byte rows,
``models/layers.pitch``) holds C channels and P - C pad channels. The
sums and the LayerNorm cover the C channels alone; y (where written) and
n hold zeros in the pad, whatever the inputs' pads hold. ``s`` is then
(B, P).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.ops import build

MAX_C = 256  # the kernel's widest row: 2 vectors of 16 bytes a lane


def _check(x, r, weight, bias, z, s, k=None):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, P), got {tuple(x.shape)}")
    b, _, _, p = x.shape
    c = weight.shape[0] if weight.dim() == 1 else -1
    if not 0 < c <= p:
        raise ValueError(f"weight must be (C,) with C up to x's {p} "
                         f"channels, got {tuple(weight.shape)}")
    if (z is None) != (s is None):
        raise ValueError("z and s go together")
    if k is None and z is not None and r is None:
        raise ValueError("the scaled add needs r")
    if k is not None and (r is None) == (z is None):
        raise ValueError("a skip weight goes with r (skip) or with z and "
                         "s (skip gate), not both")
    shapes = (("r", r, x.shape), ("z", z, x.shape), ("s", s, (b, p)),
              ("weight", weight, (c,)), ("bias", bias, (c,)),
              ("k", k, (c,)))
    for name, t, shape in shapes:
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check_kernel(x, *others, c=None):
    """What the kernel takes beyond ``_check``: bf16, C (None: the pitch)
    and the pitch P multiples of 4, P up to ``MAX_C``, contiguous 16-byte
    aligned tensors, fewer than 2**31 values."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x is {x.dtype}: kernel I is bf16 only")
    p = x.shape[-1]
    c = p if c is None else c
    if c % 4 or p % 4 or not 0 < p <= MAX_C:
        raise ValueError(f"C {c} at pitch {p}: kernel I takes multiples "
                         f"of 4 up to {MAX_C}")
    for t in (x, *others):
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel I takes contiguous tensors")
        if t is not None and t.data_ptr() % 16:
            raise ValueError("kernel I takes 16-byte aligned tensors")
    # rows and the kernel's offsets in 16-byte units are 32-bit
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{x.numel()} values: kernel I indexes fewer "
                         "than 2**31")


def add_norm_plain(x, r, weight, bias, eps, *, z=None, s=None, k=None):
    """Plain twin, on any device: the ops of ``models/hat.py`` before
    kernel I, ``x * k``, ``x + r``, ``torch.addcmul`` and
    ``layers.layer_norm``, on the C channels of ``weight``, the pads of y
    and n zero. Returns (y, n); y is x itself for the norm alone."""
    _check(x, r, weight, bias, z, s, k)
    p, c = x.shape[-1], weight.shape[0]
    if c < p:
        y, n = add_norm_plain(
            x[..., :c], None if r is None else r[..., :c], weight, bias, eps,
            z=None if z is None else z[..., :c],
            s=None if s is None else s[:, :c], k=k)
        return (x if r is None and k is None else F.pad(y, (0, p - c)),
                F.pad(n, (0, p - c)))
    y = x if k is None else x * k
    y = y if r is None else y + r
    if z is not None:
        y = torch.addcmul(y, z, s[:, None, None, :])
    return y, F.layer_norm(y, (c,), weight, bias, eps)


def add_norm(x, r, weight, bias, eps, *, z=None, s=None, k=None):
    """Kernel I on the (B, H, W, P) map ``x``, whose first C channels
    (those of ``weight``) are real: with ``r`` (same shape) the sum y =
    x + r, with ``z`` (same shape) and ``s`` (B, P) the sum y = x + r +
    z s[b] rounded as ``torch.addcmul``; with ``k`` (C,) x k in place of
    x, beside r (skip) or z and s (skip gate, no r); n = LayerNorm(y) over
    the C channels by ``weight``, ``bias`` (C,) and ``eps``, zeros in the
    pad of y and n. Returns (y, n), y being x for the norm alone. The CUDA
    kernel for CUDA tensors (bf16 only, contiguous, 16-byte aligned, C and
    P multiples of 4, P up to ``MAX_C``), the plain twin for CPU and meta
    tensors. Counts kernel launches in ``add_norm.launches``, those on
    rows of pitch P > C also in ``.padded_launches``, those with ``k``
    also in ``.skip_launches``."""
    _check(x, r, weight, bias, z, s, k)
    if x.device.type in ("cpu", "meta"):
        return add_norm_plain(x, r, weight, bias, eps, z=z, s=s, k=k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    c = weight.shape[0]
    _check_kernel(x, r, z, s, weight, bias, k, c=c)
    b, h, w, p = x.shape
    n = torch.empty_like(x)
    y = x if r is None and k is None else torch.empty_like(x)
    lib = build.load_library()
    code = lib.w2x_add_norm(
        x.data_ptr(), None if r is None else r.data_ptr(),
        None if z is None else z.data_ptr(),
        None if s is None else s.data_ptr(),
        None if k is None else k.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), None if y is x else y.data_ptr(), n.data_ptr(),
        b * h * w, c, p, h * w, float(eps), build.stream_handle(x.device))
    build.check(code, "hat add-norm kernel")
    add_norm.launches += 1
    add_norm.padded_launches += p > c
    add_norm.skip_launches += k is not None
    return y, n


add_norm.launches = 0
add_norm.padded_launches = 0
add_norm.skip_launches = 0
add_norm.extra_counters = {"padded": "padded_launches",
                           "skip": "skip_launches"}


def occupancy(c: int, mode: int) -> dict:
    """Registers a thread and resident CTAs an SM of the kernel at pitch
    ``c`` for ``mode`` 0 (norm), 1 (add), 2 (scaled add), 3 (skip) or 4
    (skip gate). Needs the card."""
    import ctypes

    lib = build.load_library()
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    build.check(lib.w2x_add_norm_info(c, mode, ctypes.byref(regs),
                                      ctypes.byref(ctas)),
                "hat add-norm kernel info")
    return {"registers": regs.value, "ctas_per_sm": ctas.value}
