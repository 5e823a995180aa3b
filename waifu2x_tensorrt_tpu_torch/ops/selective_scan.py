"""Kernel K: MambaIR's 2D selective scan over whole tiles, four directions.

``selective_scan`` is the wrapper of the CUDA kernels
``csrc/selective_scan.cu``; ``selective_scan_plain`` is its plain PyTorch
twin. It replaces no TPU kernel: the JAX package has no MambaIR. It was
added because no kernel of the port computes a recurrence: in plain torch
the scan is a Python loop over the 65,536 tokens of a 256 x 256 tile, or
a closed form over chunks of tokens (the twin's), seconds a call at the
cell's chunk.

With u the (B, H, W, D) map, for each direction k = 0..3 (0 row-major, 1
column-major, 2 and 3 those reversed; ``scan_order``), channel d and
state n, over the L = H W tokens in direction k's order, h = 0 before the
first:

  [dt | B | C]_l = x_dbl[token, k]   (R, N and N of direction k's R + 2N)
  delta_l = softplus(dt_weight[k, d] . dt_l + dt_bias[k, d])
  h_l = exp(delta_l a[k, d, n]) h_{l-1} + delta_l u_l B_l[n]
  y_l = sum_n h_l[n] C_l[n] + ds[k, d] u_l

the four directions' y summed at each token in fp32, in the published
order ((y_0 + y_2) + y_1) + y_3, and the output SS2D's gate on that sum,
``gate`` = (z, weight, bias, eps): LayerNorm(y) SiLU(z) over the D
channels in fp32 (z (B, H, W, D) in u's dtype, weight and bias (D,)
fp32), rounded once to u's dtype. ``x_dbl`` is the (B, H, W, 4 (R +
2N)) output of the
x_proj GEMM, direction-major; ``dt_weight`` (4, D, R), ``dt_bias`` (4,
D), ``a`` (4, D, N) (A = -exp(A_logs)) and ``ds`` (4, D) are fp32. The
scan reads u and x_dbl in each order by index: no flipped or transposed
copy is made.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.ops import build

RANK = 12   # dt_rank and d_state the CUDA kernel is built for
STATE = 16
MAX_D = 512  # the combine kernel's widest row
CHUNK = 256          # the twin's tokens a chunk of the closed form, at most
MAX_EXPONENT = 60.0  # |A| times a chunk's delta sum, at most

_scratch: dict = {}  # device -> [fp32 partials buffers], never freed


def scan_order(h: int, w: int, device=None) -> torch.Tensor:
    """(4, H W): the row-major token that each direction reads at each
    step."""
    rows = torch.arange(h * w, device=device)
    cols = torch.arange(h * w, device=device).reshape(h, w).t().reshape(-1)
    return torch.stack([rows, cols, rows.flip(0), cols.flip(0)])


def _check(u, xdbl, dt_weight, dt_bias, a, ds, gate):
    """Raises unless the operands fit together; returns (R, N)."""
    if u.dim() != 4 or xdbl.dim() != 4 or xdbl.shape[:3] != u.shape[:3]:
        raise ValueError(f"u must be (B, H, W, D) and x_dbl (B, H, W, 4E) "
                         f"at the same tokens, got {tuple(u.shape)} and "
                         f"{tuple(xdbl.shape)}")
    d = u.shape[-1]
    if dt_weight.dim() != 3 or tuple(dt_weight.shape[:2]) != (4, d):
        raise ValueError(f"dt_weight must be (4, {d}, R), got "
                         f"{tuple(dt_weight.shape)}")
    r = dt_weight.shape[-1]
    if a.dim() != 3 or tuple(a.shape[:2]) != (4, d):
        raise ValueError(f"a must be (4, {d}, N), got {tuple(a.shape)}")
    n = a.shape[-1]
    if xdbl.shape[-1] != 4 * (r + 2 * n):
        raise ValueError(f"x_dbl must have 4 x (R + 2N) = {4 * (r + 2 * n)}"
                         f" channels, got {xdbl.shape[-1]}")
    for name, t in (("dt_bias", dt_bias), ("ds", ds)):
        if tuple(t.shape) != (4, d):
            raise ValueError(f"{name} must be (4, {d}), got "
                             f"{tuple(t.shape)}")
    if xdbl.dtype != u.dtype:
        raise TypeError(f"x_dbl is {xdbl.dtype}, u is {u.dtype}")
    z, weight, bias, _ = gate
    if z.shape != u.shape or z.dtype != u.dtype:
        raise ValueError(f"z must be u's {tuple(u.shape)} {u.dtype}, got "
                         f"{tuple(z.shape)} {z.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (d,):
            raise ValueError(f"the gate's {name} must be ({d},), got "
                             f"{tuple(t.shape)}")
    for name, t in (("x_dbl", xdbl), ("dt_weight", dt_weight),
                    ("dt_bias", dt_bias), ("a", a), ("ds", ds), ("z", z),
                    ("weight", weight), ("bias", bias)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    return r, n


def chunk_length(delta, a) -> int:
    """The twin's chunk: ``CHUNK`` tokens, halved until |A| times every
    chunk's delta sum is at most ``MAX_EXPONENT`` (so exp(-that) stays a
    normal fp32 number)."""
    length = delta.shape[2]
    amax = float(a.abs().amax())
    t = CHUNK
    while t > 1:
        pad = (-length) % t
        sums = F.pad(delta, (0, 0, 0, pad)).unflatten(2, (-1, t)).sum(3)
        if amax * float(sums.amax()) <= MAX_EXPONENT:
            break
        t //= 2
    return t


def scan_directions(u, xdbl, dt_weight, dt_bias, a, ds) -> torch.Tensor:
    """The (B, 4, L, D) fp32 outputs y_l + ds u_l of each direction in its
    own order: within each chunk (``chunk_length``) the recurrence's
    closed form h_l = E_l (h_0 + sum_{s <= l} delta_s u_s B_s / E_s), E_l
    = exp(A sum_{s <= l} delta_s) from the chunk's start, and the (B, 4,
    D, N) state carried from chunk to chunk."""
    b, h, w, d = u.shape
    r, n = dt_weight.shape[-1], a.shape[-1]
    order = scan_order(h, w, u.device)
    k = torch.arange(4, device=u.device)[:, None]
    us = u.float().reshape(b, h * w, d)[:, order]              # (B, 4, L, D)
    xs = xdbl.float().reshape(b, h * w, 4, r + 2 * n)[:, order, k]
    delta = F.softplus(torch.einsum("bkle,kde->bkld", xs[..., :r],
                                    dt_weight.float())
                       + dt_bias.float()[:, None, :])
    bm, cm = xs[..., r:r + n], xs[..., r + n:]
    af = a.float()
    state = torch.zeros((b, 4, d, n), dtype=torch.float32, device=u.device)
    ys = torch.empty((b, 4, h * w, d), dtype=torch.float32, device=u.device)
    t = chunk_length(delta, af)
    for s0 in range(0, h * w, t):
        dl = delta[:, :, s0:s0 + t]
        e = torch.exp(dl.cumsum(2)[..., None] * af[:, None])  # (B,4,t,D,N)
        x = (dl * us[:, :, s0:s0 + t])[..., None] * bm[:, :, s0:s0 + t,
                                                       None, :]
        hs = torch.cumsum(x.div_(e), 2).add_(state[:, :, None]).mul_(e)
        ys[:, :, s0:s0 + t] = torch.einsum("bktdn,bktn->bktd", hs,
                                           cm[:, :, s0:s0 + t])
        state = hs[:, :, -1]
    return ys + ds.float()[None, :, None, :] * us


def combine(ys, h: int, w: int, dtype, gate) -> torch.Tensor:
    """(B, H, W, D) in ``dtype``: the four directions' (B, 4, L, D) fp32
    outputs at their tokens, summed ((y_0 + y_2) + y_1) + y_3, then
    ``gate``'s LayerNorm(y) SiLU(z) in fp32."""
    b, _, _, d = ys.shape
    order = scan_order(h, w, ys.device)
    back = torch.empty_like(ys)
    for k in range(4):
        back[:, k, order[k]] = ys[:, k]
    y = (((back[:, 0] + back[:, 2]) + back[:, 1]) + back[:, 3]).reshape(
        b, h, w, d)
    z, weight, bias, eps = gate
    y = F.layer_norm(y, (d,), weight.float(), bias.float(), eps) * (
        F.silu(z.float()))
    return y.to(dtype)


def selective_scan_plain(u, xdbl, dt_weight, dt_bias, a, ds, gate):
    """Plain twin, on any device: ``scan_directions`` then ``combine``."""
    _check(u, xdbl, dt_weight, dt_bias, a, ds, gate)
    b, h, w, _ = u.shape
    return combine(scan_directions(u, xdbl, dt_weight, dt_bias, a, ds), h,
                   w, u.dtype, gate)


def _partials(device, numel: int) -> torch.Tensor:
    """A flat fp32 buffer of at least ``numel`` values on ``device``, kept
    for the process (a captured graph holds its address): the first call
    at a new size, eager, makes it; none is made inside a capture."""
    bufs = _scratch.setdefault(device, [])
    for buf in bufs:
        if buf.numel() >= numel:
            return buf
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("kernel K's scratch grown inside a CUDA graph "
                           "capture: run the model eagerly first")
    buf = torch.empty(numel, dtype=torch.float32, device=device)
    bufs.append(buf)
    return buf


def selective_scan(u, xdbl, dt_weight, dt_bias, a, ds, gate):
    """The four-direction selective scan of the (B, H, W, D) map ``u`` and
    SS2D's gate (module docstring): the CUDA kernels for CUDA tensors
    (bf16 u, x_dbl and z, contiguous and 16-byte aligned, D a multiple of
    8 up to ``MAX_D``, R = 12 and N = 16, fp32 contiguous parameters), the
    plain twin on the CPU, an empty map of u's shape on the meta device
    (the FLOP count, which ``counts/mambair`` makes for the scan). On the
    card the four
    directions' fp32 outputs go through a (4, B, H, W, D) scratch kept per
    device (``_partials``), made at the first eager call of a size, so a
    captured graph allocates nothing for it. Counts calls (a scan and a
    combine kernel each) in ``selective_scan.launches``."""
    r, n = _check(u, xdbl, dt_weight, dt_bias, a, ds, gate)
    if u.device.type == "meta":
        return torch.empty_like(u)
    if u.device.type == "cpu":
        return selective_scan_plain(u, xdbl, dt_weight, dt_bias, a, ds,
                                    gate)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    if u.dtype != torch.bfloat16:
        raise TypeError(f"u is {u.dtype}: kernel K is bf16 only")
    b, h, w, d = u.shape
    if (r, n) != (RANK, STATE) or d % 8 or d > MAX_D:
        raise ValueError(f"R {r}, N {n}, D {d}: kernel K takes R {RANK}, "
                         f"N {STATE} and D a multiple of 8 up to {MAX_D}")
    z, weight, bias, eps = gate
    params = (dt_weight, dt_bias, a, ds, weight, bias)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in params):
        raise TypeError("dt_weight, dt_bias, a and ds must be contiguous "
                        "float32")
    for name, t in (("u", u), ("x_dbl", xdbl), ("z", z)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if xdbl.numel() >= 2 ** 31 or u.numel() >= 2 ** 31:
        raise ValueError(f"{tuple(u.shape)}: kernel K indexes fewer than "
                         "2**31 values")
    part = _partials(u.device, 4 * u.numel())
    y = torch.empty_like(u)
    code = build.load_library().w2x_selective_scan(
        u.data_ptr(), xdbl.data_ptr(), dt_weight.data_ptr(),
        dt_bias.data_ptr(), a.data_ptr(), ds.data_ptr(), z.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), part.data_ptr(), y.data_ptr(),
        b, h, w, d, float(eps),
        build.stream_handle(u.device))
    build.check(code, "selective scan kernel")
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
