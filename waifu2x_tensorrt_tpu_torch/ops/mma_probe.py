"""Kernel F: the int8/bf16 tensor-core probe — R serialized matrix
products with a carry.

``mma_probe`` is the wrapper of the CUDA kernel ``csrc/mma_probe.cu`` (the
port of the TPU kernel ``probes/int8_pallas_probe.py::run``);
``mma_probe_plain`` is its plain PyTorch twin. Both take the TPU kernel's
layout: a2 (2, M, K), one lhs stacked twice, and b (K, N), both int8 or
both bf16. For i = 0..reps-1, acc = a2[0] @ b + carry(acc) from acc = 0:
- int8 gives int32, carry = acc >> 31 (arithmetic, so 0 or -1): for
  reps >= 2 the result is D - (D < 0), D = a2[0] @ b in exact integers;
- bf16 gives float32, carry = acc * 0: the result is the last product,
  NaN once an earlier one was not finite.
a2[1] is not read, on either device. The TPU kernel takes a2[i % 2] only
to stop Mosaic hoisting the product out of its loop, and the probe stacks
one lhs twice (``torch.stack([a, a])``), so for the probe's inputs this
is the TPU kernel's function.
"""

from __future__ import annotations

import torch

from waifu2x_tensorrt_tpu_torch.ops import build

_ACC = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
MAX_K_BYTES = 2048  # K * element size: a 64 x 32 CTA tile's slabs in 227 KB


def _check_layout(a2, b, reps):
    if a2.dtype not in _ACC or b.dtype != a2.dtype:
        raise TypeError(f"a2 and b must both be int8 or both bfloat16, got "
                        f"{a2.dtype} and {b.dtype}")
    if (a2.dim() != 3 or a2.shape[0] != 2 or b.dim() != 2
            or b.shape[0] != a2.shape[2]):
        raise ValueError(f"a2 must be (2, M, K) and b (K, N), got "
                         f"{tuple(a2.shape)} and {tuple(b.shape)}")
    if isinstance(reps, bool) or not isinstance(reps, int) or reps < 0:
        raise ValueError(f"reps must be an int >= 0, got {reps!r}")


def _check(a2, b, reps):
    _check_layout(a2, b, reps)
    m, k, n = a2.shape[1], a2.shape[2], b.shape[1]
    if min(m, k, n) <= 0 or m % 32 or k % 32 or n % 32:
        raise ValueError(f"M, K and N must be positive multiples of 32, got "
                         f"({m}, {k}, {n})")
    if k * a2.element_size() > MAX_K_BYTES:
        raise ValueError(f"K = {k} {a2.dtype} is more than {MAX_K_BYTES} "
                         "bytes a row")


def mma_probe_plain(a2, b, reps: int):
    """Plain twin: the literal loop over a2[0]. The int8 product is taken
    in float64 and cast to int32, exact because |D| <= 128^2 K < 2^53
    (there is no integer matmul on CUDA); the bf16 product in float32 with
    TF32 off."""
    _check_layout(a2, b, reps)
    shape = (a2.shape[1], b.shape[1])
    if a2.dtype == torch.int8:
        a, w = a2[0].double(), b.double()
        acc = torch.zeros(shape, dtype=torch.int32, device=a2.device)
        for _ in range(reps):
            acc = (a @ w).to(torch.int32) + (acc >> 31)
        return acc
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a, w = a2[0].float(), b.float()
        acc = torch.zeros(shape, dtype=torch.float32, device=a2.device)
        for _ in range(reps):
            acc = a @ w + acc * 0
        return acc
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def fp32_sum_bound(a, b) -> float:
    """How far two float32 sums of the products of a (M, K) and b (K, N)
    may differ, in any order: twice K u max_mn sum_k |a_mk| |b_kn|, with
    u = 2^-24 the unit roundoff (each sum is within K u of that of the
    exact value, to first order). The products of bf16 values are exact in
    float32, so only the sums round."""
    k = a.shape[-1]
    mag = a.double().abs() @ b.double().abs()
    return k * 2.0 ** -23 * mag.max().item()


def mma_probe(a2, b, reps: int):
    """R = ``reps`` serialized products with the carry: the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors. Returns (M, N) int32
    (int8 operands) or float32 (bf16). Counts kernel launches in
    ``mma_probe.launches``."""
    _check(a2, b, reps)
    if a2.device.type == "cpu" and b.device.type == "cpu":
        return mma_probe_plain(a2, b, reps)
    if a2.device.type != "cuda" or b.device != a2.device:
        raise ValueError(f"a2 and b must lie on one CUDA device, got "
                         f"{a2.device} and {b.device}")
    if not (a2.is_contiguous() and b.is_contiguous()):
        raise ValueError("a2 and b must be contiguous")
    if a2.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a2 and b must be 16-byte aligned")
    m, k, n = a2.shape[1], a2.shape[2], b.shape[1]
    out = torch.empty((m, n), dtype=_ACC[a2.dtype], device=a2.device)
    with torch.cuda.device(a2.device):
        code = build.load_library().w2x_mma_probe(
            a2.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, reps,
            int(a2.dtype == torch.bfloat16), build.stream_handle(a2.device))
    build.check(code, "mma probe kernel")
    mma_probe.launches += 1
    return out


mma_probe.launches = 0
