"""The int8 feasibility study on the GPU: s8 against bf16 on the tensor
cores, the counterpart of the JAX package's two probe scripts.

- Path (b), ``probes/int8_pallas_probe.py``: kernel F (``ops.mma_probe``)
  runs R = 2048 serialized products on operands held in shared memory, at
  an ideal control shape and the three stage-1 GEMM shapes of the fused
  Swin block, s8 -> s32 and bf16 -> fp32. Each rate is printed beside the
  dense tensor-core peak of its type.
- Path (a), ``probes/int8_matmul_probe.py``: one library call per product
  at the model's row counts, ``torch._int_mm`` (s8 -> s32) against a bf16
  ``torch.matmul``. A yardstick only: the port calls neither on any path.

Decision gate for an int8 serving precision (the JAX probe's): pursue it
only if the int8 rate of path (b) is >= 1.5x bf16 at BOTH the ideal shape
and the stage-1 qkv shape.

    python -m waifu2x_tensorrt_tpu_torch.probes.int8_probe

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

# (name, M, K, N): an ideal control and the fused stage-1 GEMM geometries
# (32 windows x 64 tokens, C = 96), as in probes/int8_pallas_probe.py
SHAPES = [
    ("ideal 512^2xK1024", 512, 1024, 512),
    ("qkv s1 (2048,96,288)", 2048, 96, 288),
    ("fc1 s1 (2048,96,384)", 2048, 96, 384),
    ("fc2 s1 (2048,384,96)", 2048, 384, 96),
]
R = 2048  # serialized products per call
# path (a): the stage-1 GEMMs at 16 x 4096 windows' rows and a square
# control, as in probes/int8_matmul_probe.py
LIBRARY_SHAPES = [
    ("qkv s1", 16 * 4096, 96, 288),
    ("fc1 s1", 16 * 4096, 96, 384),
    ("fc2 s1", 16 * 4096, 384, 96),
    ("ctrl 2048^3", 2048, 2048, 2048),
]
# dense tensor-core peaks of one H100 SXM (NVIDIA's data sheet), op/s
INT8_PEAK = 1979e12
BF16_PEAK = 989e12
GATE = 1.5  # int8 over bf16 at the ideal and the qkv shape


def make_inputs(m, k, n, rng, device="cpu"):
    """int8 a (m, k), int8 b (k, n), bf16 a, bf16 b, drawn with numpy in
    the JAX probe's order (uniform integers in [-127, 127], then standard
    normals rounded to bf16)."""
    a8 = rng.integers(-127, 128, (m, k), np.int8)
    b8 = rng.integers(-127, 128, (k, n), np.int8)
    af = rng.standard_normal((m, k)).astype(np.float32)
    bf = rng.standard_normal((k, n)).astype(np.float32)
    return (torch.from_numpy(a8).to(device), torch.from_numpy(b8).to(device),
            torch.from_numpy(af).to(device, torch.bfloat16),
            torch.from_numpy(bf).to(device, torch.bfloat16))


def stack2(a):
    """The TPU kernel's lhs layout: a stacked twice, (2, M, K)."""
    return torch.stack([a, a])


def time_call(fn):
    """Median ms of 10 single calls on the card by CUDA events, after 2
    warm-up calls. A short device sleep before each start event keeps the
    host's launch of ``fn`` out of the interval."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def rates(ops, ms_bf16, ms_int8):
    """The rates (op/s) of one shape, each as a share of its peak, and the
    int8 speedup."""
    bf, i8 = ops / (ms_bf16 * 1e-3), ops / (ms_int8 * 1e-3)
    return {"bf16_ms": ms_bf16, "int8_ms": ms_int8, "bf16_rate": bf,
            "int8_rate": i8, "bf16_peak_share": bf / BF16_PEAK,
            "int8_peak_share": i8 / INT8_PEAK, "speedup": ms_bf16 / ms_int8}


def run():
    """Path (b) on the card: kernel F at each of ``SHAPES`` with R
    products, bf16 then int8 (the JAX probe's order), inputs from seed 0;
    one row per shape."""
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import mma_probe

    rng = np.random.default_rng(0)
    rows = []
    for name, m, k, n in SHAPES:
        a8, b8, abf, bbf = make_inputs(m, k, n, rng, "cuda")
        a2_8, a2_bf = stack2(a8), stack2(abf)
        t_bf = time_call(lambda: mma_probe(a2_bf, bbf, R))
        t_i8 = time_call(lambda: mma_probe(a2_8, b8, R))
        rows.append({"name": name, "m": m, "k": k, "n": n, "reps": R,
                     **rates(2.0 * m * k * n * R, t_bf, t_i8)})
    return rows


def library_calls(a8, b8, abf, bbf):
    """The two library calls of path (a): ``torch._int_mm`` with b
    column-major (the layout cuBLASLt's int8 kernels take) and a bf16
    ``torch.matmul``."""
    b8_cm = b8.t().contiguous().t()
    return (lambda: torch._int_mm(a8, b8_cm)), (lambda: torch.matmul(abf, bbf))


def run_library():
    """Path (a) on the card: one library call per product at each of
    ``LIBRARY_SHAPES``, inputs from seed 0; one row per shape."""
    rng = np.random.default_rng(0)
    rows = []
    for name, m, k, n in LIBRARY_SHAPES:
        a8, b8, abf, bbf = make_inputs(m, k, n, rng, "cuda")
        int_mm, mm = library_calls(a8, b8, abf, bbf)
        t_bf, t_i8 = time_call(mm), time_call(int_mm)
        rows.append({"name": name, "m": m, "k": k, "n": n,
                     **rates(2.0 * m * k * n, t_bf, t_i8)})
    return rows


def gate(rows):
    """The decision: int8 >= GATE x bf16 at the ideal and the qkv shape."""
    picked = [r for r in rows if r["name"].startswith(("ideal", "qkv"))]
    return len(picked) == 2 and all(r["speedup"] >= GATE for r in picked)


def card_label():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out[0] if out else "nvidia-smi printed nothing"


def _row_line(r, label):
    return (f"{r['name']:24s}: bf16 {r['bf16_rate'] / 1e12:7.1f} TF/s "
            f"({100 * r['bf16_peak_share']:5.1f}% of 989), int8 "
            f"{r['int8_rate'] / 1e12:7.1f} TOP/s "
            f"({100 * r['int8_peak_share']:5.1f}% of 1979), speedup "
            f"{r['speedup']:4.2f}x; {r['bf16_ms']:.4f} / {r['int8_ms']:.4f} "
            f"ms{label}")


def print_report(rows_b, rows_a, card):
    print(f"path (b), kernel F, R = {rows_b[0]['reps']} serialized products "
          f"per call, median of 10 calls (CUDA events), on {card}:",
          flush=True)
    for r in rows_b:
        print("  " + _row_line(r, " per call"), flush=True)
    print(f"path (a), one library call per product (torch._int_mm vs bf16 "
          f"torch.matmul), on {card}:", flush=True)
    for r in rows_a:
        name = f"{r['name']} ({r['m']},{r['k']},{r['n']})"
        print("  " + _row_line(dict(r, name=name), ""), flush=True)
    verdict = "pursue" if gate(rows_b) else "do not pursue"
    print(f"gate: int8 >= {GATE}x bf16 at both the ideal and the qkv shape: "
          f"{gate(rows_b)} -> {verdict} an int8 serving precision",
          flush=True)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("int8_probe: no CUDA device available", file=sys.stderr)
        return 1
    print_report(run(), run_library(), card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
