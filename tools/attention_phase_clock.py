"""Phase clocks of kernels A's and E's bf16 (tensor-core) kernel on one
NVIDIA GPU.

    python3 tools/attention_phase_clock.py [--iters 10] [--shift 4] [--root DIR]

Builds the measurement variant of the kernels' library (nvcc
-DW2X_PHASE_CLOCK: thread 0 of every CTA adds the clock64() cycles of each
phase into device counters) beside the plain one, and at the flagship
shapes (A at BW 4096, C 96 and BW 1024, C 192; E at BW 4096, nh 3; seeded
inputs, flags of every kind) prints:

- registers per thread, resident CTAs and warps per SM of the kernel;
- the launch time of the plain build and of the measurement build
  (``chip_smoke.py``'s ``_median_ms``: per launch, the median over
  ``--iters`` samples of 10 launches in a row, CUDA events) beside the
  bound (``chip_smoke.py``'s), so the cost of the clocks shows;
- the cycles of an average (window, head) unit in each phase, as thread 0
  of its CTA issues them: the copy-in wait (cp.async completion of the
  unit's rows, the CTA barrier, the copy of a later unit issued), bias + q
  + q k^T, the softmax, p v with the output written to shared memory, and
  the output store (16-byte stores of the warp's rows). An asynchronous
  instruction's latency shows in the phase that first reads its result;
- the SM clock and the time the units of one CTA take at that clock
  against the measured launch.

``--root DIR`` imports ``waifu2x_tensorrt_tpu_torch`` from DIR (an
unpacked other version, to compare two in one call). Needs a CUDA device
and nvcc; exits 1 without a device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

# (counter, label) in kernel order; see W2X_PHASE_CLOCK in window_attention.cu
PHASES = ((0, "copy-in wait"), (1, "bias + q + q k^T"), (2, "softmax"),
          (3, "p v"), (4, "output store"))
FLAGS = ("-DW2X_PHASE_CLOCK",)
ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--shift", type=int, default=4, choices=(0, 4))
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's timing method and bounds

    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("attention_phase_clock: no CUDA device available",
              file=sys.stderr)
        return 1
    from waifu2x_tensorrt_tpu_torch.ops import build
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    print(f"card: {smi('name,power.limit')}", flush=True)
    plain = build.load_library()
    clocked = build.load_library(FLAGS)
    clocked.w2x_read_attn_cycles.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * 8)()

    for kernel, bw, nh in (("A", 4096, 3), ("A", 1024, 6), ("E", 4096, 3)):
        c = 32 * nh
        rng = np.random.default_rng(bw + c)

        def t(a, dtype=torch.bfloat16):
            return torch.from_numpy(np.asarray(a, np.float32)).to("cuda",
                                                                  dtype)

        bias = t(rng.normal(0, 0.2, (nh, 64, 64)), torch.float32)
        flags = torch.from_numpy(
            rng.integers(0, 4, bw).astype(np.int32)).cuda()
        stream = build.stream_handle(bias.device)
        if kernel == "A":
            qkv = t(rng.normal(0, 1, (bw, 64, 3 * c)))
            out = torch.empty((bw, 64, c), dtype=torch.bfloat16,
                              device="cuda")

            def launch(lib):
                build.check(lib.w2x_window_attention_qkv(
                    qkv.data_ptr(), bias.data_ptr(), flags.data_ptr(),
                    out.data_ptr(), bw, c, nh, args.shift, 1, stream), "A")
        else:
            q, k, v = (t(rng.normal(0, 1, (bw, nh, 64, 32)))
                       for _ in range(3))
            out = torch.empty_like(q)

            def launch(lib):
                build.check(lib.w2x_window_attention_heads(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias.data_ptr(), flags.data_ptr(), out.data_ptr(), bw,
                    nh, args.shift, 1, stream), "E")
        occ = wa.tc_occupancy()
        bound = cs._bound(*cs._attention_work(bw, nh, 2))[0]
        ms_plain = cs._median_ms(lambda: launch(plain), iters=args.iters)
        ms_clocked = cs._median_ms(lambda: launch(clocked),
                                   iters=args.iters)
        build.check(clocked.w2x_read_attn_cycles(counters), "read")  # clear
        launch(clocked)
        torch.cuda.synchronize()
        build.check(clocked.w2x_read_attn_cycles(counters), "read")
        sm_mhz = float(smi("clocks.sm").split()[0])
        n_units = counters[5]
        per_unit = {i: counters[i] / n_units for i, _ in PHASES}
        total = sum(per_unit.values())
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        ctas = occ["ctas_per_sm"] * n_sm
        grid = min(n_units, ctas - ctas % nh)
        per_cta = -(-n_units // grid)
        print(f"kernel {kernel} BW {bw}, nh {nh}, bf16, shift {args.shift}: "
              f"{occ['registers']} registers a thread, "
              f"{occ['ctas_per_sm']} CTAs = {occ['warps_per_sm']} warps per "
              f"SM, {n_units} units on {grid} CTAs (up to {per_cta} "
              f"each); launch {ms_plain:.4f} ms (plain build), "
              f"{ms_clocked:.4f} ms (clocked build), bound {bound:.4f} ms "
              f"({100 * bound / ms_plain:.1f}% of it)", flush=True)
        print(f"  cycles of an average unit (thread 0), {total:.0f} in "
              "all:")
        for i, name in PHASES:
            cyc = per_unit[i]
            print(f"    {name:18s} {cyc:10.0f}  {100 * cyc / total:5.1f}%")
        print(f"  SM clock {sm_mhz:.0f} MHz after the runs: {per_cta} units"
              f" x {total:.0f} cycles = {per_cta * total / sm_mhz / 1e3:.4f}"
              f" ms against the {ms_clocked:.4f} ms launch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
