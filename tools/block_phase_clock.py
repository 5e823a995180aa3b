"""Phase clocks of kernel B (bf16 tensor-core or fp32 kernel) on one
NVIDIA GPU.

    python3 tools/block_phase_clock.py [--dtype bf16|fp32] [--iters 5]
                                       [--shift 4] [--root DIR]

Builds the measurement variant of the kernels' library (nvcc
-DW2X_PHASE_CLOCK: thread 0 of every CTA adds the clock64() cycles of each
phase into device counters) beside the plain one, and at the flagship
shapes (BW 4096, C 96, 3 heads; BW 1024, C 192, 6 heads; seeded inputs,
flags of every kind) prints:

- registers per thread and resident CTAs per SM of the kernel;
- the launch time of the plain build and of the measurement build
  (median of ``--iters`` launches, CUDA events), so the cost of the clocks
  shows;
- the cycles of an average CTA in each phase: x load + LN1, the K | V
  GEMM tiles, the attention heads (bias + q_h, q k^T, softmax, p v,
  proj), x1 + LN2, the MLP chunks (fc1 + GELU, fc2), the output store
  (fp32: x load + LN1, per head the q, k, v products, the attention and
  proj, then x1 + LN2, the MLP chunks and the store);
  and, inside those, the waits at the weight-tile barriers (cp.async
  completion and the CTA barrier). A phase's cycles run from the previous
  clock point to its own, as thread 0 issues them: an asynchronous
  product's latency shows in the phase that first reads its result;
- the SM clock and the time the CTAs' cycles would take at that clock,
  per wave of resident CTAs, against the measured launch.

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

# (counter, label) in kernel order; see W2X_PHASE_CLOCK in swin_block.cu
PHASES = {
    "bf16": ((0, "x load + LN1"), (1, "K | V tiles"),
             (8, "heads: bias + q_h"), (9, "heads: q k^T"),
             (10, "heads: softmax"), (11, "heads: p v"), (2, "heads: proj"),
             (3, "x1 + LN2"), (12, "MLP: fc1 + GELU"), (4, "MLP: fc2"),
             (5, "output store")),
    "fp32": ((0, "x load + LN1"), (8, "heads: q, k, v"),
             (9, "heads: attention"), (2, "heads: proj"), (3, "x1 + LN2"),
             (12, "MLP: fc1 + GELU"), (4, "MLP: fc2"), (5, "output store")),
}
FLAGS = ("-DW2X_PHASE_CLOCK",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=tuple(PHASES), default="bf16")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--shift", type=int, default=4, choices=(0, 4))
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("block_phase_clock: no CUDA device available", file=sys.stderr)
        return 1
    from waifu2x_tensorrt_tpu_torch.ops import build
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    print(f"card: {smi('name,power.limit')}", flush=True)
    plain = build.load_library()
    clocked = build.load_library(FLAGS)
    clocked.w2x_read_phase_cycles.argtypes = [ctypes.c_void_p]
    clocked.w2x_swin_block_tc_info.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    fp32 = args.dtype == "fp32"
    dtype = torch.float32 if fp32 else torch.bfloat16
    counters = (ctypes.c_ulonglong * 16)()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def launch(lib, x, ops, flags, out):
        code = lib.w2x_swin_block(
            x.data_ptr(), *[t.data_ptr() for t in ops.tensors],
            ops.bias.data_ptr(), flags.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[2], ops.num_heads, args.shift, 8, 8, 0,
            int(not fp32), build.stream_handle(x.device))
        build.check(code, "swin block kernel")

    def median_ms(fn):
        fn()
        times = []
        for _ in range(args.iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    for bw, c, nh in ((4096, 96, 3), (1024, 192, 6)):
        rng = np.random.default_rng(c)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).cuda()

        params = {
            "n1_scale": t(rng.normal(1, 0.1, c)),
            "n1_bias": t(rng.normal(0, 0.1, c)),
            "qkv_kernel": t(rng.normal(0, 0.05, (c, 3 * c))),
            "qkv_bias": t(rng.normal(0, 0.05, 3 * c)),
            "proj_kernel": t(rng.normal(0, 0.05, (c, c))),
            "proj_bias": t(rng.normal(0, 0.05, c)),
            "n2_scale": t(rng.normal(1, 0.1, c)),
            "n2_bias": t(rng.normal(0, 0.1, c)),
            "fc1_kernel": t(rng.normal(0, 0.05, (c, 2 * c))),
            "fc1_bias": t(rng.normal(0, 0.05, 2 * c)),
            "fc2_kernel": t(rng.normal(0, 0.05, (2 * c, c))),
            "fc2_bias": t(rng.normal(0, 0.05, c)),
        }
        ops = sb.block_operands(params, t(rng.normal(0, 0.2, (nh, 64, 64))),
                                dtype)
        flags = torch.from_numpy(
            rng.integers(0, 4, bw).astype(np.int32)).cuda()
        x = t(rng.normal(0, 1, (bw, 64, c))).to(dtype)
        out = torch.empty_like(x)
        regs, ctas = ctypes.c_int(), ctypes.c_int()
        if fp32:
            local = ctypes.c_int()
            build.check(clocked.w2x_swin_block_f32_info(
                c, ctypes.byref(regs), ctypes.byref(local),
                ctypes.byref(ctas)), "info")
        else:
            build.check(clocked.w2x_swin_block_tc_info(
                c, ctypes.byref(regs), ctypes.byref(ctas)), "info")
        ms_plain = median_ms(lambda: launch(plain, x, ops, flags, out))
        ms_clocked = median_ms(lambda: launch(clocked, x, ops, flags, out))
        build.check(clocked.w2x_read_phase_cycles(counters), "read")  # clear
        launch(clocked, x, ops, flags, out)
        torch.cuda.synchronize()
        build.check(clocked.w2x_read_phase_cycles(counters), "read")
        sm_mhz = float(smi("clocks.sm").split()[0])
        n_cta = counters[7]
        per_cta = {i: counters[i] / n_cta for i in range(16)}
        total = sum(per_cta[i] for i, _ in PHASES[args.dtype])
        waves = -(-n_cta // (ctas.value * n_sm))
        print(f"BW {bw}, C {c}, {nh} heads, {args.dtype}, shift {args.shift}: "
              f"{regs.value} "
              f"registers a thread, {ctas.value} CTAs per SM, {n_cta} CTAs "
              f"= {waves} waves on {n_sm} SMs; launch {ms_plain:.3f} ms "
              f"(plain build), {ms_clocked:.3f} ms (clocked build)",
              flush=True)
        print(f"  cycles of an average CTA (thread 0), {total:.0f} in all:")
        for i, name in PHASES[args.dtype]:
            cyc = per_cta[i]
            print(f"    {name:18s} {cyc:10.0f}  {100 * cyc / total:5.1f}%")
        print(f"    {'waits at barriers':18s} {per_cta[6]:10.0f}  "
              f"{100 * per_cta[6] / total:5.1f}%  (inside the heads and "
              "the MLP)")
        print(f"  SM clock {sm_mhz:.0f} MHz after the runs: {waves} waves x "
              f"{total:.0f} cycles = {waves * total / sm_mhz / 1e3:.3f} ms "
              f"against the {ms_clocked:.3f} ms launch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
