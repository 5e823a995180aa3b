"""Kernels D and F against the alternatives their designs chose between,
measured on one NVIDIA GPU.

    python3 tools/kernel_variants.py [--kernel D|F]

Builds variants of ``waifu2x_tensorrt_tpu_torch/ops/csrc/head_pack.cu``
(D) and ``mma_probe.cu`` (F) — text substitutions of this checkout's
source, or another source file — one ``nvcc`` each, all started together,
into ``build/kernels/variants/``, prints what ptxas says of each (its
registers and any wgmma serialization, C7514/C7515), checks each against
the plain twin and times it:

- D: bf16 and fp32 at r 4, (16, 256, 256, 48), by ``chip_smoke.py``'s
  method (median of 10 samples of 10 calls in a row, CUDA events) beside
  the bound; every variant must give the plain twin's bytes. Variants: as
  built (1 item a thread); 2 items a thread; streaming stores
  (``__stcs``); the shared-memory candidate ``tools/head_pack_smem.cu``
  (runs of 64 pixels behind ``cp.async`` double buffering).
- F: bf16 and int8 at the probe's four shapes, R 2048, by the probe's
  method (``int8_probe.time_call``), with the share of the dense peak;
  int8 must equal the plain twin and bf16 stay within ``fp32_sum_bound``
  (at R 5). Variants: as built (A in registers up to 512 bytes of K a
  row, the k loop unrolled to 64 steps and left at the step count); A
  from shared memory at every K, and with it: each step's descriptor as
  the slab's plus a constant; the k loop run at run time, one step a pass
  and four; two accumulator sets in turn (product r + 1 issued before the
  carry of product r, ``wgmma.wait_group 1``), with and without the
  operand fence after the issue.

Needs a CUDA device and nvcc; exits 1 without a device.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# F: two accumulator sets in turn, in place of product_carry and its loop
_F_PRODUCT_START = "// One product a2[0] @ b into d, then its carry"
_F_PRODUCT_END = "// A CTA computes the 64 x 32 output tile"
_F_LOOP_START = "  Acc acc[MP_ACC], d[MP_ACC];"
_F_UNROLLED = ("#pragma unroll\n"
               "  for (int s = 0; s < (REG_A ? NA : MP_MAX_KBYTES / 32); "
               "++s) {\n    if (s >= steps) break;")
# A from shared memory at every K (no register-A path)
_F_NO_REG_A = [("  if (K * (int)sizeof(T) <= MP_REGA_MAX_KBYTES)",
                "  if (false)")]
_F_LOOP_END = "  // the accumulator fragment map"
_F_TWO_SETS_FUNCS = """template <typename T>
__device__ __forceinline__ void issue_product(
    typename Probe<T>::Acc (&d)[MP_ACC], uint32_t sa, uint32_t sb,
    int steps) {  // A from shared memory only
  using Mma = wg::Mma<MP_BN, typename Probe<T>::Acc>;
  wg::fence_operands(d);
  wg::fence();
#pragma unroll
  for (int s = 0; s < MP_MAX_KBYTES / 32; ++s) {
    if (s >= steps) break;
    const uint32_t blk = s >> 2, k = (s & 3) * 32;
    Mma::run(d, wg::desc_sw128(sa + blk * (MP_BM * 128) + k),
             wg::desc_sw128(sb + blk * (MP_BN * 128) + k), s > 0);
  }
  wg::commit();
  wg::fence_operands(d);
}

template <typename T, int WAIT>
__device__ __forceinline__ void carry_product(
    typename Probe<T>::Acc (&acc)[MP_ACC],
    typename Probe<T>::Acc (&d)[MP_ACC]) {
  wg::wait<WAIT>();
  wg::fence_operands(d);
#pragma unroll
  for (int i = 0; i < MP_ACC; ++i) acc[i] = Probe<T>::carry_add(acc[i], d[i]);
}

"""
_F_TWO_SETS_LOOP = """  Acc acc[MP_ACC], d0[MP_ACC], d1[MP_ACC];
#pragma unroll
  for (int i = 0; i < MP_ACC; ++i) acc[i] = d0[i] = d1[i] = Acc(0);
  const int steps = kb / 32;
  if (reps > 0) issue_product<T>(d0, sa32, sb32, steps);
  int r = 1;
#pragma unroll 1
  for (; r + 1 < reps; r += 2) {
    issue_product<T>(d1, sa32, sb32, steps);
    carry_product<T, 1>(acc, d0);
    issue_product<T>(d0, sa32, sb32, steps);
    carry_product<T, 1>(acc, d1);
  }
  if (r < reps) {
    issue_product<T>(d1, sa32, sb32, steps);
    carry_product<T, 1>(acc, d0);
    carry_product<T, 0>(acc, d1);
  } else if (reps > 0) {
    carry_product<T, 0>(acc, d0);
  }

"""


def _between(src, start, end):
    return src[src.index(start):src.index(end)]


def _variants(csrc):
    """{kernel: {name: (source file, substitutions)}}"""
    hp, mp = csrc / "head_pack.cu", csrc / "mma_probe.cu"
    f_src = mp.read_text()
    two_sets = [(_between(f_src, _F_PRODUCT_START, _F_PRODUCT_END),
                 _F_TWO_SETS_FUNCS),
                (_between(f_src, _F_LOOP_START, _F_LOOP_END),
                 _F_TWO_SETS_LOOP)]
    return {
        "D": {
            "as built (1 item a thread)": (hp, []),
            "2 items a thread": (hp, [("constexpr int HP_ITEMS = 1;",
                                       "constexpr int HP_ITEMS = 2;")]),
            "streaming stores (__stcs)": (hp, [
                ("for (int j = 0; j < 3; ++j) dst[j] = s[j];",
                 "for (int j = 0; j < 3; ++j) __stcs(dst + j, s[j]);")]),
            "shared memory, cp.async double buffer": (
                ROOT / "tools" / "head_pack_smem.cu", []),
        },
        "F": {
            "as built": (mp, []),
            "A from shared memory at every K": (mp, _F_NO_REG_A),
            "descriptors as one base plus a constant a step": (
                mp, _F_NO_REG_A + [
                    ("    const uint64_t db = wg::desc_sw128(sb + blk * "
                     "(MP_BN * 128) + k);",
                     "    const uint64_t db = wg::desc_sw128(sb) + ((blk * "
                     "MP_BN * 128 + k) >> 4);"),
                    ("          d, wg::desc_sw128(sa + blk * (MP_BM * 128) + "
                     "k), db, s > 0);",
                     "          d, wg::desc_sw128(sa) + ((blk * MP_BM * 128 + "
                     "k) >> 4), db, s > 0);")]),
            "k loop at run time": (mp, _F_NO_REG_A + [
                (_F_UNROLLED, "#pragma unroll 1\n"
                              "  for (int s = 0; s < steps; ++s) {")]),
            "k loop at run time, 4 steps a pass": (mp, _F_NO_REG_A + [
                (_F_UNROLLED, "#pragma unroll 4\n"
                              "  for (int s = 0; s < steps; ++s) {")]),
            "two accumulator sets in turn": (mp, _F_NO_REG_A + two_sets),
            "two sets, no operand fence after the issue": (
                mp, _F_NO_REG_A + [
                    (old, new.replace("  wg::commit();\n"
                                      "  wg::fence_operands(d);",
                                      "  wg::commit();"))
                    for old, new in two_sets]),
        },
    }


def _variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old[:60]!r} "
                               "once")
        src = src.replace(old, new)
    return src


def _build(build, kernels, variants):
    """{(kernel, name): C entry point}, building every variant at once."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for kernel in kernels:
        for i, (name, (path, subs)) in enumerate(variants[kernel].items()):
            cu = out_dir / f"{kernel}_v{i}.cu"
            cu.write_text(_variant_source(path.read_text(), subs))
            so = out_dir / f"lib{kernel}_v{i}.so"
            jobs.append((kernel, name, so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-Xptxas", "-v", "-shared", str(cu), "-o", str(so)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    entry = {"D": "w2x_head_pack", "F": "w2x_mma_probe"}
    fns = {}
    for kernel, name, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} {name!r}:\n{log}")
        regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers",
                                                  log)})
        serial = sorted(set(re.findall(r"\((C751[45])\)", log)))
        spills = max(int(n) for n in re.findall(
            r"(\d+) bytes spill stores", log))
        print(f"{kernel} {name}: {regs[0]}-{regs[-1]} registers, spill "
              f"stores up to {spills} bytes; wgmma "
              f"serialized by ptxas: {', '.join(serial) or 'no'}; fences "
              f"and waits ptxas added: {log.count('(C7519)')} and "
              f"{log.count('(C7517)')}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), entry[kernel])
        fn.argtypes = build._SIGNATURES[entry[kernel]]
        fn.restype = ctypes.c_int
        fns[(kernel, name)] = fn
    return fns


def _time_d(torch, cs, build, fns):
    from waifu2x_tensorrt_tpu_torch.ops.head_pack import pack_head_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    z32 = torch.rand((16, 256, 256, 48), generator=gen,
                     device="cuda") * 1.6 - 0.3
    for z in (z32.bfloat16(), z32):
        want = pack_head_plain(z, 4)
        bms, by = cs._bound(*cs._head_pack_work(z))
        for (kernel, name), fn in fns.items():
            if kernel != "D":
                continue
            out = torch.empty_like(want)

            def call():
                build.check(fn(z.data_ptr(), out.data_ptr(), 16, 256, 256,
                               4, int(z.dtype == torch.bfloat16),
                               build.stream_handle(z.device)), name)

            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"D {name}: not the plain twin's bytes")
            ms = cs._median_ms(call)
            print(f"D {name} {str(z.dtype)[6:]} r 4 (16, 256, 256, 48): "
                  f"{ms:.4f} ms ({100 * bms / ms:.1f}% of the bound "
                  f"{bms:.4f} ms by {by}); bytes equal", flush=True)


def _time_f(torch, build, fns):
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (
        fp32_sum_bound,
        mma_probe_plain,
    )
    from waifu2x_tensorrt_tpu_torch.probes import int8_probe as ip

    rng = np.random.default_rng(0)  # the probe's draws, in its order
    for shape, m, k, n in ip.SHAPES:
        a8, b8, abf, bbf = ip.make_inputs(m, k, n, rng, "cuda")
        for label, a, b, peak in (("bf16", abf, bbf, ip.BF16_PEAK),
                                  ("int8", a8, b8, ip.INT8_PEAK)):
            a2 = ip.stack2(a)
            want = mma_probe_plain(a2, b, 5)
            for (kernel, name), fn in fns.items():
                if kernel != "F":
                    continue
                out = torch.empty((m, n), dtype=want.dtype, device="cuda")

                def call(reps):
                    build.check(fn(a2.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), m, k, n, reps,
                                   int(label == "bf16"),
                                   build.stream_handle(a2.device)), name)

                call(5)
                torch.cuda.synchronize()
                ok = (torch.equal(out, want) if label == "int8" else
                      (out - want).abs().max().item()
                      <= fp32_sum_bound(a, b))
                if not ok:
                    raise AssertionError(f"F {name} {shape} {label}: "
                                         "differs from the plain twin")
                ms = ip.time_call(lambda: call(ip.R))
                share = 2.0 * m * k * n * ip.R / (ms * 1e-3) / peak
                print(f"F {name} {shape} {label} R {ip.R}: {ms:.4f} ms "
                      f"({100 * share:.1f}% of the dense peak); agrees",
                      flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("D", "F"), action="append")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 1
    from waifu2x_tensorrt_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    kernels = args.kernel or ["D", "F"]
    fns = _build(build, kernels, _variants(build.CSRC))
    if "D" in kernels:
        _time_d(torch, cs, build, fns)
    if "F" in kernels:
        _time_f(torch, build, fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
