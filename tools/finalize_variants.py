"""Kernel C's per-type choices, measured on one NVIDIA GPU.

    python3 tools/finalize_variants.py

Builds variants of ``waifu2x_tensorrt_tpu_torch/ops/csrc/finalize_epilogue.cu``
(text substitutions of this checkout's source, one ``nvcc`` each, all
started together, into ``build/kernels/variants/``) and times each on
``chip_smoke.py``'s 720p -> 4x case, with bf16 tiles and with fp32 copies
of them, by ``chip_smoke.py``'s method with the device's queue filled
ahead (device time only), beside the bound. Every variant must give the
plain scan's bytes. The variants:

- as built;
- the u8 conversion as ``rintf`` / ``fmaxf`` / ``fminf`` (the same bytes)
  instead of one ``cvt.rni.u8.f32``;
- bf16 with fp32's traits (no minimum of resident CTAs, plain loads and
  stores), and with 5 CTAs an SM but plain loads and stores;
- bf16 with 6 CTAs an SM (fewer registers);
- both of the first two changes: the kernel before its per-type tuning;
- fp32 with bf16's traits (5 CTAs an SM, evict-first loads and stores).

Needs a CUDA device and nvcc; exits 1 without a device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

QUANT_CVT = ('  unsigned short q;\n  asm("cvt.rni.u8.f32 %0, %1;" : "=h"(q) : '
             '"f"(__fmul_rn(acc, 255.f)));\n  return q;\n')
QUANT_RINT = ("  return (unsigned)fminf(fmaxf(rintf(__fmul_rn(acc, 255.f)), "
              "0.f), 255.f);\n")
BF16_MIN = "  static constexpr int kMinBlocks = 5;"
BF16_STORE = "    __stcs(p, v);"
BF16_LOAD = "const uint4 a = __ldcs(q), b = __ldcs(q + 1);"
FP32_MIN = "  static constexpr int kMinBlocks = 1;"
FP32_STORE = "void store(uint4* p, uint4 v) { *p = v; }"
FP32_LOAD = "const float4 f = __ldg(q + k);"
BF16_PLAIN = [(BF16_STORE, "    *p = v;"),
              (BF16_LOAD, "const uint4 a = __ldg(q), b = __ldg(q + 1);")]
VARIANTS = {  # name: substitutions
    "as built": [],
    "u8 by rintf/fmaxf/fminf": [(QUANT_CVT, QUANT_RINT)],
    "bf16 with fp32's traits": [(BF16_MIN, FP32_MIN)] + BF16_PLAIN,
    "bf16 5 CTAs, plain loads/stores": BF16_PLAIN,
    "bf16 6 CTAs an SM": [(BF16_MIN, "  static constexpr int kMinBlocks = 6;")],
    "rintf/fmaxf/fminf and no traits": [(QUANT_CVT, QUANT_RINT),
                                        (BF16_MIN, FP32_MIN)] + BF16_PLAIN,
    "fp32 with bf16's traits": [
        (FP32_MIN, BF16_MIN),
        (FP32_STORE, "void store(uint4* p, uint4 v) { __stcs(p, v); }"),
        (FP32_LOAD, "const float4 f = __ldcs(q + k);")],
}


def _variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("finalize_variants: no CUDA device available", file=sys.stderr)
        return 1
    from waifu2x_tensorrt_tpu_torch.ops import build
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_scan,
        grid_geometry,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    src = (build.CSRC / "finalize_epilogue.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, subs) in enumerate(VARIANTS.items()):
        cu = out_dir / f"finalize_v{i}.cu"
        cu.write_text(_variant_source(src, subs))
        so = out_dir / f"libfinalize_v{i}.so"
        jobs.append((name, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-Xptxas", "-v", "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        regs = [line.split("info    : ")[-1] for line in log.splitlines()
                if "registers" in line]
        print(f"{name}: {'; '.join(regs)} (fp32, bf16)", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.w2x_finalize_gather.argtypes = build._SIGNATURES[
            "w2x_finalize_gather"]
        lib.w2x_finalize_gather.restype = ctypes.c_int
        libs[name] = lib

    _fin, plan, outs16 = cs._finalize_case(torch)
    want = finalize_scan(outs16, plan)
    oh, ow = plan.output_tile
    R, C, sy, sx = grid_geometry(plan)
    out_h, out_w = plan.output_size
    rw = torch.from_numpy(plan.row_weights).cuda()
    cw = torch.from_numpy(plan.col_weights).cuda()
    for outs in (outs16, [o.float() for o in outs16]):
        step = oh * ow * 3 * outs[0].element_size()
        table = torch.tensor(
            [o.data_ptr() + i * step for o in outs
             for i in range(o.shape[0])][:plan.tile_count],
            dtype=torch.int64, device="cuda")
        bf16 = outs[0].dtype == torch.bfloat16
        bms, by = cs._bound(*cs._finalize_work(plan,
                                               outs[0].element_size()))
        for name, lib in libs.items():
            out = torch.empty((out_h, out_w, 3), dtype=torch.uint8,
                              device="cuda")

            def call():
                build.check(lib.w2x_finalize_gather(
                    table.data_ptr(), rw.data_ptr(), cw.data_ptr(),
                    out.data_ptr(), out_h, out_w, R, C, sy, sx, oh, ow,
                    int(bf16), build.stream_handle(out.device)), name)

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: not the scan's bytes")
            ms = cs._median_ms(call, queued=True)
            print(f"{'bf16' if bf16 else 'fp32'} {name}: {ms:.4f} ms device "
                  f"time ({100 * bms / ms:.1f}% of the bound {bms:.4f} ms "
                  f"by {by}); byte-identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
