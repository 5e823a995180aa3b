"""Times of kernels A to E through their wrappers on one NVIDIA GPU, by
``chip_smoke.py``'s method, from this or another version of the package.

    python3 tools/kernel_times.py [--root DIR]

Takes the timing method, the inputs and the bounds from ``chip_smoke.py``
(``_median_ms``: per call, the median of 10 samples of 10 calls in a row
under CUDA events) and prints one line per kernel at ``chip_smoke.py``'s
shapes, each beside its bound and its share of it:

- A in bf16 and fp32 at (BW 4096, C 96) and (1024, 192), shift 4, beside
  ``F.scaled_dot_product_attention`` with the bias and the shift mask as
  one bf16 float mask (a yardstick the port never calls);
- E in bf16 and fp32 at (BW 4096, nh 3) on the same values, beside SDPA;
- B in bf16 on prepared operands at both shapes;
- C on the 720p -> 4x plan; D in bf16 at r 4, (16, 256, 256, 48).

It goes through the wrappers only, so ``--root DIR`` can import
``waifu2x_tensorrt_tpu_torch`` from an unpacked other version (``git
archive``) while the method stays this checkout's: run parent, change,
change, parent in one call to compare two versions. Needs a CUDA device
and nvcc; exits 1 without a device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's method, inputs and bounds

    sys.path.insert(0, str(args.root.resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import waifu2x_tensorrt_tpu_torch as pkg
    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; package from {Path(pkg.__file__).parents[1]}",
          flush=True)

    def show(label, fn, work, yardstick=None):
        ms = cs._median_ms(fn)
        bms, by = cs._bound(*work)
        line = (f"{label}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
                f"{100 * bms / ms:.1f}% of it)")
        if yardstick is not None:
            lm = cs._median_ms(yardstick)
            line += f"; SDPA {lm:.4f} ms, kernel / SDPA {ms / lm:.2f}x"
        print(line, flush=True)

    for bw, c, nh in ((4096, 96, 3), (1024, 192, 6)):
        x, qkv, params, bias, flags = cs._block_inputs(
            torch, bw, c, nh, torch.float32, seed=c + bw)
        mask = cs._sdpa_mask(torch, bias, flags, 4, torch.bfloat16)
        qkv16 = qkv.bfloat16()
        q, k, v = qkv16.view(bw, 64, 3, nh, 32).permute(2, 0, 3, 1, 4)
        for dtype, inp in (("bf16", qkv16), ("fp32", qkv)):
            show(f"kernel A {dtype} BW {bw} C {c}",
                 lambda: wa.fused_window_attention_qkv(
                     inp, bias, flags, num_heads=nh, shift=4),
                 cs._attention_work(bw, nh, inp.element_size()),
                 (lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask)) if dtype == "bf16" else None)
        if bw == 4096:  # E on the same values, in its unpacked layout
            heads = [t.reshape(bw, 64, nh, 32).transpose(1, 2).contiguous()
                     for t in qkv.chunk(3, dim=-1)]
            for dtype, hs in (("bf16", [t.bfloat16() for t in heads]),
                              ("fp32", heads)):
                show(f"kernel E {dtype} BW {bw} nh {nh}",
                     lambda: wa.fused_window_attention(
                         *hs, bias, flags, shift=4),
                     cs._attention_work(bw, nh, hs[0].element_size()),
                     (lambda: F.scaled_dot_product_attention(
                         *hs, attn_mask=mask)) if dtype == "bf16" else None)
        ops16 = sb.block_operands(params, bias, torch.bfloat16)
        x16 = x.bfloat16()
        show(f"kernel B bf16 BW {bw} C {c} (prepared operands)",
             lambda: sb.swin_block_prepared(x16, ops16, flags, shift=4),
             cs._block_work(bw, c, nh, 2))

    fin, plan, outs = cs._finalize_case(torch)
    show(f"kernel C 720p -> 4x (T {plan.tile_count})", lambda: fin(*outs),
         cs._finalize_work(outs, 2880 * 5120 * 3))
    z = (torch.rand((16, 256, 256, 48), device="cuda") * 1.6
         - 0.3).bfloat16()
    show("kernel D bf16 r 4 (16, 256, 256, 48)",
         lambda: hp.pack_head_x16(z, r=4), cs._head_pack_work(z))
    return 0


if __name__ == "__main__":
    sys.exit(main())
