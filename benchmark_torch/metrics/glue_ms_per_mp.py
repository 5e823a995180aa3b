"""Device milliseconds per output megapixel in the torch ops around the
port's kernels and the library's convolutions and GEMMs: the roll, the
flips, copies (layout, dtype, device-to-device) and other elementwise
kernels, as ``lib/trace.py`` groups the device events."""

from benchmark_torch.lib.trace import GLUE


def read(ctx):
    ms = sum(ctx.groups.get(g, 0.0) for g in GLUE) * 1e3
    return ms / ctx.out_mp if ctx.out_mp and ctx.busy_s else None
