"""Device milliseconds per output megapixel of kernel K (MambaIR's
selective scan, ``selective_scan`` in the device event's name: its scan
and combine kernels) in the traced window. Nothing where the trace holds
no kernel-K launch."""


def read(ctx):
    t = sum(b - a for name, a, b in ctx.device_events
            if "selective_scan" in name) / 1e6
    return t * 1e3 / ctx.out_mp if t and ctx.out_mp else None
