"""Device milliseconds per output megapixel of kernel G (HAT's window
attention, ``hat_attention`` in the device event's name) in the traced
window. Nothing where the trace holds no kernel-G launch."""


def read(ctx):
    t = sum(b - a for name, a, b in ctx.device_events
            if "hat_attention" in name) / 1e6
    return t * 1e3 / ctx.out_mp if t and ctx.out_mp else None
