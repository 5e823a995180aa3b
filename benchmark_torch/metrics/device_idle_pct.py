"""The traced window's wall time (its ``bench.window`` span) less the
union of the device's intervals in it, over the wall time."""


def read(ctx):
    if not ctx.busy_s:
        return None
    return 100 * (ctx.trace_window_s - ctx.busy_s) / ctx.trace_window_s
