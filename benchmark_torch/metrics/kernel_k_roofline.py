"""Kernel K's share of its roofline: the summed bound of every call in the
traced window (``counts/<arch>.bound_s`` at each call's tokens, from the
benchmark's own plan of the window's chunks, ``scan_launches``) over
kernel K's summed device time (every device event with
``selective_scan`` in its name: a call's scan and combine kernels).
Nothing where the configuration has no kernel-K plan, or when the
trace's count of calls (its ``selective_scan_combine`` kernels) differs
from the plan's (the run says which)."""


def read(ctx):
    peaks = ctx.card["peaks"]
    plan = getattr(ctx.counts, "scan_launches", None)
    events = [(name, b - a) for name, a, b in ctx.device_events
              if "selective_scan" in name]
    if not peaks or not events or plan is None:
        return None
    c = ctx.config
    launches = [t for n in ctx.chunk_sizes
                for t in plan(c, n, c["tile"], c["tile"])]
    calls = sum("selective_scan_combine" in name for name, _ in events)
    if calls != len(launches):
        ctx.note(f"kernel_k_roofline: the trace holds {calls} kernel K "
                 f"calls, the plan {len(launches)}")
        return None
    bound = sum(ctx.counts.bound_s(t, c, peaks) for t in launches)
    return 100 * bound / (sum(t for _, t in events) / 1e6)
