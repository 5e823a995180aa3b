"""Kernel C's share of its roofline: the summed bound of every launch in
the traced window (one a frame or still, ``counts/kernels.kernel_c`` on
its tile plan; bound by bytes) over kernel C's summed device time.
Nothing when the trace's launch count differs from the items done."""

from benchmark_torch.counts import kernels


def read(ctx):
    peaks = ctx.card["peaks"]
    times = [b - a for name, a, b in ctx.device_events
             if "finalize_gather" in name]
    if not peaks or not times:
        return None
    if len(times) != len(ctx.plans):
        ctx.note(f"kernel_c_roofline: the trace holds {len(times)} "
                 f"kernel C launches, the window {len(ctx.plans)} items")
        return None
    bound = sum(kernels.bound_s(*kernels.kernel_c(p), peaks)
                for p in ctx.plans)
    return 100 * bound / (sum(times) / 1e6)
