"""Kernel B's share of its roofline: the summed bound of every launch in
the traced window (``counts/kernels.kernel_b`` at each launch's windows,
width and heads, from the benchmark's own plan of the window's chunks)
over kernel B's summed device time. Nothing when the trace's launch
count differs from the plan's (the run says which)."""

from benchmark_torch.counts import kernels


def read(ctx):
    peaks = ctx.card["peaks"]
    times = [b - a for name, a, b in ctx.device_events
             if "swin_block" in name]
    c = ctx.config
    launches = [la for n in ctx.chunk_sizes
                for la in ctx.counts.block_launches(c, n, c["tile"],
                                                    c["tile"])]
    if not peaks or not times:
        return None
    if len(times) != len(launches):
        ctx.note(f"kernel_b_roofline: the trace holds {len(times)} "
                 f"kernel B launches, the plan {len(launches)}")
        return None
    bound = sum(kernels.bound_s(*kernels.kernel_b(*la), peaks)
                for la in launches)
    return 100 * bound / (sum(times) / 1e6)
