"""Kernel G's share of its roofline: the summed bound of every launch in
the traced window (``counts/kernels.bound_s`` of ``counts/hat.kernel_g``
at each launch's windows and geometry, from the benchmark's own plan of
the window's chunks, ``counts/hat.attention_launches``) over kernel G's
summed device time. Nothing where the configuration has no kernel-G
plan, or when the trace's launch count differs from the plan's (the run
says which)."""

from benchmark_torch.counts import kernels


def read(ctx):
    peaks = ctx.card["peaks"]
    plan = getattr(ctx.counts, "attention_launches", None)
    times = [b - a for name, a, b in ctx.device_events
             if "hat_attention" in name]
    if not peaks or not times or plan is None:
        return None
    c = ctx.config
    launches = [la for n in ctx.chunk_sizes
                for la in plan(c, n, c["tile"], c["tile"])]
    if len(times) != len(launches):
        ctx.note(f"kernel_g_roofline: the trace holds {len(times)} "
                 f"kernel G launches, the plan {len(launches)}")
        return None
    bound = sum(kernels.bound_s(*ctx.counts.kernel_g(w, kind, c), peaks)
                for w, kind in launches)
    return 100 * bound / (sum(times) / 1e6)
