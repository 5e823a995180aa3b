"""Kernel J's share of its roofline: the summed bound of every call in the
traced window (``counts/kernels.bound_s`` of ``counts/<arch>.kernel_j``
at each call's tokens, from the benchmark's own plan of the window's
chunks, ``channel_launches``) over kernel J's summed device time (every
device event with ``channel_attention`` in its name: a call's three
kernels). Nothing where the configuration has no kernel-J plan, or when
the trace's count of calls (its ``channel_attention_apply`` kernels)
differs from the plan's (the run says which)."""

from benchmark_torch.counts import kernels


def read(ctx):
    peaks = ctx.card["peaks"]
    plan = getattr(ctx.counts, "channel_launches", None)
    names = [(name, b - a) for name, a, b in ctx.device_events
             if "channel_attention" in name]
    if not peaks or not names or plan is None:
        return None
    c = ctx.config
    launches = [t for n in ctx.chunk_sizes
                for t in plan(c, n, c["tile"], c["tile"])]
    calls = sum("channel_attention_apply" in name for name, _ in names)
    if calls != len(launches):
        ctx.note(f"kernel_j_roofline: the trace holds {calls} kernel J "
                 f"calls, the plan {len(launches)}")
        return None
    bound = sum(kernels.bound_s(*ctx.counts.kernel_j(t, c), peaks)
                for t in launches)
    return 100 * bound / (sum(t for _, t in names) / 1e6)
