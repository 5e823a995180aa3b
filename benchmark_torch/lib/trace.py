"""The traced window: the profiler session and its reduction.

A traced run profiles a fixed number of frames or stills after warm-up
(the traffic's ``trace_items``), with CPU and CUDA activities, and the
benchmark's own spans (``bench.*``, ``torch.profiler.record_function``
around its calls into the program). The reduction gives the metrics'
context: device events in the window, the device's busy time (the union
of the device intervals), device time by group, host event counts, and
the breakdown (device operations with most time, idle gaps by what the
host was doing).

``describe_work`` gives the benchmark's own account of the work the
window did, from its tile plans and counts: tiles, model chunks (as the
traffic kind's ``chunk_sizes`` makes them), output megapixels and FLOPs.
"""

from __future__ import annotations

import collections

import numpy as np

from benchmark_torch.reference import tiling
from benchmark_torch.reference.render import model_module

# (group, substrings of the device event name), first match wins
GROUPS = (
    ("kernel_b", ("swin_block",)),
    ("kernel_c", ("finalize_gather",)),
    ("roll", ("roll_cuda",)),
    ("flips", ("flip",)),
    ("htod", ("HtoD",)),
    ("dtoh", ("DtoH",)),
    ("copies", ("copy", "Copy", "DtoD", "Memcpy", "Memset")),
    ("convs_gemms", ("conv", "xmma", "cutlass", "cudnn", "gemm", "sm90_",
                     "nchw", "nhwc")),
)
GLUE = ("roll", "flips", "copies", "other")


def group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def start(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def describe_work(ctx) -> None:
    c = ctx.config
    offset = model_module(c).offset(c)
    plans = {}
    tiles, out_px = [], 0
    for item in ctx.items:
        if item.hw not in plans:
            plans[item.hw] = tiling.plan(item.hw, c["tile"], c["scale"],
                                         offset, c["overlap"])
        tiles.append(plans[item.hw].count)
        out_px += item.hw[0] * item.hw[1] * c["scale"] ** 2
    ctx.plans = [plans[item.hw] for item in ctx.items]
    ctx.chunk_sizes = ctx.kind.chunk_sizes(tiles, c["batch"])
    ctx.out_mp = out_px / 1e6
    ctx.flops = sum(tiles) * ctx.counts.flops_per_tile(c, c["tile"],
                                                       c["tile"])


def _busy_us(intervals) -> tuple:
    """(busy us, merged intervals) of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce(prof, ctx) -> None:
    from torch.autograd import DeviceType

    events = prof.events()
    spans = [e for e in events if e.name == "bench.window"]
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b < w0 or a > w1:
            continue
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors the benchmark's spans onto the device's
            # timeline: they are no device work
            if not e.name.startswith("bench."):
                dev.append((e.name, max(a, w0), min(b, w1)))
        else:
            host.append((e.name, a, b))
    busy_us, merged = _busy_us([(a, b) for _, a, b in dev])
    ctx.busy_s = busy_us / 1e6
    ctx.trace_window_s = (w1 - w0) / 1e6
    ctx.device_events = dev
    by_name = collections.defaultdict(float)
    groups = collections.defaultdict(float)
    for name, a, b in dev:
        by_name[name] += (b - a) / 1e6
        groups[group(name)] += (b - a) / 1e6
    ctx.groups = dict(groups)
    ctx.note("device seconds by group: " + "; ".join(
        f"{g} {t}" for g, t in sorted(groups.items(), key=lambda kv: -kv[1]))
        + f"; busy {ctx.busy_s} of {ctx.trace_window_s}")
    ctx.host_counts = collections.Counter(name for name, _, _ in host)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ctx.breakdown = {"device_ops": [[n[:160], s] for n, s in top],
                     "idle_gaps": _idle_gaps(merged, host, w0, w1)}


def _idle_gaps(merged, host, w0, w1) -> list:
    """Idle seconds of the window summed by what the host was doing in
    each gap: the innermost benchmark span and the innermost other host
    event (latest start) at the gap's middle."""
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    if not gaps:
        return []
    starts = np.array([a for _, a, _ in host], dtype=np.float64)
    ends = np.array([b for _, _, b in host], dtype=np.float64)
    names = [n for n, _, _ in host]
    ours = np.array([n.startswith("bench.") and n != "bench.window"
                     for n in names], dtype=bool)
    idle = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        inside = (starts <= mid) & (ends >= mid)
        label = []
        for pick in (inside & ours, inside & ~ours):
            idx = np.nonzero(pick)[0]
            if len(idx):
                label.append(names[idx[np.argmax(starts[idx])]])
        idle[" / ".join(label) or "no host event"] += (b - a) / 1e6
    return [[n[:160], s] for n, s in
            sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
