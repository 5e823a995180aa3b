"""The comparison that decides ``correct``.

The outputs that the timed path delivered to the host, a sample drawn
from the seed (``Sample``: ``sample`` outputs of each size), are held
against the plain reference (``reference/render.py``, float32, TF32 off)
of the same input and weights, computed after the window once the
program's state is freed. The numbers compared, each against its limit
in ``limits/<workload>.json``:

- ``mean_abs_lsb``: the mean absolute difference of the output bytes;
- ``max_abs_lsb``: the largest absolute difference of an output byte;
- ``missing``: outputs sent for and not delivered with the right shape
  (limit 0).

The run is correct when every number is at or under its limit and the
sample holds an output of every size sent.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark_torch.reference.render import render


def readings(pairs, traffic, params, config, device, quant=None) -> dict:
    """mean and max absolute byte difference of the kept outputs from the
    reference (``quant`` set: the reference in that precision, in the
    program's place, held against the float32 reference)."""
    total, count, worst = 0.0, 0, 0
    for item, out in pairs:
        frame = torch.from_numpy(traffic.pictures[item.key]).to(device)
        want = render(frame, params, config)
        if quant is not None:
            got = render(frame, params, config, quant=quant)
        else:
            got = torch.from_numpy(np.ascontiguousarray(np.asarray(out)))
            got = got.to(device)
        if got.shape != want.shape:  # the most a byte can differ by
            return {"mean_abs_lsb": 255.0, "max_abs_lsb": 255.0}
        d = (got.to(torch.int32) - want.to(torch.int32)).abs()
        total += float(d.sum(dtype=torch.float64))
        count += d.numel()
        worst = max(worst, int(d.max()))
    return {"mean_abs_lsb": total / max(count, 1),
            "max_abs_lsb": float(worst)}


def compare(run, ctx, traffic, sample, params, device, control=None):
    """(checks for the result line, correct); prints each number beside
    its limit as the last lines on standard error. ``control`` set: the
    reference in that precision stands in the program's place."""
    got = readings(sample.items(), traffic, params, run.config, device,
                   quant=control)
    got["missing"] = float(ctx.attempted - len(ctx.items))
    limits = dict(run.limits or {})
    limits["missing"] = 0.0
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in got.items()}
    covered = set(sample.kept) == {it.key[0] for it in ctx.items} != set()
    correct = covered and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    if not covered:
        ctx.note("check: the sample misses a size that was sent")
    if run.limits is None:
        ctx.note(f"check: no limits/{run.name}.json")
    for k, c in checks.items():
        ctx.note(f"check {k}: {c['value']} (limit {c['limit']})")
    return checks, correct
