"""Device milliseconds per output megapixel of the traced window in the
``w2x.model`` spans: each chunk program's static-input copy, graph
replay and output clone (``engine/exe_cache.py``), timed by the
program's own events on the device's stream
(``utils/profiling.stage_seconds``). Nothing where the program has no
such spans."""

from waifu2x_tensorrt_tpu_torch.utils import profiling


def read(ctx):
    stages = getattr(profiling, "stage_seconds", dict)()
    t = stages.get("model")
    return t * 1e3 / ctx.out_mp if t and ctx.out_mp else None
