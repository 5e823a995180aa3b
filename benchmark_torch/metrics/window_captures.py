"""CUDA-graph captures inside the traced window: the program's
``w2x.capture`` host spans (``engine/exe_cache.py``). Every shape the
window meets is warmed, so this reads 0. Nothing where the window holds
no ``w2x.`` host span at all (a program without spans)."""


def read(ctx):
    if not any(name.startswith("w2x.") for name in ctx.host_counts):
        return None
    return ctx.host_counts["w2x.capture"]
