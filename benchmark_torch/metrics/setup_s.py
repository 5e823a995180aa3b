"""Process start to the first timed frame: imports, the CUDA context, the
kernel library (nvcc on a checkout's first run), seeded weights and
inputs, the program's load, and the warm-up and capture of every shape
the window meets (host clock)."""


def read(ctx):
    return ctx.setup_s
