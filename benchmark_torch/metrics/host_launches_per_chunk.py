"""Kernel launches from the host (``cudaLaunchKernel`` and its variants
in the profiler's host events) per model chunk of the traced window; a
replayed CUDA graph launches its kernels itself and counts as none."""


def read(ctx):
    n = sum(c for name, c in ctx.host_counts.items()
            if "LaunchKernel" in name)
    return n / len(ctx.chunk_sizes) if ctx.chunk_sizes else None
