"""The library convolutions' and GEMMs' share of the bf16 peak: the
FLOPs of the convolutions and dense layers in the traced window (the
counts' ``library_flops_per_tile``: the model's FLOPs without the
attention products, which a hand-written kernel computes) over the
device time of the convolution and GEMM kernels times the peak. Nothing
where the configuration's counts have no such split."""


def read(ctx):
    peaks = ctx.card["peaks"]
    per_tile = getattr(ctx.counts, "library_flops_per_tile", None)
    t = ctx.groups.get("convs_gemms", 0.0)
    if not peaks or not t or per_tile is None:
        return None
    c = ctx.config
    flops = sum(p.count for p in ctx.plans) * per_tile(c, c["tile"],
                                                         c["tile"])
    return 100 * flops / (t * peaks["bf16_flops"])
