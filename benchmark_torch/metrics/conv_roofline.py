"""The library convolutions' share of the bf16 peak: the model's FLOPs in
the traced window (cunet's are all convolutions but its tiny
squeeze-and-excitation products) over the device time of the
convolution and GEMM kernels times the peak."""


def read(ctx):
    peaks = ctx.card["peaks"]
    t = ctx.groups.get("convs_gemms", 0.0)
    if not peaks or not t or not ctx.flops:
        return None
    return 100 * ctx.flops / (t * peaks["bf16_flops"])
