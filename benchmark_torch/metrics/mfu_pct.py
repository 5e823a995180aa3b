"""The whole step's share of the card's bf16 peak: the benchmark's own
FLOP count (``counts/<arch>.py``) of the tiles completed in the traced
window over the window's seconds times the peak (``counts/peaks.json``),
with the card's name and power limit printed beside it."""


def read(ctx):
    peaks = ctx.card["peaks"]
    if not peaks or not ctx.flops:
        return None
    pct = 100 * ctx.flops / (ctx.window_s * peaks["bf16_flops"])
    ctx.note(f"mfu_pct {pct} of {peaks['bf16_flops']} FLOP/s on "
             f"{ctx.card['kind']}, power limit {ctx.card['power_limit']}")
    return pct
