"""Output megapixels whose u8 bytes reached host memory inside the
window, over the window's seconds (host clock, ending in a synchronize)."""


def read(ctx):
    return ctx.out_mp / ctx.window_s if ctx.items else None
