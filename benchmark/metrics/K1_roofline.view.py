"""K1's share of its roofline in the exact view: the fine pass, 128 points a
ray of the frame, over K1's device time a frame."""

PATTERNS = ("nerf_fwd_kernel",)


def read(ctx):
    return ctx.roofline("K1", PATTERNS)
