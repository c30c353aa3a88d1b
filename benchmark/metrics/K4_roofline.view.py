"""K4's share of its roofline in the stylized view: the stylized fine pass
(trunk, concat MLP, style MLP), 128 points a ray of the frame, over K4's
device time a frame."""

PATTERNS = ("style_fwd_kernel",)


def read(ctx):
    return ctx.roofline("K4", PATTERNS)
