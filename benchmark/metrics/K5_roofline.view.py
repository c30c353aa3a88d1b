"""K5's share of its roofline in the stylized view: the σ-only coarse pass, 64
points a ray of the frame, over its device time a frame. K5 and K2 share the
engine's device symbol ``sigma_kernel``; in this cell only K5 runs it."""

PATTERNS = ("sm90::sigma_kernel",)


def read(ctx):
    return ctx.roofline("K5", PATTERNS)
