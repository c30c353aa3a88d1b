"""K2's share of its roofline in the exact view: the σ-only coarse pass, 64
points a ray of the frame, over its device time a frame. K2 and K5 share the
engine's device symbol ``sigma_kernel``; in this cell only K2 runs it."""

PATTERNS = ("sm90::sigma_kernel",)


def read(ctx):
    return ctx.roofline("K2", PATTERNS)
