"""K1's share of its roofline in Phase A's step: the two passes' forward
(2048 × 64 and 2048 × 128 points a step) over K1's device time a step."""

PATTERNS = ("nerf_fwd_kernel",)


def read(ctx):
    return ctx.roofline("K1", PATTERNS)
