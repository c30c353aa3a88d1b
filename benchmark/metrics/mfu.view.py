"""The whole frame's share of the card's bf16 peak: the model's FLOP a frame
(coarse σ pass and fine pass of every ray) over the unprofiled time a frame
of the same process."""


def read(ctx):
    return ctx.mfu()
