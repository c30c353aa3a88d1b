"""The whole training step's share of the card's bf16 peak: the model's FLOP
a step (the forward of every pass, a backward of twice the forward of what
is trained, no recompute; Phase E: the frozen trunks' forward too) over the
unprofiled time a step of the same process."""


def read(ctx):
    return ctx.mfu()
