"""The share of a training step in which the device runs nothing: 1 - the
busy union of the device's operations a step (profiled) over the
unprofiled time a step of the same process."""


def read(ctx):
    return ctx.idle_share()
