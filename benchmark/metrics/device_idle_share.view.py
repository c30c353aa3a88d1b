"""The share of a frame in which the device runs nothing: 1 - the busy union
of the device's operations a frame (profiled) over the unprofiled time a
frame of the same process."""


def read(ctx):
    return ctx.idle_share()
