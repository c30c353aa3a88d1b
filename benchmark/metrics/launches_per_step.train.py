"""Device operations a training step in the traced window: every kernel,
copy and memset the profiler recorded, over the units (each operation's
count rounded up to a whole number a unit where the window was not whole).
The launches a step are C1's first lever (a CUDA graph, fused dropout and
casts); None where the profiler recorded no device operation."""


def read(ctx):
    tr = ctx.trace
    if not tr.device:
        return None
    return sum(tr.scale[e.name] for e in tr.device) / tr.units
