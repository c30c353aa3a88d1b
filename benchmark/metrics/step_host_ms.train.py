"""Host milliseconds of one step call started on an idle device (a sync
before each call, none inside), the median of the traced run's sub-window:
the host's cost of a step, which a full launch queue hides from the
window's rate."""

import statistics


def read(ctx):
    return statistics.median(ctx.host_ms) if ctx.host_ms else None
