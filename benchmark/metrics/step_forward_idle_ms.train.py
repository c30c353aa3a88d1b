"""Device idle milliseconds a step while the host is in the step's forward
(``tgtc.step.forward``): the share of the window's idle gaps under the span,
times the idle time a step that ``device_idle_share.train`` counts."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, ("tgtc.step.forward",))
