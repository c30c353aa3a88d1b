"""Host milliseconds a step in its forward (``tgtc.step.forward``: the
batch's gathers, both passes, K1 under autograd in Phase A or the stylized
passes in Phase E, and the loss): the span's share of ``bench.step``'s host
time in the traced window, times ``step_host_ms.train``."""

from benchmark.harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("tgtc.step.forward",))
