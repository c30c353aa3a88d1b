"""Host milliseconds a step in its update (``tgtc.step.optimizer``: Adam,
the schedule, Phase E's coherence buffers and counters): the span's share of
``bench.step``'s host time in the traced window, times
``step_host_ms.train``."""

from benchmark.harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("tgtc.step.optimizer",))
