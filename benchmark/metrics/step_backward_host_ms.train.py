"""Host milliseconds a step in its backward (``tgtc.step.backward``:
``torch.autograd.grad``, the wait on autograd's device thread included): the
span's share of ``bench.step``'s host time in the traced window, times
``step_host_ms.train``."""

from benchmark.harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("tgtc.step.backward",))
