"""K6's share of its roofline in the C1 step: the least time of the step's 36
forward launches (8 images x 8 heads x 1,024^2, D 64, dropout 0.1; the
largest of the tensor, HBM, SFU and INT32 floors of
``benchmark/harness/attention_work.py``, at C1 the hash's INT32) over K6's
device time a step."""

from benchmark.harness import attention_work as AW

PATTERNS = ("(anonymous namespace)::flash_fwd_kernel<",)


def read(ctx):
    return AW.roofline(ctx, "K6", PATTERNS)
