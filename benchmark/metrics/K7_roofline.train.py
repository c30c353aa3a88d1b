"""K7's share of its roofline in the C1 step: the least time of the step's 36
dQ launches over K7's device time a step (floors as K6_roofline.train's)."""

from benchmark.harness import attention_work as AW

PATTERNS = ("(anonymous namespace)::flash_bwd_dq_kernel<",)


def read(ctx):
    return AW.roofline(ctx, "K7", PATTERNS)
