"""K3's share of its roofline in Phase A's step: the backward's own work
(weight gradients, and input gradients where the input is trained; no
recompute, no workspace bytes) over the device time of K3's kernels a step
(the tile kernel, the weight gradient, its reduction and the weights'
transpose; its memset is not told apart from the step's others)."""

PATTERNS = ("nerf_bwd_tile_kernel", "nerf_bwd_wgrad_kernel", "nerf_bwd_reduce_kernel",
            "(anonymous namespace)::transpose_kernel")


def read(ctx):
    return ctx.roofline("K3", PATTERNS)
