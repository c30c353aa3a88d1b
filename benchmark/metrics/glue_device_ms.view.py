"""Device milliseconds a frame outside the hand-written kernels (K1, K2, K4,
K5): the sorts, ``sample_pdf``, compositing, gathers, casts and other
elementwise work; the frame's copy to the host is left out."""

KERNELS = ("nerf_fwd_kernel", "style_fwd_kernel", "sigma_kernel")
COPY = "Memcpy DtoH"


def read(ctx):
    s = ctx.trace.seconds(lambda n: not any(k in n for k in KERNELS) and COPY not in n)
    return 1e3 * s / ctx.trace.units
