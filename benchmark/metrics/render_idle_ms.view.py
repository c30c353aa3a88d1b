"""Device idle milliseconds a frame while the host is inside a ray block's
render (``tgtc.render.coarse``, ``.resample`` or ``.fine``): the share of
the window's idle gaps under those spans, times the idle time a frame that
``device_idle_share.view`` counts. The rest of a frame's idle falls in the
copy to the host (``bench.copy``) or between blocks."""

from benchmark.harness import spans

SPANS = ("tgtc.render.coarse", "tgtc.render.resample", "tgtc.render.fine")


def read(ctx):
    return spans.idle_ms(ctx, SPANS)
