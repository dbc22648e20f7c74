"""``ServingIndex.topk`` on the live index at one micro-batch (Q = 8,
k = 10), timed with CUDA events after the window: the least time the
search could take (the larger of 2 Q N D at the f32 rate and its bytes at
the HBM rate) over the time measured, in percent."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("topk_s"):
        return None
    return 100.0 * ctx["topk_bound_s"] / ctx["topk_s"]
