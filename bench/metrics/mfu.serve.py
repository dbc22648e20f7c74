"""The serving step's share of the chip's bf16 peak: model FLOPs of the
window's answered queries (the query trunk over their real tokens, and
2 N D of search each) over the window, from the first due query to the
last answer, at 989 TFLOP/s."""

from bench import roofline


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"]
                                   * roofline.PEAK_BF16_FLOPS)
