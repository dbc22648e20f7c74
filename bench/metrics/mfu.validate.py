"""The whole verdict's share of the chip's bf16 peak: the benchmark's
count of model FLOPs (the trunk over the real tokens of the subset and
the queries, and 2 Q N D of scoring) over ``verdict_s`` at 989 TFLOP/s."""

from bench import roofline


def read(ctx):
    if ctx.get("kind") != "validate" or not ctx.get("verdict_s"):
        return None
    return 100.0 * ctx["flops_per_verdict"] / (
        ctx["verdict_s"] * roofline.PEAK_BF16_FLOPS)
