"""Device seconds of the fold in a verdict's encode-and-fold loop: the
sum of the program's ``chunk`` spans' ``fold_s`` (CUDA events around
``topk_mips_chunk``), the mean over the window's verdicts."""

from bench import spans


def read(ctx):
    return spans.verdict_mean(
        ctx, "chunk", lambda ss: sum(s.get("fold_s", 0.0) for s in ss))
