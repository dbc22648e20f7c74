"""Device seconds of the trunk in a verdict's encode-and-fold loop: the
sum of the program's ``chunk`` spans' ``trunk_s`` (CUDA events around
``encode_fn``), the mean over the window's verdicts."""

from bench import spans


def read(ctx):
    return spans.verdict_mean(
        ctx, "chunk", lambda ss: sum(s.get("trunk_s", 0.0) for s in ss))
