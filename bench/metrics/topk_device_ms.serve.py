"""Device time of a served batch's search: the program's ``topk`` span's
device interval (CUDA events at the entry of ``ServingIndex.topk`` and
after its last launch), the mean over the window's batches, in ms."""

from bench import spans


def read(ctx):
    topk = spans.window_topk(ctx)
    if topk is None:
        return None
    return 1e3 * sum(s["dev_s"] for s in topk) / len(topk)
