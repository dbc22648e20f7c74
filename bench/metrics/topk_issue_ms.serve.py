"""Host time a served batch takes to issue its search: the program's
``topk`` span's ``issue_s``, from entering ``ServingIndex.topk`` to the
return of its last topk_mips launch, the mean over the window's batches,
in ms."""

from bench import spans


def read(ctx):
    topk = spans.window_topk(ctx)
    if topk is None:
        return None
    return 1e3 * sum(s["issue_s"] for s in topk) / len(topk)
