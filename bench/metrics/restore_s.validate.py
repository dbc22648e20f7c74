"""Seconds a verdict spends outside the engine: the restore from disk, the
upload's host side and the ledger append.  The harness's clock around
``ValidatorWorker.run_step`` less the row's ``timings.total_s``, the
mean over the window's verdicts."""


def read(ctx):
    vs = ctx.get("verdicts") if ctx.get("kind") == "validate" else None
    if not vs:
        return None
    return sum(v["wall_s"] - v["timings"]["total_s"] for v in vs) / len(vs)
