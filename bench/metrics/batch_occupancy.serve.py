"""How full the micro-batches were: the service's own
``serve.batch_occupancy`` histogram (queries in a batch over
``max_batch``), the mean over the window's batches, in percent."""


def read(ctx):
    if ctx.get("kind") != "serve" or ctx.get("occupancy") is None:
        return None
    return 100.0 * ctx["occupancy"]
