"""How long the window's answered queries waited in the service's queue,
from their submit to their micro-batch's dispatch: the nearest-rank 95th
percentile of the program's ``queued`` spans, in ms."""

from bench import spans


def read(ctx):
    reqs = spans.window_requests(ctx)
    if reqs is None:
        return None
    return 1e3 * spans.nearest_rank([s["dur"] for s in reqs], 95)
