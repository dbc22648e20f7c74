"""Share of one whole traced verdict in which no kernel, copy or set ran
on the device: 100 * (1 - busy / wall), from the profiler's trace."""


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "validate" else None
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
