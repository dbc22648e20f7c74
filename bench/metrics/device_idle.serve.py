"""Share of a steady stretch in the middle of the window (three seconds,
or the middle half of a shorter window) in which no kernel, copy or set
ran on the device, from the profiler's trace, in percent."""


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "serve" else None
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
