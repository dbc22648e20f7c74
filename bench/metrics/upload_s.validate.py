"""Seconds a verdict spends uploading the restored params to the device:
the program's ``uploaded`` span around ``to_torch_tree`` in
``StreamingEngine.run``, the mean over the window's verdicts."""

from bench import spans


def read(ctx):
    return spans.verdict_mean(ctx, "uploaded",
                              lambda ss: sum(s["dur"] for s in ss))
