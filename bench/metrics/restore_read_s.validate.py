"""Seconds a verdict spends reading its checkpoint from disk: the
program's ``restored`` span around ``ckpt.restore`` in
``ValidatorWorker.load_params`` (``np.load`` of every leaf), the mean over
the window's verdicts."""

from bench import spans


def read(ctx):
    return spans.verdict_mean(ctx, "restored",
                              lambda ss: sum(s["dur"] for s in ss))
