"""Seconds of a verdict's encode-and-fold loop (the program's
``encoded`` span with ``role="corpus"``, the interval of
``encode_corpus_s``) that no ``chunk`` span's device interval covers:
the device waiting between chunks on the staging and the host's loop,
the mean over the window's verdicts."""

from bench import spans


def _idle(verdict):
    loops = [s for s in verdict
             if s.get("name") == "encoded" and s.get("role") == "corpus"]
    chunks = [(s["dev_t0"], s["dev_t0"] + s["dev_s"]) for s in verdict
              if s.get("name") == "chunk" and "dev_t0" in s]
    if not loops or not chunks:
        return None
    lo, dur = loops[0]["t0"], loops[0]["dur"]
    return dur - spans.union_s(chunks, lo, lo + dur)


def read(ctx):
    vs = spans.window_verdicts(ctx)
    if vs is None:
        return None
    idle = [_idle(v) for v in vs]
    if any(x is None for x in idle):
        return None
    return sum(idle) / len(idle)
