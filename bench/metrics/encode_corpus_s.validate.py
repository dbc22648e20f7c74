"""Seconds of the streaming engine's encode-and-fold loop over the subset
(the trunk on every chunk, and the fold through topk_mips): the ledger
row's ``timings.encode_corpus_s``, the mean over the window's verdicts."""


def read(ctx):
    vs = ctx.get("verdicts") if ctx.get("kind") == "validate" else None
    if not vs:
        return None
    return sum(v["timings"]["encode_corpus_s"] for v in vs) / len(vs)
