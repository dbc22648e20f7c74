"""Quickstart on PyTorch: the paper's closed-loop protocol end to end (§3).

The twin of ``examples/quickstart.py`` on the port (``repro_torch``):

  1. corpus + validation queries as pre-tokenized JSONL
     ({"text_id": str, "text": [int]}),
  2. a TREC qrel file,
  3. an encoder (here the toy dense retriever, ``repro_torch.models.toy``),

and the toolkit owns everything else: directory watching, corpus encoding,
retrieval, metrics, reporting.  ``impl="cuda"`` scores every corpus chunk
with the hand-written topk_mips kernel (one launch per chunk and
checkpoint); the default ``"torch"`` is plain PyTorch.

    python examples/quickstart_torch.py               # on the GPU
    python examples/quickstart_torch.py --device cpu

Fleet validation, the lazy hand-off and serving have twins of their own:
``examples/fleet_validation_torch.py``, ``examples/lazy_handoff_torch.py``
and ``examples/serve_live_torch.py``.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core.metrics import read_trec_qrels  # noqa: E402
from repro_torch.core.reporting import CSVLogger  # noqa: E402
from repro_torch.core.samplers import (RunFileTopK,  # noqa: E402
                                       write_subset_jsonl)
from repro_torch.core.suite import (ValidationConfig,  # noqa: E402
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import AsyncValidator  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.models.toy import toy_spec, train_toy_dr  # noqa: E402


def main(*, device: str = "cuda", impl: str = "torch",
         n_passages: int = 1200, n_queries: int = 60, steps: int = 60,
         snapshot_every: int = 20, chunk_size: int = 128,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="asyncval_quickstart_")
    os.makedirs(workdir, exist_ok=True)
    print(f"[quickstart] workdir: {workdir}")

    # -- 1. user-side data prep: pre-tokenized JSONL + TREC qrels ----------
    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=n_passages,
                                                n_queries=n_queries)
    corpus_path = os.path.join(workdir, "corpus.jsonl")
    query_path = os.path.join(workdir, "queries.jsonl")
    qrel_path = os.path.join(workdir, "qrels.txt")
    corpus_lib.write_jsonl(corpus_path, ds.corpus)
    corpus_lib.write_jsonl(query_path, ds.queries)
    with open(qrel_path, "w") as f:
        for qid, docs in ds.qrels.items():
            for did, gain in docs.items():
                f.write(f"{qid} 0 {did} {gain}\n")

    # -- 2. the splitter (paper: python -m asyncval.splitter) --------------
    baseline = corpus_lib.lexical_baseline_run(ds, k=100)
    subset = RunFileTopK(depth=20).sample(list(ds.corpus), baseline, ds.qrels)
    write_subset_jsonl(subset, ds.corpus, os.path.join(workdir,
                                                       "subset.jsonl"))
    print(f"[quickstart] splitter: {len(ds.corpus)} passages -> "
          f"{subset.size} in the depth-20 subset")

    # -- 3. train, dropping checkpoints into the checkpoint directory ------
    spec = toy_spec(ds.vocab, device=device)
    ckdir = os.path.join(workdir, "ckpts")
    _, snapshots = train_toy_dr(ds, spec, steps=steps,
                                snapshot_every=snapshot_every)
    for step, params in snapshots:
        ckpt.save(ckdir, step, {"params": params})

    # -- 4. the closed loop: watch -> stream encode -> top-k -> report -----
    # The streaming engine folds each corpus chunk's scores into a running
    # (Q, k) top-k on the device: the (N, D) embedding matrix never exists.
    corpus = corpus_lib.read_jsonl(corpus_path)       # round-trip the files
    queries = corpus_lib.read_jsonl(query_path)
    qrels = read_trec_qrels(qrel_path)
    suite = ValidationSuite(spec, [
        ValidationTask("default", corpus, queries, qrels,
                       sampler=RunFileTopK(depth=20), baseline_run=baseline,
                       metrics=("MRR@10", "Recall@100"), k=100),
    ], ValidationConfig(metrics=("MRR@10", "Recall@100"), k=100,
                        batch_size=128, engine="streaming",
                        chunk_size=chunk_size, impl=impl, write_run=True,
                        output_dir=os.path.join(workdir, "runs")))
    engine = suite.engine("default")
    n_chunks = engine.doc_store.n_chunks
    print(f"[quickstart] engine: {engine.name} ({n_chunks} corpus chunks "
          f"of {engine.doc_store.chunk}, impl {impl})")
    ledger_path = os.path.join(workdir, "ledger.jsonl")
    validator = AsyncValidator(
        ckdir, suite, logger=CSVLogger(os.path.join(workdir, "metrics.csv")),
        ledger_path=ledger_path)
    n = validator.validate_pending()

    print(f"[quickstart] validated {n} checkpoints:")
    for r in validator.results:
        print(f"  step {r.step:>4}: MRR@10={r.metrics['MRR@10']:.4f} "
              f"Recall@100={r.metrics['Recall@100']:.4f} "
              f"({r.timings['total_s']:.2f}s on {r.subset_size} passages)")
    best = max(validator.results, key=lambda r: r.metrics["MRR@10"])
    print(f"[quickstart] best checkpoint: step {best.step} "
          f"(MRR@10={best.metrics['MRR@10']:.4f})")
    print(f"[quickstart] metrics CSV + TREC runs under {workdir}")
    assert validator.results[-1].metrics["MRR@10"] > \
        validator.results[0].metrics["MRR@10"], "training should help"
    return {"workdir": workdir, "ckpts_dir": ckdir,
            "ledger_path": ledger_path, "subset_size": subset.size,
            "n_chunks": n_chunks, "n_validated": n,
            "results": [{"step": r.step, "metrics": dict(r.metrics),
                         "subset_size": r.subset_size}
                        for r in validator.results],
            "best_step": best.step}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--impl", choices=["torch", "cuda"], default="torch")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, impl=args.impl, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
