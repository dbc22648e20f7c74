"""Multi-task validation on PyTorch: several validation sets, one
checkpoint pass.

The twin of ``examples/multi_task_validation.py`` on the port
(``repro_torch``).  Cho et al. 2022 validate checkpoints against several
efficient validation sets and pick the one that transfers; the
``ValidationSuite`` is that protocol on Asyncval's loop:

  * two tasks ("dev" and "heldout" query splits) over the SAME corpus:
    the suite pads the corpus TokenStore once and both engines stream it
    (``suite.store_builds == 1``);
  * the validator writes one ledger row per (step, task);
  * the control plane selects and early-stops on the composite metric
    ``0.5*dev:MRR@10 + 0.5*heldout:MRR@10``.

    python examples/multi_task_validation_torch.py               # on the GPU
    python examples/multi_task_validation_torch.py --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.control import ControlConfig, ControlPlane  # noqa: E402
from repro_torch.core.suite import (ValidationConfig,  # noqa: E402
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import AsyncValidator  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.models.toy import toy_spec, train_toy_dr  # noqa: E402


def split_queries(ds, frac=0.5):
    """Two disjoint (queries, qrels) splits over one corpus."""
    qids = sorted(ds.queries)
    cut = int(len(qids) * frac)

    def mk(ids):
        return ({q: ds.queries[q] for q in ids},
                {q: ds.qrels[q] for q in ids if q in ds.qrels})
    return mk(qids[:cut]), mk(qids[cut:])


def main(*, device: str = "cuda", n_passages: int = 900,
         n_queries: int = 80, steps: int = 80, snapshot_every: int = 10,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="asyncval_multitask_")
    os.makedirs(workdir, exist_ok=True)
    print(f"[multi-task] workdir: {workdir}")

    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=n_passages,
                                                n_queries=n_queries)
    (dev_q, dev_qrels), (ho_q, ho_qrels) = split_queries(ds)

    # -- train, committing checkpoints --------------------------------------
    spec = toy_spec(ds.vocab, device=device)
    ckdir = os.path.join(workdir, "ckpts")
    _, snapshots = train_toy_dr(ds, spec, steps=steps,
                                snapshot_every=snapshot_every)
    for step, params in snapshots:
        ckpt.save(ckdir, step, {"params": params})

    # -- the suite: two tasks, one shared corpus store ----------------------
    suite = ValidationSuite(spec, [
        ValidationTask("dev", ds.corpus, dev_q, dev_qrels,
                       metrics=("MRR@10", "Recall@100"), k=100),
        ValidationTask("heldout", ds.corpus, ho_q, ho_qrels,
                       metrics=("MRR@10",), k=100),
    ], ValidationConfig(batch_size=128, chunk_size=128))
    suite.engine("dev"), suite.engine("heldout")    # build both engines
    assert suite.store_builds == 1, "same corpus -> ONE TokenStore build"
    print(f"[multi-task] 2 tasks share {suite.store_builds} corpus "
          f"TokenStore ({suite.engine('dev').doc_store.n_chunks} chunks)")

    # -- control plane on a composite metric spec ---------------------------
    cmetric = "0.5*dev:MRR@10 + 0.5*heldout:MRR@10"
    control = ControlPlane(
        ckdir,
        ControlConfig(metric=cmetric, mode="max", keep_top_k=3,
                      early_stop=True, patience=3),
        stop_path=os.path.join(workdir, "STOP"),
        event_path=os.path.join(workdir, "control.jsonl"))

    ledger_path = os.path.join(workdir, "ledger.jsonl")
    validator = AsyncValidator(ckdir, suite, controller=control,
                               ledger_path=ledger_path)
    n = validator.validate_pending()

    print(f"[multi-task] validated {n} checkpoints x "
          f"{len(suite.task_names)} tasks:")
    for r in validator.results:
        agg = 0.5 * r.metrics["dev:MRR@10"] + \
            0.5 * r.metrics["heldout:MRR@10"]
        print(f"  step {r.step:>4}: dev={r.metrics['dev:MRR@10']:.4f} "
              f"heldout={r.metrics['heldout:MRR@10']:.4f} "
              f"composite={agg:.4f}")
    keys = [(row["step"], row["task"]) for row in validator.ledger.rows()]
    print(f"[multi-task] ledger rows are keyed (step, task): {keys[:4]} ...")
    print(f"[multi-task] best step by composite spec: "
          f"{control.selector.best_step} "
          f"(value {control.selector.best_value:.4f})")
    stop = None
    if control.stopped:
        stop = {"reason": control.earlystop.reason,
                "step": control.earlystop.stop_step}
        print(f"[multi-task] early stop published: {stop['reason']} at "
              f"step {stop['step']}")
    assert all(len(validator.ledger.tasks_for(s)) == 2
               for s in validator.ledger.validated_steps)
    return {"workdir": workdir, "ckpts_dir": ckdir,
            "ledger_path": ledger_path, "n_validated": n,
            "rows": validator.ledger.rows(),
            "best_step": control.selector.best_step,
            "best_value": control.selector.best_value, "stop": stop}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
