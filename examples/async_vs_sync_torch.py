"""Paper Figure 1 on PyTorch: the same train + validate workload run both
ways.

The twin of ``examples/async_vs_sync.py`` on the port (``repro_torch``):

  * sync  (Fig. 1a): training pauses for each checkpoint's validation;
  * async (Fig. 1b): a decoupled validator consumes checkpoints while
    training continues; the total collapses to ~train + last validation.

It carries its own copy of the reference's ``bench_async_schedule.run``
(:func:`run`), on the port's pipeline, samplers, corpus and toy
retriever.

    python examples/async_vs_sync_torch.py               # on the GPU
    python examples/async_vs_sync_torch.py --device cpu
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core.pipeline import (ValidationConfig,  # noqa: E402
                                       ValidationPipeline)
from repro_torch.core.samplers import RunFileTopK  # noqa: E402
from repro_torch.core.validator import (CKPT_TO_VERDICT_METRIC,  # noqa: E402
                                        AsyncValidator)
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.models.nn import to_torch_tree  # noqa: E402
from repro_torch.models.toy import contrastive_step, toy_spec  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402


class Timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.seconds = time.time() - self.t0


def run(n_ckpts: int = 4, steps_per_ckpt: int = 40, corpus_size: int = 1500,
        n_queries: int = 60, depth: int = 40, seed: int = 0, *,
        device: str = "cuda", workdir: str = None):
    """Total train + validate wall time, sync against async.  With
    ``workdir`` each mode's checkpoints stay under ``workdir/<mode>/ckpts``
    (the row's ``ckpts_dir``); without, they go with a temporary
    directory."""
    ds = corpus_lib.synthetic_retrieval_dataset(
        seed, n_passages=corpus_size, n_queries=n_queries)
    baseline = corpus_lib.lexical_baseline_run(ds, k=depth)
    spec = toy_spec(ds.vocab, device=device)
    vcfg = ValidationConfig(metrics=("MRR@10",), k=100, batch_size=128)
    rows = []

    def put(a):
        return torch.from_numpy(a).to(spec.device)

    for mode in ("sync", "async"):
        if workdir:
            mode_dir = os.path.join(workdir, mode)
            os.makedirs(mode_dir, exist_ok=True)
        else:
            mode_dir = tempfile.mkdtemp(prefix=f"asyncval_{mode}_")
        ckdir = os.path.join(mode_dir, "ckpts")
        pipe = ValidationPipeline(spec, ds.corpus, ds.queries, ds.qrels,
                                  vcfg, sampler=RunFileTopK(depth=depth),
                                  baseline_run=baseline)
        # metrics-only telemetry (no trace file): checkpoint commit to
        # verdict, for the async row
        tel = Telemetry(None) if mode == "async" else None
        validator = AsyncValidator(ckdir, pipe, poll_interval_s=0.02,
                                   telemetry=tel)
        t_train, t_val = [], []

        with Timer() as total:
            if mode == "async":
                validator.start()
            params = to_torch_tree(spec.init(seed), spec.device)
            step_fn = contrastive_step(spec)
            rng = np.random.default_rng(seed)
            qids = sorted(ds.qrels)
            step = 0
            for _ in range(n_ckpts):
                with Timer() as tt:
                    for _ in range(steps_per_ckpt):
                        step += 1
                        pick = rng.choice(len(qids), size=32)
                        q_tok = [ds.queries[qids[j]] for j in pick]
                        p_tok = [ds.corpus[next(iter(ds.qrels[qids[j]]))]
                                 for j in pick]
                        qt, qm = corpus_lib.pad_batch(q_tok, spec.q_max_len)
                        pt, pm = corpus_lib.pad_batch(p_tok, spec.p_max_len)
                        params, _ = step_fn(
                            params, {"q_tokens": put(qt), "q_mask": put(qm),
                                     "p_tokens": put(pt), "p_mask": put(pm)})
                    ckpt.save(ckdir, step, {"params": params})
                t_train.append(tt.seconds)
                if mode == "sync":
                    with Timer() as tv:
                        validator.validate_pending()
                    t_val.append(tv.seconds)
            if mode == "async":
                validator.stop(drain=True)
        if not workdir:
            shutil.rmtree(mode_dir, ignore_errors=True)

        val_total = sum(r.timings["total_s"] for r in validator.results)
        row = {
            "mode": mode, "total_s": total.seconds,
            "train_s": sum(t_train), "validate_s": val_total,
            "n_validated": len(validator.results),
            "mrr_last": validator.results[-1].metrics["MRR@10"]
            if validator.results else float("nan"),
            "metrics": {r.step: dict(r.metrics) for r in validator.results},
            "subset_size": pipe.subset.size,
        }
        if workdir:
            row["ckpts_dir"] = ckdir
        if tel is not None:
            hist = tel.metrics.get(CKPT_TO_VERDICT_METRIC)
            if hist is not None and hist.count:
                row["ckpt_to_verdict_p50_s"] = hist.percentile(50)
                row["ckpt_to_verdict_p99_s"] = hist.percentile(99)
        rows.append(row)
    return rows


def main(*, device: str = "cuda", n_ckpts: int = 4, steps_per_ckpt: int = 40,
         corpus_size: int = 2500, n_queries: int = 60, depth: int = 60,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    rows = run(n_ckpts=n_ckpts, steps_per_ckpt=steps_per_ckpt,
               corpus_size=corpus_size, n_queries=n_queries, depth=depth,
               device=device, workdir=workdir)
    sync = next(r for r in rows if r["mode"] == "sync")
    asyn = next(r for r in rows if r["mode"] == "async")
    print(f"{'mode':<8} {'total':>8} {'train':>8} {'validate':>9} "
          f"{'#validated':>10} {'final MRR@10':>13}")
    for r in rows:
        print(f"{r['mode']:<8} {r['total_s']:>7.2f}s {r['train_s']:>7.2f}s "
              f"{r['validate_s']:>8.2f}s {r['n_validated']:>10} "
              f"{r['mrr_last']:>13.4f}")
    speedup = sync["total_s"] / asyn["total_s"]
    print(f"\nasync speedup: {speedup:.2f}x "
          f"(paper Fig. 1: validation time hides behind training)")
    return {"rows": rows, "speedup": speedup, "workdir": workdir}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
