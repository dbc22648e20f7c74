"""Live serving on PyTorch: train, validate, promote, answer. One process.

The twin of ``examples/serve_live.py`` on the port (``repro_torch``): the
full Asyncval loop with the serving tier closed over it.

  * a **trainer** thread runs contrastive steps and commits a checkpoint
    every ``steps_per_ckpt`` steps (``ckpt.save``'s two-phase commit);
  * the **validator** scores each committed checkpoint and feeds a
    :class:`ControlPlane` that ranks them;
  * a **promoter** follows the control plane's best pick and hot-swaps the
    serving index in two phases (build aside on its own CUDA stream,
    verify, pointer flip), so the query path never blocks;
  * a **client** thread calls :meth:`QueryService.submit` the whole time;
    every answer names exactly one promoted checkpoint;
  * checkpoint **GC** runs with the serving tier's ``protect_set``, so the
    live index's checkpoint is never deleted.

    python examples/serve_live_torch.py               # on the GPU
    python examples/serve_live_torch.py --device cpu
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.control import ControlConfig, ControlPlane  # noqa: E402
from repro_torch.core.suite import (ValidationConfig,  # noqa: E402
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import AsyncValidator  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.models.nn import to_torch_tree  # noqa: E402
from repro_torch.models.toy import contrastive_step, toy_spec  # noqa: E402
from repro_torch.serve import (AdmissionController,  # noqa: E402
                               IndexBuilder, Promoter, QueryService,
                               ServeConfig, replay_swaps)


def main(*, device: str = "cuda", n_passages: int = 600,
         n_queries: int = 30, n_ckpts: int = 3, steps_per_ckpt: int = 20,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="asyncval_serve_live_")
    os.makedirs(workdir, exist_ok=True)
    ckdir = os.path.join(workdir, "ckpts")
    print(f"[serve-live] workdir: {workdir}")

    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=n_passages,
                                                n_queries=n_queries)
    spec = toy_spec(ds.vocab, device=device)

    # -- validation + control: rank every committed checkpoint ------------
    suite = ValidationSuite(spec, [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels),
    ], ValidationConfig(metrics=("MRR@10",), k=10, batch_size=64))
    control = ControlPlane(
        ckdir, ControlConfig(metric="MRR@10", mode="max", keep_top_k=2),
        event_path=os.path.join(workdir, "control.jsonl"))

    # -- serving tier: same spec, same corpus, same scoring knobs ----------
    builder = IndexBuilder(spec, ds.corpus, ServeConfig(k=10, batch_size=64))
    service = QueryService(spec, k=10, max_batch=8, flush_ms=2.0,
                           admission=AdmissionController(max_pending=256))
    serve_log = os.path.join(workdir, "serve.jsonl")
    promoter = Promoter(builder, service, ckdir,
                        target_fn=lambda: control.selector.best_step,
                        log=serve_log)
    validator = AsyncValidator(ckdir, suite, controller=control,
                               ledger_path=os.path.join(workdir,
                                                        "ledger.jsonl"),
                               extra_protect=promoter.protect_set)

    # -- trainer thread: contrastive steps, committed on a cadence ---------
    def put(a):
        return torch.from_numpy(a).to(spec.device)

    def trainer():
        params = to_torch_tree(spec.init(0), spec.device)
        step_fn = contrastive_step(spec)
        rng = np.random.default_rng(0)
        qids = sorted(ds.qrels)
        step = 0
        for _ in range(n_ckpts):
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
            print(f"[trainer] committed step {step}")

    # -- client thread: queries never stop while indexes swap under them --
    stop = threading.Event()
    responses, drops = [], []

    def client():
        qids = list(ds.queries)
        j = 0
        while not stop.is_set():
            if service.live is None:       # nothing promoted yet
                time.sleep(0.01)
                continue
            qid = qids[j % len(qids)]
            j += 1
            try:
                responses.append(service.submit(qid, ds.queries[qid],
                                                timeout=30))
            except BaseException as e:
                drops.append(repr(e))
                return

    service.start()
    t_train = threading.Thread(target=trainer)
    t_client = threading.Thread(target=client)
    t_train.start()
    t_client.start()

    # -- drive the loop: validate what lands, promote what wins -----------
    deadline = time.monotonic() + 120
    validated = set()
    while time.monotonic() < deadline:
        validator.validate_pending()
        for r in validator.results:
            if r.step not in validated:
                validated.add(r.step)
                print(f"[validator] step {r.step}: "
                      f"MRR@10={r.metrics['MRR@10']:.4f}")
        if promoter.poll_once():
            print(f"[promoter] hot-swap -> step {service.live_step()} "
                  f"(protects {sorted(promoter.protect_set())})")
        if not t_train.is_alive() and len(validated) >= n_ckpts \
                and service.live_step() == control.selector.best_step:
            break
        time.sleep(0.05)
    time.sleep(0.5)          # let the client serve against the final pick
    stop.set()
    t_train.join()
    t_client.join()
    service.stop()

    # -- GC with the serving tier protected --------------------------------
    removed = ckpt.gc_checkpoints(ckdir, keep_last=1,
                                  protect=validator.protect_set())
    live = service.live_step()
    print(f"[gc] removed {sorted(removed)}; live step {live} survives: "
          f"{live in ckpt.list_steps(ckdir)}")

    # -- the audit: every answer came from a then-promoted checkpoint ------
    swaps = replay_swaps(serve_log)
    promoted = {s["step"] for s in swaps}
    served = {r.step for r in responses}
    print(f"[audit] {len(responses)} responses, {len(drops)} drops, "
          f"swap timeline {[s['step'] for s in swaps]}, "
          f"served steps {sorted(served)}")
    assert not drops, drops
    assert served <= promoted, served - promoted
    assert live in ckpt.list_steps(ckdir), "GC deleted the live checkpoint"
    print("[serve-live] OK — zero-downtime promotion, full attribution")
    return {"workdir": workdir, "serve_log": serve_log,
            "n_responses": len(responses), "drops": len(drops),
            "swaps": [s["step"] for s in swaps], "served": sorted(served),
            "live_step": live, "removed": sorted(removed),
            "metrics": {r.step: dict(r.metrics) for r in validator.results}}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
