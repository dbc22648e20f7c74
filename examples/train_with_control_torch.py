"""Training with the convergence control plane in the loop, on PyTorch.

The twin of ``examples/train_with_control.py`` on the port
(``repro_torch``), over :func:`repro_torch.launch.train.run`:

  1. a trainer commits two-phase checkpoints every ``ckpt_every`` steps
     and polls a STOP marker file between steps (one ``os.path.exists`` per
     step, never a wait on validation);
  2. an ``AsyncValidator`` on its own thread (and its own CUDA stream)
     validates each checkpoint, appends a ledger row and hands it to the
     :class:`repro_torch.control.ControlPlane`: selection and quality-aware
     GC, plateau early stop through the STOP marker, every decision in
     ``control.jsonl`` (replayable with ``replay_ledger`` of either
     package);
  3. the trainer notices the marker and halts early;
  4. the top-k surviving checkpoints are greedy-souped into a virtual
     checkpoint, committed and validated like any trained one.

    python examples/train_with_control_torch.py               # on the GPU
    python examples/train_with_control_torch.py --device cpu --steps 300

Expect: training stops well before the step budget, only the best
checkpoints survive on disk, and the ensemble scores at least as well as
the best single checkpoint.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.launch.train import run  # noqa: E402


def main(*, device: str = "cuda", steps: int = 400, ckpt_every: int = 10,
         corpus_size: int = 150, n_queries: int = 25,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="asyncval_control_")

    class Args:
        arch = "dr-bert-base"
        batch_size = 8
        q_max_len = 10
        p_max_len = 26
        depth = 15
        lr = 2e-3
        seed = 0
        subset = True
        sync = False
        full = False
        # control plane
        early_stop_patience = 3
        early_stop_min_delta = 1e-4
        overfit_window = 0                 # plateau detection only
        keep_top_k = 3
        ensemble_top_k = 3
        policy = "budget"                  # stride self-tunes to val latency
        stride = 1

    Args.device = device
    Args.workdir = workdir
    Args.steps = steps                     # budget CAP: expect to stop early
    Args.ckpt_every = ckpt_every
    Args.corpus_size = corpus_size
    Args.n_queries = n_queries
    res = run(Args())

    print("\n=== control plane walkthrough ===")
    print(f"stopped early : {res['stopped_early']} "
          f"(verdict: {res['stop_verdict']})")
    trained = max(res['validated_steps'] or [0])
    print(f"trained steps : {trained} of a {steps}-step budget")
    print(f"best step     : {res['best_step']}")
    print(f"ckpts on disk : {res['kept_checkpoints']} (top-k ∪ protected)")
    if res["ensemble"]:
        print(f"ensemble      : step {res['ensemble']['step']} = soup of "
              f"{res['ensemble']['members']} -> {res['ensemble']['metrics']}")
    control_path = os.path.join(workdir, "control.jsonl")
    with open(control_path) as f:
        kinds = [json.loads(line)["kind"] for line in f if line.strip()]
    print(f"decision log  : {len(kinds)} events "
          f"({', '.join(sorted(set(kinds)))}) in {control_path}")
    return {**res, "workdir": workdir, "trained_steps": trained,
            "control_path": control_path,
            "ledger_path": os.path.join(workdir, "ledger.jsonl"),
            "event_kinds": kinds}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    return main(device=args.device, steps=args.steps, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
