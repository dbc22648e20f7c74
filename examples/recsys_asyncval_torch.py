"""Asyncval beyond text retrieval on PyTorch: validating a sequential
recommender.

The twin of ``examples/recsys_asyncval.py`` on the port (``repro_torch``).
bert4rec / sasrec ARE dense retrievers over an item corpus: the
``retrieval_cand`` serving shape (one user against 1M items) is the
Asyncval validation step.  This example trains a small SASRec,
checkpoints it, and validates every checkpoint with the SAME watcher /
validator machinery the paper uses for passage retrieval: encode the item
corpus with the checkpoint's item tower, retrieve the top k per held-out
user, score MRR@10 against the next-item "qrels".  The initial weights
come from the port's numpy-seeded ``init_numpy``.

    python examples/recsys_asyncval_torch.py               # on the GPU
    python examples/recsys_asyncval_torch.py --device cpu
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.suite import (ValidationConfig,  # noqa: E402
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import AsyncValidator  # noqa: E402
from repro_torch.models import recsys as rcs  # noqa: E402
from repro_torch.models.biencoder import EncoderSpec  # noqa: E402
from repro_torch.models.nn import to_torch_tree  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

N_ITEMS = 300
SEQ = 12


def make_dataset(seed=0, n_users=400):
    """Markov-chain item sequences: item i tends to be followed by i+1
    (mod groups), a learnable next-item structure."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        x = [int(rng.integers(1, N_ITEMS))]
        for _ in range(SEQ):
            nxt = x[-1] % (N_ITEMS - 1) + 1 if rng.random() < 0.8 \
                else int(rng.integers(1, N_ITEMS))
            x.append(nxt)
        seqs.append(x)
    return np.asarray(seqs, np.int32)          # (users, SEQ+1)


def sasrec_config():
    cfg = registry.get("sasrec").smoke_config()
    return dataclasses.replace(cfg, item_vocab=N_ITEMS, seq_len=SEQ,
                               n_negatives=64, compute_dtype=torch.float32)


def sasrec_spec(cfg, device):
    """The bi-encoder view of SASRec: items are the passages (the item
    tower), held-out user histories the queries (the user tower)."""

    def encode_items(params, tokens, mask):
        return rcs.item_embeddings(params, cfg, tokens[:, 0])

    def encode_users(params, tokens, mask):
        u = rcs.user_embed(params, cfg, tokens, mask)
        return u / u.norm(dim=-1, keepdim=True).clamp(min=1e-6)

    return EncoderSpec(name="sasrec-dr", dim=cfg.embed_dim,
                       encode_query=encode_users,
                       encode_passage=encode_items,
                       init=lambda seed: rcs.init_numpy(cfg, seed),
                       param_shapes=rcs.param_shapes(cfg),
                       device=torch.device(device), q_max_len=SEQ,
                       p_max_len=1)


def main(*, device: str = "cuda", total_steps: int = 120,
         ckpt_every: int = 40, n_users: int = 400,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="recsys_asyncval_")
    os.makedirs(workdir, exist_ok=True)
    cfg = sasrec_config()
    seqs = make_dataset(n_users=n_users)
    n_train = n_users * 4 // 5
    train_seqs, valid_seqs = seqs[:n_train], seqs[n_train:]
    dev = torch.device(device)

    # ----- trainer: produces checkpoints ---------------------------------
    def batch_for(step):
        rng = np.random.default_rng(step)
        pick = rng.choice(len(train_seqs), 32)
        s = train_seqs[pick]
        return {"hist": torch.from_numpy(s[:, :-1]).to(dev),
                "pos": torch.from_numpy(s[:, 1:]).to(dev),
                "neg_ids": torch.from_numpy(
                    rng.integers(1, N_ITEMS, (64,)).astype(np.int32)).to(dev)}

    params = to_torch_tree(rcs.init_numpy(cfg, 0), dev)
    ckdir = os.path.join(workdir, "ckpts")
    trainer = Trainer(TrainerConfig(total_steps=total_steps,
                                    ckpt_every=ckpt_every, ckpt_dir=ckdir,
                                    async_save=False),
                      lambda p, b: rcs.loss_fn(p, cfg, b),
                      optim.adamw(3e-3), params, batch_for)

    # ----- the Asyncval mapping ------------------------------------------
    # corpus  = item ids (the "passages"); the item tower embeds them.
    # queries = held-out user histories; the user tower embeds them.
    # qrels   = the true next item per held-out user.
    corpus = {f"i{i}": [i] for i in range(1, N_ITEMS)}
    queries = {f"u{j}": valid_seqs[j, :-1].tolist()
               for j in range(len(valid_seqs))}
    qrels = {f"u{j}": {f"i{int(valid_seqs[j, -1])}": 1}
             for j in range(len(valid_seqs))}

    spec = sasrec_spec(cfg, device)
    suite = ValidationSuite(spec, [
        ValidationTask("default", corpus, queries, qrels,
                       metrics=("MRR@10", "Recall@100"), k=100),
    ], ValidationConfig(metrics=("MRR@10", "Recall@100"), k=100,
                        batch_size=64))
    validator = AsyncValidator(ckdir, suite, poll_interval_s=0.05)

    validator.start()
    trainer.run()
    validator.stop(drain=True)

    print("[recsys-asyncval] SASRec checkpoints validated as a dense "
          "retriever over the item corpus:")
    for r in validator.results:
        print(f"  step {r.step:>4}: MRR@10={r.metrics['MRR@10']:.4f} "
              f"Recall@100={r.metrics['Recall@100']:.4f}")
    first, last = validator.results[0], validator.results[-1]
    assert last.metrics["MRR@10"] > first.metrics["MRR@10"], \
        "training should improve next-item retrieval"
    print("[recsys-asyncval] the paper's technique is architecture-"
          "agnostic: same watcher/pipeline, different towers.")
    return {"workdir": workdir, "ckpts_dir": ckdir,
            "results": [{"step": r.step, "metrics": dict(r.metrics),
                         "subset_size": r.subset_size}
                        for r in validator.results],
            "corpus": corpus, "queries": queries, "qrels": qrels}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
