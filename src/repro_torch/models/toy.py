"""The toy dense retriever of the JAX package's benchmarks
(``benchmarks/common.py``): a bag-of-embeddings encoder over one
``(vocab, 32)`` table that trains to a high MRR on the synthetic topic
dataset in seconds, so a test or a demo can make a whole sequence of
checkpoints of rising quality.

Two divergences by design:

  * ``init`` draws the table from a numpy seed (the port cannot reproduce
    ``jax.random``); :func:`train_toy_dr` takes ``params=`` so a caller can
    start both packages from one table;
  * :func:`contrastive_step` runs eager autograd and returns new tensors,
    as ``repro_torch.train.optim`` does.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.data import corpus as corpus_lib
from repro_torch.models.biencoder import EncoderSpec
from repro_torch.models.nn import to_torch_tree

DIM = 32


def toy_encode(params, tokens: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean of the masked token embeddings, L2-normalised: (B, L) -> (B,
    32) f32."""
    emb = params["table"][tokens.long()]
    m = mask.to(emb.dtype)[..., None]
    v = (emb * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-6)


def toy_spec(vocab: int, q_max_len: int = 10, p_max_len: int = 26, *,
             device="cuda") -> EncoderSpec:
    def init(seed: int):
        rng = np.random.default_rng(seed)
        return {"table": (0.1 * rng.standard_normal((vocab, DIM)))
                .astype(np.float32)}

    return EncoderSpec(name="toy-dr", dim=DIM, encode_query=toy_encode,
                       encode_passage=toy_encode, init=init,
                       param_shapes={"table": (vocab, DIM)},
                       device=torch.device(device), q_max_len=q_max_len,
                       p_max_len=p_max_len)


def contrastive_step(spec: EncoderSpec, lr: float = 0.5):
    """One SGD step of the in-batch-negative loss (scores scaled by 10):
    ``step(params, batch) -> (new params, loss)``."""

    def loss_fn(params, batch):
        q = spec.encode_query(params, batch["q_tokens"], batch["q_mask"])
        p = spec.encode_passage(params, batch["p_tokens"], batch["p_mask"])
        scores = (q @ p.T) * 10.0
        labels = torch.arange(q.shape[0], device=scores.device)
        lse = torch.logsumexp(scores, dim=-1)
        pos = scores.gather(1, labels[:, None])[:, 0]
        return torch.mean(lse - pos)

    def step(params, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in pytree.tree_leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_map(lambda _: next(it), params),
                           batch)
            grads = iter(torch.autograd.grad(loss, leaves))
        new = pytree.tree_map(lambda t: (t - lr * next(grads)).detach(),
                              params)
        return new, loss.detach()

    return step


def train_toy_dr(ds, spec: EncoderSpec, *, steps: int, batch: int = 32,
                 seed: int = 0, snapshot_every: int = 0, lr: float = 0.5,
                 params: Optional[Any] = None):
    """Train the toy retriever with in-batch negatives from ``params``
    (default ``spec.init(seed)``); returns ``(params, snapshots)`` with
    ``snapshots = [(step, params), ...]`` from step 0, tensors on
    ``spec.device``.  The batches are the reference's: the same numpy
    generator picks the same queries."""
    step_fn = contrastive_step(spec, lr=lr)
    params = to_torch_tree(spec.init(seed) if params is None else params,
                           spec.device)
    qids = sorted(ds.qrels)
    snapshots = [(0, params)]
    rng = np.random.default_rng(seed)
    device = spec.device

    def put(a):
        return torch.from_numpy(a).to(device)

    for i in range(1, steps + 1):
        pick = rng.choice(len(qids), size=batch)
        q_tok = [ds.queries[qids[j]] for j in pick]
        p_tok = [ds.corpus[next(iter(ds.qrels[qids[j]]))] for j in pick]
        qt, qm = corpus_lib.pad_batch(q_tok, spec.q_max_len)
        pt, pm = corpus_lib.pad_batch(p_tok, spec.p_max_len)
        params, _ = step_fn(params, {"q_tokens": put(qt), "q_mask": put(qm),
                                     "p_tokens": put(pt), "p_mask": put(pm)})
        if snapshot_every and i % snapshot_every == 0:
            snapshots.append((i, params))
    return params, snapshots
