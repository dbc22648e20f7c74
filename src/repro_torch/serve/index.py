"""Device-resident serving index, built through the validator's data path
(``repro/serve/index.py``).

The serve <-> validate parity lives here: the corpus is tokenized into the
same pre-padded :class:`~repro_torch.core.engine.TokenStore` geometry the
validation engines use (``chunk_geometry``), encoded by the same encoder
(``encode_store``), and searched through the same top-k dispatch
``retrieve_run`` uses (``impl="torch"``: :func:`~repro_torch.core.
retrieval.topk_exact`; ``impl="cuda"``: the hand-written topk_mips kernels
over the whole resident matrix), with the same ``score_dtype`` semantics
(:mod:`repro_torch.core.precision`).

Storage follows the ``MaterializedEngine`` precedent: ``bf16`` keeps the
resident ``(N, D)`` matrix in bfloat16 (half the bytes; the scoring cast is
then a no-op, value-identical to the validator's f32 -> bf16 cast), ``int8``
keeps the f32 matrix and quantizes per row at score time (per-row scales do
not depend on the chunk, so quantized scores match the streaming path's
exactly).

On a card, :class:`IndexBuilder` encodes on a CUDA stream of its own, so a
build (a whole-corpus encode) never queues ahead of the batches the query
service scores on its stream, and it synchronizes that stream before it
returns: an index is complete before any other stream can read it.

The reference's sharded index (``mesh``: rows over a device mesh, pads and
an over-request) is not ported yet; :class:`ServeConfig` has no ``mesh``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.engine import (TokenStore, chunk_geometry, doc_cache_dir,
                                     encode_store, synchronize)
from repro_torch.core.precision import validate_score_dtype
from repro_torch.core.retrieval import IMPLS, topk_exact
from repro_torch.models.nn import to_torch_tree


@dataclasses.dataclass
class ServeConfig:
    """Serving-tier knobs.  The scoring fields (``score_dtype`` / ``impl``
    / ``block``) mirror :class:`~repro_torch.core.suite.ValidationConfig`
    — an index built with the validator's values serves the validator's
    answers; ``chunk_size`` / ``batch_size`` feed the same
    :func:`chunk_geometry`, so the corpus TokenStore is padded exactly like
    the validator's."""

    k: int = 10                       # results per query
    score_dtype: str = "f32"          # f32 | bf16 | int8 (resident storage
                                      # + scoring precision, see module doc)
    impl: str = "torch"               # torch | cuda top-k
    block: int = 4096                 # topk_exact block rows
    batch_size: int = 64              # corpus encode rows (chunk geometry)
    chunk_size: Optional[int] = None  # override: TokenStore chunk rows
    max_batch: int = 8                # query micro-batch (QueryService)
    flush_ms: float = 4.0             # max-latency flush (QueryService)
    max_pending: int = 256            # admission bound (QueryService)
    token_backing: str = "memory"     # memory | mmap TokenStore backing
    mmap_dir: Optional[str] = None
    token_fingerprint: str = "fast"


@dataclasses.dataclass
class ServingIndex:
    """One checkpoint's immutable serving state: the device-resident corpus
    embeddings plus the checkpoint's params on the same device (queries
    must be encoded by the checkpoint the corpus was), swapped as a unit by
    the promoter's pointer flip."""

    step: int
    params: Any
    doc_ids: List[str]
    emb: torch.Tensor                 # (N, D) device-resident
    n_docs: int
    score_dtype: str
    impl: str
    block: int
    build_s: float

    def topk(self, q_emb: torch.Tensor, *, k: int):
        """Raw top-k over the resident matrix, the validator's
        ``retrieve_run`` dispatch -> host numpy ``(scores (Q, k') f32,
        rows (Q, k') int32)``, ``k' = min(k, n_docs)``.  The copy to the
        host waits for the calling thread's stream, so the index is no
        longer read once this returns."""
        kk = min(k, self.n_docs)
        q = q_emb.to(self.emb.device).float().contiguous()
        if self.impl == "cuda":
            from repro_torch.kernels.topk_mips import ops as mips_ops
            s, i = mips_ops.topk_mips(q, self.emb, k=kk,
                                      score_dtype=self.score_dtype)
        else:
            s, i = topk_exact(q, self.emb, k=kk, block=self.block,
                              score_dtype=self.score_dtype)
        return s.cpu().numpy(), i.cpu().numpy()

    def search(self, q_emb: torch.Tensor, *, k: int):
        """Per-row answers: ``(ids_rows, score_rows)`` lists — row ``r``
        of ``q_emb`` gets its top-``k`` doc ids and scores.  Positional
        (not a dict) so duplicate query ids inside one micro-batch cannot
        collide."""
        s, i = self.topk(q_emb, k=k)
        ids = [[self.doc_ids[j] for j in row] for row in i]
        scores = [[float(v) for v in row] for row in s]
        return ids, scores

    def search_run(self, query_ids: Sequence[str], q_emb: torch.Tensor, *,
                   k: int):
        """``retrieve_run``-shaped: ``({qid: [docid...]}, {qid:
        [score...]})``."""
        ids, scores = self.search(q_emb, k=k)
        return ({q: r for q, r in zip(query_ids, ids)},
                {q: r for q, r in zip(query_ids, scores)})


class IndexBuilder:
    """Builds a :class:`ServingIndex` per promoted checkpoint.

    The corpus TokenStore is padded once at construction (the expensive,
    checkpoint-independent half) and reused by every build; only the
    encode pass reruns per checkpoint."""

    def __init__(self, spec, corpus: Dict[str, Sequence[int]],
                 cfg: Optional[ServeConfig] = None):
        self.cfg = cfg if cfg is not None else ServeConfig()
        validate_score_dtype(self.cfg.score_dtype)
        if self.cfg.impl not in IMPLS:
            raise ValueError(f"unknown serving impl {self.cfg.impl!r} "
                             f"(expected one of {IMPLS})")
        self.spec = spec
        self.doc_ids = list(corpus)
        chunk, _ = chunk_geometry(self.cfg, len(self.doc_ids))
        self.store = TokenStore.build(
            [corpus[d] for d in self.doc_ids],
            max_len=spec.p_max_len, chunk=chunk,
            backing=self.cfg.token_backing,
            cache_dir=doc_cache_dir(self.cfg.mmap_dir),
            fingerprint=self.cfg.token_fingerprint)
        self.index_builds = 0
        self._stream: Optional[torch.cuda.Stream] = None

    def on_stream(self):
        """Context that runs the caller's work on the builder's own CUDA
        stream (a null context on the CPU)."""
        device = torch.device(self.spec.device)
        if device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return torch.cuda.stream(self._stream)

    def build(self, params, step: int) -> ServingIndex:
        """Upload ``params`` (a restored tree lands on the CPU), encode the
        corpus and store it at the resident dtype, all on the builder's
        stream, which is synchronized before the index is returned."""
        cfg = self.cfg
        device = torch.device(self.spec.device)
        t0 = time.time()
        with self.on_stream(), torch.inference_mode():
            params = to_torch_tree(params, device)
            c_emb = encode_store(self.spec.encode_passage, params, self.store,
                                 device=device)
            # bf16: the resident matrix shrinks 2x, and scoring's bf16 cast
            # becomes a no-op over the values the validator's cast produces
            c_emb = c_emb.to(torch.bfloat16 if cfg.score_dtype == "bf16"
                             else torch.float32)
            synchronize(device)
        self.index_builds += 1
        return ServingIndex(
            step=int(step), params=params, doc_ids=self.doc_ids, emb=c_emb,
            n_docs=int(c_emb.shape[0]), score_dtype=cfg.score_dtype,
            impl=cfg.impl, block=cfg.block, build_s=time.time() - t0)
