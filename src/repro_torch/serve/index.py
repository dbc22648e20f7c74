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

With ``ServeConfig.mesh`` (a :class:`~repro_torch.distributed.compat.
DeviceMesh`) the corpus rows are split over the mesh, each shard on its
device, and searched through :func:`~repro_torch.core.retrieval.
topk_sharded`.  A corpus whose row count does not divide the shards is
zero-padded (the pads land in the last shard only) and a search
over-requests ``k + n_pad`` before a host-side pad filter: every shard's
real top k survives its local cut, so the filtered prefix equals the
unpadded answer.  Under ``impl="cuda"`` the mesh is ignored, as the
validator's route ignores it: the topk_mips kernel is single-device, so
the padded matrix stays whole on the mesh's first device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (TokenStore, chunk_geometry, doc_cache_dir,
                                     encode_store, synchronize)
from repro_torch.core.precision import validate_score_dtype
from repro_torch.core.retrieval import IMPLS, topk_exact, topk_sharded
from repro_torch.distributed.sharding import ShardedRows, rows_sharding
from repro_torch.models.nn import to_torch_tree


@dataclasses.dataclass
class ServeConfig:
    """Serving-tier knobs.  The scoring fields (``score_dtype`` / ``impl``
    / ``mesh`` / ``block``) mirror :class:`~repro_torch.core.suite.ValidationConfig`
    — an index built with the validator's values serves the validator's
    answers; ``chunk_size`` / ``batch_size`` feed the same
    :func:`chunk_geometry`, so the corpus TokenStore is padded exactly like
    the validator's."""

    k: int = 10                       # results per query
    score_dtype: str = "f32"          # f32 | bf16 | int8 (resident storage
                                      # + scoring precision, see module doc)
    impl: str = "torch"               # torch | cuda top-k
    mesh: Any = None                  # shard corpus rows over this mesh
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
    emb: Any                          # (N + n_pad, D): a device-resident
                                      # tensor, or ShardedRows on a mesh
    n_docs: int                       # real rows (pads excluded)
    score_dtype: str
    impl: str
    block: int
    build_s: float
    mesh: Any = None
    axis_names: Optional[Tuple[str, ...]] = None

    @property
    def n_pad(self) -> int:
        return int(self.emb.shape[0]) - self.n_docs

    @property
    def device(self) -> torch.device:
        """The device the merged answers land on (the first shard's)."""
        return self.emb.device

    def finite(self) -> bool:
        """True when every resident value is finite (read on the resident
        dtype, shard by shard, without an f32 copy)."""
        shards = self.emb.shards if isinstance(self.emb, ShardedRows) \
            else [self.emb]
        return all(bool(torch.isfinite(t).all()) for t in shards)

    def topk(self, q_emb: torch.Tensor, *, k: int,
             mark: Optional[Callable[[str], None]] = None):
        """Raw top-k over the resident matrix, the validator's
        ``retrieve_run`` dispatch plus the pad over-request on a padded
        index -> host numpy ``(scores (Q, k') f32, rows (Q, k') int32)``,
        ``k' = min(k, n_docs)`` real rows.  The copy to the host waits for
        the calling thread's stream, so the index is no longer read once
        this returns.  ``mark`` (a tracing hook) is called with ``"topk"``
        on entry and ``"issued"`` once the last launch has returned."""
        if mark is not None:
            mark("topk")
        kk = min(k + self.n_pad, int(self.emb.shape[0]))
        q = q_emb.to(self.device).float().contiguous()
        if self.impl == "cuda":
            from repro_torch.kernels.topk_mips import ops as mips_ops
            s, i = mips_ops.topk_mips(q, self.emb, k=kk,
                                      score_dtype=self.score_dtype)
        elif self.mesh is not None:
            s, i = topk_sharded(self.mesh, q, self.emb, k=kk,
                                axis_names=self.axis_names, block=self.block,
                                score_dtype=self.score_dtype)
        else:
            s, i = topk_exact(q, self.emb, k=kk, block=self.block,
                              score_dtype=self.score_dtype)
        if mark is not None:
            mark("issued")
        s, i = s.cpu().numpy(), i.cpu().numpy()
        kr = min(k, self.n_docs)
        if not self.n_pad:
            return s[:, :kr], i[:, :kr]
        out_s = np.empty((s.shape[0], kr), s.dtype)
        out_i = np.empty((s.shape[0], kr), i.dtype)
        for qi in range(s.shape[0]):
            keep = i[qi] < self.n_docs          # pads score 0; drop them
            out_s[qi] = s[qi, keep][:kr]
            out_i[qi] = i[qi, keep][:kr]
        return out_s, out_i

    def search(self, q_emb: torch.Tensor, *, k: int,
               mark: Optional[Callable[[str], None]] = None):
        """Per-row answers: ``(ids_rows, score_rows)`` lists — row ``r``
        of ``q_emb`` gets its top-``k`` doc ids and scores.  Positional
        (not a dict) so duplicate query ids inside one micro-batch cannot
        collide.  ``mark``: as :meth:`topk`'s."""
        s, i = self.topk(q_emb, k=k, mark=mark)
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
        chunk, _ = chunk_geometry(self.cfg, len(self.doc_ids),
                                  self.cfg.mesh)
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
        stream, which is synchronized before the index is returned.  On a
        mesh the corpus is encoded shard by shard, zero-padded to a
        multiple of the shard count and (under ``impl="torch"``) split
        over the shards."""
        cfg = self.cfg
        device = torch.device(self.spec.device)
        mesh = cfg.mesh
        axis_names = tuple(mesh.axis_names) if mesh is not None else None
        t0 = time.time()
        with self.on_stream(), torch.inference_mode():
            params = to_torch_tree(params, device)
            c_emb = encode_store(self.spec.encode_passage, params, self.store,
                                 device=device, mesh=mesh,
                                 axis_names=axis_names)
            n_docs = int(c_emb.shape[0])
            # bf16: the resident matrix shrinks 2x, and scoring's bf16 cast
            # becomes a no-op over the values the validator's cast produces
            c_emb = c_emb.to(torch.bfloat16 if cfg.score_dtype == "bf16"
                             else torch.float32)
            if mesh is not None:
                c_emb = place_rows(c_emb, mesh, axis_names,
                                   sharded=cfg.impl != "cuda")
            for dev in ([device] + (mesh.distinct_devices()
                                    if mesh is not None else [])):
                synchronize(dev)
        self.index_builds += 1
        return ServingIndex(
            step=int(step), params=params, doc_ids=self.doc_ids, emb=c_emb,
            n_docs=n_docs, score_dtype=cfg.score_dtype, impl=cfg.impl,
            block=cfg.block, build_s=time.time() - t0, mesh=mesh,
            axis_names=axis_names)


def place_rows(emb: torch.Tensor, mesh, axis_names: Sequence[str], *,
               sharded: bool = True):
    """A ``(N, D)`` corpus matrix as a mesh index holds it: zero rows
    appended up to a multiple of the shard count (so the pads lie in the
    last shard only), then split over the shards
    (:class:`~repro_torch.distributed.sharding.ShardedRows`), or, with
    ``sharded=False`` (the single-device kernel's route), left whole on
    the mesh's first device."""
    placement = rows_sharding(mesh, axis_names)
    pad = (-int(emb.shape[0])) % placement.n_shards
    if not sharded:
        emb = emb.to(mesh.home)
        return torch.cat([emb, emb.new_zeros((pad, emb.shape[1]))]) \
            if pad else emb
    if not pad:
        return placement.put(emb)
    rows = (int(emb.shape[0]) + pad) // placement.n_shards
    blocks = [emb[i * rows:(i + 1) * rows]
              for i in range(placement.n_shards)]
    blocks[-1] = torch.cat([blocks[-1],
                            emb.new_zeros((pad, emb.shape[1]))])
    return ShardedRows([b.to(d) for b, d in zip(blocks,
                                                placement.devices)])
