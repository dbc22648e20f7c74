"""Streaming validation engine: encode -> top-k with no corpus matrix.

The port of ``repro/core/engine.py`` for retrieval mode:

  1. :class:`TokenStore` pads the corpus once into fixed-shape
     ``(chunk, L)`` token/mask chunks (memory backing).
  2. :func:`staged_batches` copies the chunks to the device ahead of the
     consumer: each batch goes through pinned host memory with a
     ``non_blocking`` copy on a side CUDA stream, ``depth`` batches ahead,
     and the compute stream waits on the copy's event before using it.
  3. A :class:`Stage` encodes each chunk and folds its scores into the
     running ``(Q, k)`` top-k carry, so the ``(N, D)`` corpus embedding
     matrix never exists.  Two impls route to two stages: ``torch`` (the
     counterpart of the reference's ``xla``) does matmul + mask + a stable
     sort merge in plain PyTorch; ``cuda`` (the counterpart of ``pallas``)
     calls the hand-written topk_mips kernels.

Rerank, the materialized and sharded engines, and mmap-backed stores wait
for later slices of the port.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.precision import chunk_scores, validate_score_dtype
from repro_torch.core.registry import (ENGINES, IMPLS, MODES, STAGES,
                                       register_engine, register_impl,
                                       register_mode, register_stage)
from repro_torch.data.corpus import Tokens, pad_batch
from repro_torch.kernels.topk_mips import ops as mips_ops
from repro_torch.kernels.topk_mips.ref import select_topk
from repro_torch.models.nn import to_torch_tree

Run = Dict[str, List[str]]
Scores = Dict[str, List[float]]


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU), so host clocks
    around it measure the work and not its enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Stage 1: TokenStore — pad/chunk the corpus once, amortized over checkpoints
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenStore:
    """Corpus tokens padded into fixed-shape chunks.

    ``tokens``/``mask`` are ``(n_chunks, chunk, L)`` host arrays; the final
    ragged chunk is zero-padded and ``rows_valid`` says how many of its rows
    are real."""

    tokens: np.ndarray          # (n_chunks, chunk, L) int32
    mask: np.ndarray            # (n_chunks, chunk, L) bool
    chunk: int
    n_texts: int
    backing: str = "memory"

    @classmethod
    def build(cls, texts: Sequence[Tokens], *, max_len: int, chunk: int,
              backing: str = "memory") -> "TokenStore":
        if backing != "memory":
            raise NotImplementedError(f"TokenStore backing {backing!r} is "
                                      "not yet ported (memory only)")
        n = len(texts)
        chunk = max(1, chunk)
        n_chunks = -(-n // chunk) if n else 0
        toks = np.zeros((n_chunks, chunk, max_len), np.int32)
        mask = np.zeros((n_chunks, chunk, max_len), bool)
        for ci in range(n_chunks):
            part = list(texts[ci * chunk:(ci + 1) * chunk])
            t, m = pad_batch(part, max_len)
            toks[ci, :len(part)] = t
            mask[ci, :len(part)] = m
        return cls(tokens=toks, mask=mask, chunk=chunk, n_texts=n)

    @property
    def n_chunks(self) -> int:
        return self.tokens.shape[0]

    def rows_valid(self, ci: int) -> int:
        return min(self.chunk, self.n_texts - ci * self.chunk)


# ---------------------------------------------------------------------------
# Stage 2: host->device staging ahead of compute
# ---------------------------------------------------------------------------


def plan_schedule(n_chunks: int) -> List[Tuple[int, int]]:
    """Dispatch schedule ``[(first_chunk, n_chunks_in_batch), ...]``, one
    chunk per step: the reference's schedule at ``window=1`` (its windowed
    dispatch is not ported yet)."""
    return [(ci, 1) for ci in range(n_chunks)]


def staged_batches(store: TokenStore, schedule: Sequence[Tuple[int, int]], *,
                   device: torch.device, depth: int = 2
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield ``(tokens, mask)`` on ``device`` for each schedule entry, the
    copies issued ``depth`` batches ahead of the consumer.

    On a CUDA device each batch is copied from pinned host memory with a
    ``non_blocking`` copy on a side stream; the consumer's stream waits on
    that copy's event, and ``record_stream`` keeps the allocator from
    reusing the buffer before the consumer is done.  ``depth=1`` stages
    each batch just before it is used."""
    depth = max(1, depth)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def put(arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        return t.pin_memory().to(device, non_blocking=True) if cuda else t

    def stage(ci: int):
        if not cuda:
            return put(store.tokens[ci]), put(store.mask[ci]), None
        with torch.cuda.stream(copy_stream):
            toks, mask = put(store.tokens[ci]), put(store.mask[ci])
            done = torch.cuda.Event()
            done.record(copy_stream)
        return toks, mask, done

    q: "collections.deque" = collections.deque()
    idx = 0
    while q or idx < len(schedule):
        while idx < len(schedule) and len(q) < depth:
            q.append(stage(schedule[idx][0]))
            idx += 1
        toks, mask, done = q.popleft()
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            toks.record_stream(compute)
            mask.record_stream(compute)
        yield toks, mask


def encode_store(encode_fn: Callable, params, store: TokenStore, *,
                 device: torch.device) -> torch.Tensor:
    """Encode a whole TokenStore (the queries) -> (n_texts, D) on device."""
    outs = [encode_fn(params, toks, mask) for toks, mask in staged_batches(
        store, plan_schedule(store.n_chunks), device=device)]
    if not outs:
        return torch.zeros((0, 1), dtype=torch.float32, device=device)
    return torch.cat(outs, dim=0)[:store.n_texts]


# ---------------------------------------------------------------------------
# Stage 3: encode -> fold stages behind one interface
# ---------------------------------------------------------------------------


class Stage:
    """One streaming validation strategy: a device carry folded chunk by chunk.

    ``init(q_emb) -> carry``; ``step(params, q_emb, carry, toks, mask, base,
    n_valid) -> carry``; ``finalize(carry) -> (run, run_scores)``.
    """

    name = "stage"

    def init(self, q_emb: torch.Tensor):
        raise NotImplementedError

    def step(self, params, q_emb, carry, toks, mask, base: int, n_valid: int):
        raise NotImplementedError

    def finalize(self, carry) -> Tuple[Run, Scores]:
        raise NotImplementedError


class StreamTopKStage(Stage):
    """Retrieval mode, plain PyTorch (the reference's ``xla`` stage): encode
    a chunk, score it, mask its padding rows, and take the top k of
    ``[carry || chunk]`` with a stable sort (the carry wins ties, then the
    lower row)."""

    name = "topk_torch"

    def __init__(self, encode_fn: Callable, *, k: int, query_ids: List[str],
                 doc_ids: List[str], score_dtype: str = "f32"):
        self.encode_fn = encode_fn
        self.query_ids = query_ids
        self.doc_ids = doc_ids
        self.k = max(1, min(k, len(doc_ids))) if doc_ids else 0
        self.score_dtype = validate_score_dtype(score_dtype)

    def init(self, q_emb):
        Q = q_emb.shape[0]
        return (torch.full((Q, self.k), float("-inf"), device=q_emb.device),
                torch.zeros((Q, self.k), dtype=torch.int32,
                            device=q_emb.device))

    def step(self, params, q_emb, carry, toks, mask, base, n_valid):
        run_s, run_i = carry
        emb = self.encode_fn(params, toks, mask)               # (chunk, D)
        s = chunk_scores(q_emb, emb, self.score_dtype)         # (Q, chunk)
        col = torch.arange(toks.shape[0], dtype=torch.int32,
                           device=s.device)
        s = s.masked_fill((col >= n_valid)[None, :], float("-inf"))
        gcol = (col + base).expand(s.shape[0], -1)
        return select_topk(torch.cat([run_s, s], dim=1),
                           torch.cat([run_i, gcol], dim=1), self.k)

    def finalize(self, carry):
        run_s, run_i = carry[0].cpu().numpy(), carry[1].cpu().numpy()
        run, scores = {}, {}
        for qi, qid in enumerate(self.query_ids):
            run[qid] = [self.doc_ids[j] for j in run_i[qi]]
            scores[qid] = [float(s) for s in run_s[qi]]
        return run, scores


class CudaStreamTopKStage(StreamTopKStage):
    """Retrieval mode through the topk_mips kernels (the reference's
    ``pallas`` stage): the chunk's top-k and the carry merge run in the
    hand-written kernel (:func:`repro_torch.kernels.topk_mips.ops.
    topk_mips_chunk`).  On CPU tensors that wrapper runs its plain
    version."""

    name = "topk_cuda"

    def step(self, params, q_emb, carry, toks, mask, base, n_valid):
        emb = self.encode_fn(params, toks, mask)
        run_s, run_i = carry
        return mips_ops.topk_mips_chunk(q_emb, emb, run_s, run_i, base=base,
                                        n_valid=n_valid,
                                        score_dtype=self.score_dtype)


# ---------------------------------------------------------------------------
# Registry wiring: modes route to impls route to stage names
# ---------------------------------------------------------------------------


@register_impl("torch")
def _route_impl_torch() -> str:
    return "topk_torch"


@register_impl("cuda")
def _route_impl_cuda() -> str:
    return "topk_cuda"


@register_mode("retrieval")
def _route_mode_retrieval(*, impl: str) -> str:
    return IMPLS.get(impl)()


@register_stage("topk_torch")
def _stage_topk_torch(encode_fn, *, k, query_ids, doc_ids,
                      score_dtype="f32") -> Stage:
    return StreamTopKStage(encode_fn, k=k, query_ids=query_ids,
                           doc_ids=doc_ids, score_dtype=score_dtype)


@register_stage("topk_cuda")
def _stage_topk_cuda(encode_fn, *, k, query_ids, doc_ids,
                     score_dtype="f32") -> Stage:
    return CudaStreamTopKStage(encode_fn, k=k, query_ids=query_ids,
                               doc_ids=doc_ids, score_dtype=score_dtype)


def make_stage(encode_fn: Callable, *, mode: str, impl: str, k: int,
               query_ids: List[str], doc_ids: List[str],
               score_dtype: str = "f32") -> Stage:
    """Route (mode, impl) to a registered Stage; unknown names raise listing
    the registered alternatives."""
    name = MODES.get(mode)(impl=impl)
    return STAGES.get(name)(encode_fn, k=k, query_ids=query_ids,
                            doc_ids=doc_ids, score_dtype=score_dtype)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


class StreamingEngine:
    """Drive a Stage over a TokenStore: peak embedding memory is
    O(chunk x D + Q x k); ``staging_depth`` batches are staged ahead."""

    name = "streaming"

    def __init__(self, spec, doc_store: TokenStore, query_store: TokenStore,
                 stage: Stage, *, staging: str = "double_buffered",
                 staging_depth: int = 2):
        if staging not in ("double_buffered", "sync"):
            raise ValueError(f"unknown staging {staging!r} "
                             "(expected 'double_buffered' or 'sync')")
        if staging_depth < 1:
            raise ValueError(f"staging_depth must be >= 1, got "
                             f"{staging_depth!r}")
        self.spec = spec
        self.doc_store = doc_store
        self.query_store = query_store
        self.stage = stage
        self.staging = staging
        self.staging_depth = staging_depth

    @property
    def score_dtype(self) -> str:
        return getattr(self.stage, "score_dtype", "f32")

    @torch.inference_mode()
    def run(self, params) -> Tuple[Run, Scores, Dict[str, float]]:
        device = self.spec.device
        params = to_torch_tree(params, device)
        t0 = time.time()
        q_emb = encode_store(self.spec.encode_query, params, self.query_store,
                             device=device)
        synchronize(device)
        t_query = time.time() - t0

        t0 = time.time()
        store = self.doc_store
        carry = self.stage.init(q_emb)
        batches = staged_batches(
            store, plan_schedule(store.n_chunks), device=device,
            depth=1 if self.staging == "sync" else self.staging_depth)
        for ci, (toks, mask) in enumerate(batches):
            carry = self.stage.step(params, q_emb, carry, toks, mask,
                                    store.chunk * ci, store.rows_valid(ci))
        synchronize(device)
        t_stream = time.time() - t0

        t0 = time.time()
        run, scores = self.stage.finalize(carry)
        t_final = time.time() - t0
        # the reference's key names: encode_corpus_s is the fused
        # encode-and-fold loop, retrieve_s the host-side finalize
        timings = {"encode_corpus_s": t_stream, "encode_query_s": t_query,
                   "retrieve_s": t_final,
                   "total_s": t_query + t_stream + t_final}
        return run, scores, timings


@dataclasses.dataclass
class ValidationStore:
    """The sampled data one validation task runs over (the single "store"
    argument of :func:`make_engine`)."""

    query_ids: List[str]
    query_texts: List[Tokens]
    doc_ids: List[str]
    doc_texts: List[Tokens]
    per_query: Optional[Dict[str, List[str]]] = None
    doc_store: Optional[TokenStore] = None
    query_store: Optional[TokenStore] = None


def chunk_geometry(vcfg, n_docs: int) -> Tuple[int, int]:
    """(corpus chunk rows, query chunk rows): ``chunk_size`` defaults to
    ``batch_size``."""
    chunk = vcfg.chunk_size or vcfg.batch_size
    chunk = max(1, min(chunk, max(n_docs, 1)))
    return chunk, max(1, vcfg.batch_size)


@register_engine("streaming")
def make_streaming_engine(spec, store: ValidationStore, vcfg):
    """The default encode->top-k data path (see module docstring)."""
    chunk, q_chunk = chunk_geometry(vcfg, len(store.doc_texts))
    doc_store = store.doc_store
    if doc_store is None:
        doc_store = TokenStore.build(store.doc_texts, max_len=spec.p_max_len,
                                     chunk=chunk, backing=vcfg.token_backing)
    query_store = store.query_store
    if query_store is None:
        query_store = TokenStore.build(store.query_texts,
                                       max_len=spec.q_max_len, chunk=q_chunk)
    stage = make_stage(spec.encode_passage, mode=vcfg.mode, impl=vcfg.impl,
                       k=vcfg.k, query_ids=store.query_ids,
                       doc_ids=store.doc_ids, score_dtype=vcfg.score_dtype)
    return StreamingEngine(spec, doc_store, query_store, stage,
                           staging=vcfg.staging,
                           staging_depth=vcfg.staging_depth)


# the suite routes the corpus TokenStore through its shared cache for every
# factory carrying this attribute
make_streaming_engine.uses_token_stores = True


def make_engine(spec, store: ValidationStore, vcfg):
    """Build the engine a :class:`~repro_torch.core.suite.ValidationConfig`
    asks for, through the :data:`~repro_torch.core.registry.ENGINES`
    registry."""
    MODES.get(vcfg.mode)
    IMPLS.get(vcfg.impl)
    return ENGINES.get(vcfg.engine)(spec, store, vcfg)
