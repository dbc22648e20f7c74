"""Validation engines: streaming encode -> top-k, and the materialized path.

The port of ``repro/core/engine.py``:

  1. :class:`TokenStore` pads the corpus once into fixed-shape
     ``(chunk, L)`` token/mask chunks, in host memory or (``backing=
     "mmap"``) in memory-mapped files of the reference's on-disk format
     (version 1), built once and reused across checkpoints and processes,
     and by either package.
  2. :func:`staged_batches` copies the chunks to the device ahead of the
     consumer: each batch goes through pinned host memory with a
     ``non_blocking`` copy on a side CUDA stream, ``depth`` batches ahead,
     and the compute stream waits on the copy's event before using it.
  3. A :class:`Stage` encodes each chunk and folds it into a device carry,
     so the ``(N, D)`` corpus embedding matrix never exists.  Retrieval
     mode folds scores into a running ``(Q, k)`` top-k: impl ``torch``
     (the reference's ``xla``) in plain PyTorch, impl ``cuda`` (the
     reference's ``pallas``) through the hand-written topk_mips kernels.
     Rerank and average-rank modes gather each chunk's scores into the
     per-query candidate slots (:class:`StreamRerankStage`); the engine
     skips chunks that hold no candidate.
  4. :class:`MaterializedEngine` encodes the whole corpus onto the device
     first and then retrieves (:func:`repro_torch.core.retrieval.
     retrieve_run`: the topk_mips kernels over the whole corpus under
     ``cuda``) or reranks (:func:`~repro_torch.core.retrieval.rerank_run`).

With a :class:`repro_torch.obs.Telemetry` on the suite's config the
engines record the reference's ``encoded`` / ``staged`` / ``store_build``
spans and the ``engine.staging_wait_s`` histogram, read at the clock
points of the ledger ``timings`` (after the same stream
synchronisations); the streaming engine adds an ``uploaded`` span, a
``staged`` span per staged batch and a ``chunk`` span per chunk with the
device intervals of its trunk and fold, on the tracer's clock through an
anchor event recorded after the query encode's synchronize, and read
after the loop's.  Without one they take no extra clock reads and make
no CUDA event.

With a :class:`~repro_torch.distributed.compat.DeviceMesh` on the config
(``ValidationConfig.mesh``) the engine shards: each staged chunk's rows are
split over the mesh (:func:`~repro_torch.distributed.sharding.
rows_sharding`), every shard encodes and scores its rows on its device,
and the shards' results merge one mesh axis at a time, innermost first
(:class:`ShardedStreamTopKStage`, :class:`ShardedStreamRerankStage`); the
queries are encoded the same way.  This is the reference's ``shard_map``
step as an explicit loop over the shards.

``scan_window`` (``ValidationConfig.scan_window``, default 8) is the
reference's windowed dispatch: the ``torch`` stage takes that many chunks
per schedule entry, staged in one copy, and folds them one at a time in
chunk order through its per-chunk step, so the results are bit for bit
those of ``window=1``.  The ``cuda`` and sharded stages stay at one chunk
per step, as the reference's Pallas and ``shard_map`` stages do.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.encoder import encode_tensor
from repro_torch.core.precision import chunk_scores, validate_score_dtype
from repro_torch.core.registry import (ENGINES, IMPLS, MODES, STAGES,
                                       register_engine, register_impl,
                                       register_mode, register_stage)
from repro_torch.core.retrieval import (_hierarchical_slot_max,
                                        _hierarchical_topk_merge,
                                        pad_candidates, rank_candidates,
                                        rerank_run, retrieve_run)
from repro_torch.data.corpus import Tokens, pad_batch
from repro_torch.distributed.sharding import (ShardedRows,
                                              replicated_sharding,
                                              rows_sharding)
from repro_torch.kernels.topk_mips import ops as mips_ops
from repro_torch.kernels.topk_mips.ref import select_topk
from repro_torch.models.nn import to_torch_tree
from repro_torch.obs.device import DeviceClock

Run = Dict[str, List[str]]
Scores = Dict[str, List[float]]


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on the calling thread's current stream of
    ``device`` (no-op on the CPU), so host clocks around it measure that
    work and not its enqueueing.  The staging copies are covered, since the
    current stream waits on each staged batch's copy event before it uses
    the batch (:func:`staged_batches`).  Other streams of the card (a
    trainer's, on the same card) are not waited for."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# ---------------------------------------------------------------------------
# Stage 1: TokenStore — pad/chunk the corpus once, amortized over checkpoints
# ---------------------------------------------------------------------------


_STORE_META = "store_meta.json"
_STORE_TOKENS = "tokens.int32.bin"
_STORE_MASK = "mask.bool.bin"
_STORE_MANIFEST = "chunk_hashes.json"
_STORE_VERSION = 1


def _chunk_hash(texts: Sequence[Tokens]) -> str:
    """Content hash of one chunk's texts (the unit of the full-fingerprint
    manifest: a changed chunk hash means exactly that chunk must be
    re-padded and re-written)."""
    h = hashlib.sha1()
    for t in texts:
        h.update(np.asarray(list(t), np.int64).tobytes())
        h.update(b"|")
    return h.hexdigest()


def _full_fingerprint(chunk_hashes: Sequence[str], *, n: int, max_len: int,
                      chunk: int) -> str:
    """Overall full-content fingerprint, derived from the per-chunk hashes
    so the digest and the manifest can never disagree."""
    h = hashlib.sha1()
    h.update(f"v{_STORE_VERSION}:full:{n}:{max_len}:{chunk}".encode())
    for ch in chunk_hashes:
        h.update(ch.encode())
    return h.hexdigest()


def _store_fingerprint(texts: Sequence[Tokens], *, max_len: int,
                       chunk: int, mode: str = "fast") -> str:
    """Content fingerprint for mmap-cache reuse.

    ``mode="fast"`` (default): geometry plus a hash of the first/last 16
    texts.  Deliberately O(1) in corpus size — the point of the cache is to
    NOT re-read millions of texts per checkpoint.  The documented hazard:
    a caller that mutates the *middle* of a corpus in place (same length,
    same edges) gets a stale cache hit; such callers must use a fresh
    ``cache_dir`` or opt into ``mode="full"``.

    ``mode="full"``: hashes every text — O(corpus) per build, but any
    single-token mutation anywhere invalidates the cache.  The two modes
    hash disjoint tag prefixes, so switching modes always rebuilds rather
    than trusting the other mode's marker.
    """
    if mode not in ("fast", "full"):
        raise ValueError(f"unknown fingerprint mode {mode!r} "
                         "(expected 'fast' or 'full')")
    if mode == "full":
        n_chunks = -(-len(texts) // max(chunk, 1)) if len(texts) else 0
        hashes = [_chunk_hash(texts[ci * chunk:(ci + 1) * chunk])
                  for ci in range(n_chunks)]
        return _full_fingerprint(hashes, n=len(texts), max_len=max_len,
                                 chunk=chunk)
    h = hashlib.sha1()
    h.update(f"v{_STORE_VERSION}:{mode}:{len(texts)}:{max_len}:{chunk}"
             .encode())
    for t in list(texts[:16]) + list(texts[-16:]):
        h.update(np.asarray(list(t), np.int64).tobytes())
        h.update(b"|")
    return h.hexdigest()


@dataclasses.dataclass
class TokenStore:
    """Corpus tokens padded into fixed-shape device-friendly chunks.

    ``tokens``/``mask`` are ``(n_chunks, chunk, L)`` host arrays; every chunk
    has the same shape (the final ragged chunk is zero-padded and masked by
    ``n_valid``), so every step sees one shape.  With
    ``backing="mmap"`` they are read-only ``numpy.memmap`` views over files
    in ``cache_dir`` and only the staged chunks ever occupy host RAM.
    """

    tokens: np.ndarray          # (n_chunks, chunk, L) int32
    mask: np.ndarray            # (n_chunks, chunk, L) bool
    chunk: int
    n_texts: int
    backing: str = "memory"     # memory | mmap
    cache_dir: Optional[str] = None
    reused: bool = False        # mmap only: True when cache files were reused
    rebuilt_chunks: int = 0     # chunks padded+written by THIS build (0 on a
                                # cache hit; < n_chunks on a full-fingerprint
                                # incremental rebuild via the hash manifest)

    @classmethod
    def build(cls, texts: Sequence[Tokens], *, max_len: int, chunk: int,
              backing: str = "memory", cache_dir: Optional[str] = None,
              fingerprint: str = "fast") -> "TokenStore":
        """Pad ``texts`` into ``(n_chunks, chunk, max_len)`` token/mask arrays.

        ``backing="memory"`` (default) holds both arrays in host RAM.

        ``backing="mmap"`` spills them to memory-mapped files under
        ``cache_dir`` (required), built once and reused by every later
        ``build`` with the same geometry + content fingerprint — across
        checkpoints AND across processes.  ``fingerprint`` picks the cache
        key: ``"fast"`` (default) is O(1) in corpus size (geometry + edge
        texts — a *middle* mutation with unchanged edges is a documented
        stale hit; use a fresh ``cache_dir`` or ``"full"``), ``"full"``
        hashes every text so any in-place mutation rebuilds the cache (see
        :func:`_store_fingerprint`).  On-disk format (version 1):

        * ``store_meta.json`` — ``{"version", "n_texts", "chunk", "max_len",
          "n_chunks", "fingerprint"}``; written LAST, so a torn build (crash
          mid-write) is never mistaken for a valid cache.
        * ``tokens.int32.bin`` — raw C-order ``(n_chunks, chunk, max_len)``
          little-endian int32, zero-padded past each text's length and past
          ``n_texts`` in the final ragged chunk.
        * ``mask.bool.bin`` — raw C-order ``(n_chunks, chunk, max_len)``
          1-byte bool, ``True`` exactly on real token positions.
        * ``chunk_hashes.json`` — ``fingerprint="full"`` only: the per-chunk
          content-hash manifest ``{"version", "hashes": [sha1, ...]}``.  On a
          rebuild with unchanged geometry, only chunks whose hash differs
          from the manifest are re-padded and re-written (the memmaps are
          opened ``r+``), so full-fidelity revalidation costs O(changed
          chunks) of padding/IO instead of O(corpus) — change detection
          itself is a hash pass, which is what ``full`` already paid.
          Written immediately before the meta marker; fast-mode rebuilds
          delete it so it can never describe bins they rewrote.

        The build itself streams chunk by chunk, so peak host memory during
        construction is ``O(chunk x max_len)`` regardless of corpus size;
        afterwards the maps are reopened read-only (``mode="r"``) so the
        cache cannot be corrupted by a stray write.
        """
        if fingerprint not in ("fast", "full"):
            raise ValueError(f"unknown fingerprint mode {fingerprint!r} "
                             "(expected 'fast' or 'full')")
        n = len(texts)
        chunk = max(1, chunk)
        n_chunks = -(-n // chunk) if n else 0
        shape = (n_chunks, chunk, max_len)
        if backing == "memory":
            toks = np.zeros(shape, np.int32)
            mask = np.zeros(shape, bool)
            for ci in range(n_chunks):
                part = list(texts[ci * chunk:(ci + 1) * chunk])
                t, m = pad_batch(part, max_len)
                toks[ci, :len(part)] = t
                mask[ci, :len(part)] = m
            return cls(tokens=toks, mask=mask, chunk=chunk, n_texts=n,
                       rebuilt_chunks=n_chunks)
        if backing != "mmap":
            raise ValueError(f"unknown TokenStore backing {backing!r} "
                             "(expected 'memory' or 'mmap')")
        if not cache_dir:
            raise ValueError("TokenStore backing='mmap' needs a cache_dir")
        os.makedirs(cache_dir, exist_ok=True)
        meta_path = os.path.join(cache_dir, _STORE_META)
        tok_path = os.path.join(cache_dir, _STORE_TOKENS)
        mask_path = os.path.join(cache_dir, _STORE_MASK)
        manifest_path = os.path.join(cache_dir, _STORE_MANIFEST)
        chunk_hashes: Optional[List[str]] = None
        if fingerprint == "full":
            chunk_hashes = [_chunk_hash(texts[ci * chunk:(ci + 1) * chunk])
                            for ci in range(n_chunks)]
            fp = _full_fingerprint(chunk_hashes, n=n, max_len=max_len,
                                   chunk=chunk)
        else:
            fp = _store_fingerprint(texts, max_len=max_len, chunk=chunk,
                                    mode=fingerprint)
        meta = {"version": _STORE_VERSION, "n_texts": n, "chunk": chunk,
                "max_len": max_len, "n_chunks": n_chunks, "fingerprint": fp}
        n_slots = int(np.prod(shape))
        stored = None
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    stored = json.load(f)
            except ValueError:      # torn/truncated meta: rebuild, not crash
                stored = None
        # a valid marker alone is not enough: the bins must exist with
        # exactly the bytes the marker promises (a partially copied or
        # hand-cleaned cache_dir must rebuild, not crash or mis-map)
        sizes_ok = True
        if n_chunks:
            try:
                sizes_ok = (os.path.getsize(tok_path) == n_slots * 4
                            and os.path.getsize(mask_path) == n_slots)
            except OSError:
                sizes_ok = False
        same_geometry = stored is not None and all(
            stored.get(k) == meta[k]
            for k in ("version", "n_texts", "chunk", "max_len", "n_chunks"))
        reused = (same_geometry and sizes_ok
                  and stored.get("fingerprint") == fp)
        rebuilt: List[int] = []
        if not reused and n_chunks:
            # full-fingerprint incremental rebuild: when the geometry is
            # unchanged and the previous *full* build left a per-chunk hash
            # manifest, only chunks whose hash changed are re-padded and
            # re-written — O(changed chunks) instead of O(corpus).  The
            # manifest is trustworthy because every code path that rewrites
            # the bins either rewrites it too (full builds, below) or
            # removes it (fast builds), and a reused cache touches neither.
            prev_hashes: Optional[List[str]] = None
            if same_geometry and sizes_ok and chunk_hashes is not None:
                try:
                    with open(manifest_path) as f:
                        prev = json.load(f)
                    if (prev.get("version") == _STORE_VERSION
                            and isinstance(prev.get("hashes"), list)
                            and len(prev["hashes"]) == n_chunks):
                        prev_hashes = prev["hashes"]
                except (OSError, ValueError):
                    prev_hashes = None
            incremental = prev_hashes is not None
            rebuilt = ([ci for ci in range(n_chunks)
                        if prev_hashes[ci] != chunk_hashes[ci]]
                       if incremental else list(range(n_chunks)))
            # invalidate the old commit marker FIRST: if this rebuild dies
            # mid-write, no stale meta can bless the half-rewritten bins
            if os.path.exists(meta_path):
                os.remove(meta_path)
            if not incremental and os.path.exists(manifest_path):
                # bins are about to stop matching the old manifest; a fast
                # build writes no replacement, so the stale one must go
                os.remove(manifest_path)
            wmode = "r+" if incremental else "w+"
            wt = np.memmap(tok_path, dtype=np.int32, mode=wmode, shape=shape)
            wm = np.memmap(mask_path, dtype=bool, mode=wmode, shape=shape)
            for ci in rebuilt:
                part = list(texts[ci * chunk:(ci + 1) * chunk])
                t, m = pad_batch(part, max_len)
                wt[ci] = 0
                wm[ci] = False
                wt[ci, :len(part)] = t
                wm[ci, :len(part)] = m
            wt.flush()
            wm.flush()
            del wt, wm
        if not reused:
            if chunk_hashes is not None:
                # manifest before meta: a crash in between leaves no meta,
                # forcing a rebuild — never a meta blessing a stale manifest
                tmp = manifest_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"version": _STORE_VERSION,
                               "hashes": chunk_hashes}, f)
                os.replace(tmp, manifest_path)
            # commit marker: meta written LAST, and atomically (a crash
            # mid-write must leave no half-valid marker behind)
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, meta_path)
        if n_chunks:
            toks = np.memmap(tok_path, dtype=np.int32, mode="r", shape=shape)
            mask = np.memmap(mask_path, dtype=bool, mode="r", shape=shape)
        else:
            toks = np.zeros(shape, np.int32)
            mask = np.zeros(shape, bool)
        return cls(tokens=toks, mask=mask, chunk=chunk, n_texts=n,
                   backing="mmap", cache_dir=cache_dir, reused=reused,
                   rebuilt_chunks=len(rebuilt))

    @property
    def n_chunks(self) -> int:
        return self.tokens.shape[0]

    def rows_valid(self, ci: int) -> int:
        return min(self.chunk, self.n_texts - ci * self.chunk)

    def chunks(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int,
                                       int]]:
        """Yield (tokens, mask, base_row, n_valid_rows) per chunk, as CPU
        tensors."""
        for ci in range(self.n_chunks):
            yield (torch.from_numpy(np.array(self.tokens[ci])),
                   torch.from_numpy(np.array(self.mask[ci])),
                   ci * self.chunk, self.rows_valid(ci))

    def candidate_map(self, cand_idx: np.ndarray) -> "CandidateMap":
        """Precompute candidate membership against THIS store's chunking.

        ``cand_idx`` is the padded ``(Q, Cmax)`` slot map of global corpus
        rows from :func:`repro_torch.core.retrieval.pad_candidates` (-1 = pad).
        The result is what lets rerank stages touch only the corpus that
        matters: a per-chunk ``(chunk,)`` row-membership mask (is this row
        any query's candidate?) plus per-chunk counts the engine uses to
        skip — never stage, never encode — chunks with zero candidate rows.
        Built once per validator lifetime, like the store itself.
        """
        rows = np.unique(cand_idx[cand_idx >= 0])
        rows = rows[rows < self.n_texts]
        row_mask = np.zeros((self.n_chunks, self.chunk), bool)
        if rows.size and self.n_chunks:
            row_mask[rows // self.chunk, rows % self.chunk] = True
        return CandidateMap(slot_map=np.asarray(cand_idx, np.int32),
                            row_mask=row_mask,
                            chunk_counts=row_mask.sum(axis=1),
                            chunk=self.chunk)


@dataclasses.dataclass
class CandidateMap:
    """Per-chunk candidate membership for the rerank stages (built on the
    TokenStore side, where the chunk geometry lives).

    ``slot_map`` is the ``(Q, Cmax)`` candidate slot map (global
    corpus rows, -1 = pad); ``row_mask[ci]`` is the ``(chunk,)`` mask of
    rows in chunk ``ci`` that appear in ANY query's candidate set; and
    ``chunk_counts[ci]`` is its popcount — zero means the chunk holds no
    candidates and the engine skips it entirely (no staging, no encode).
    """

    slot_map: np.ndarray        # (Q, Cmax) int32 global rows, -1 = pad
    row_mask: np.ndarray        # (n_chunks, chunk) bool candidate membership
    chunk_counts: np.ndarray    # (n_chunks,) int per-chunk candidate rows
    chunk: int

    def has_candidates(self, ci: int) -> bool:
        return bool(self.chunk_counts[ci])



# ---------------------------------------------------------------------------
# Stage 2: host->device staging ahead of compute
# ---------------------------------------------------------------------------


def plan_schedule(n_chunks: int, window: int = 1) -> List[Tuple[int, int]]:
    """Dispatch schedule ``[(first_chunk, n_chunks_in_batch), ...]``.

    ``window`` > 1 groups that many chunks per dispatch with a halving tail
    (the reference's schedule): a corpus of C chunks costs ~C/window +
    log2(window) dispatches."""
    out: List[Tuple[int, int]] = []
    ci, w = 0, max(1, window)
    while ci < n_chunks:
        while w > 1 and ci + w > n_chunks:
            w //= 2
        out.append((ci, w))
        ci += w
    return out


def staged_batches(store: TokenStore, schedule: Sequence[Tuple[int, int]], *,
                   device: torch.device, depth: int = 2, sharding=None
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield ``(tokens, mask)`` on ``device`` for each schedule entry, the
    copies issued ``depth`` batches ahead of the consumer.  An entry
    ``(ci, w)`` with ``w > 1`` is staged as one ``(w, chunk, L)`` copy of
    chunks ``ci .. ci + w - 1``; ``w == 1`` stages the ``(chunk, L)`` chunk.

    On a CUDA device each batch is copied from pinned host memory with a
    ``non_blocking`` copy on a side stream; the consumer's stream (the
    current stream of the thread that iterates, e.g. a validator thread's
    own stream) waits on that copy's event, and ``record_stream`` keeps the
    allocator from reusing the buffer before the consumer is done.
    ``depth=1`` stages each batch just before it is used.  With an
    mmap-backed store only the staged chunks are ever read into host
    memory.  Host staging grows to ``O(depth x w x chunk x L)``.

    ``sharding`` (a :class:`~repro_torch.distributed.sharding.RowsSharding`)
    stages each batch's row blocks straight onto their shards' devices
    instead, and yields :class:`~repro_torch.distributed.sharding.
    ShardedRows`: the layout the sharded stages consume, one chunk per
    entry."""
    depth = max(1, depth)
    copy_streams: Dict[torch.device, torch.cuda.Stream] = {}

    def put(arr: np.ndarray, dev: torch.device):
        # a read-only memmap chunk is read into host memory here
        t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
        if dev.type != "cuda":
            return t, None
        stream = copy_streams.get(dev)
        if stream is None:
            stream = copy_streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            t = t.pin_memory().to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return t, done

    def stage(ci: int, w: int):
        if w > 1:
            if sharding is not None:
                raise ValueError("a sharded stage takes one chunk per step")
            return (put(store.tokens[ci:ci + w], device),
                    put(store.mask[ci:ci + w], device))
        if sharding is None:
            return put(store.tokens[ci], device), put(store.mask[ci], device)
        return ([put(b, d) for b, d in zip(sharding.split(store.tokens[ci]),
                                            sharding.devices)],
                [put(b, d) for b, d in zip(sharding.split(store.mask[ci]),
                                            sharding.devices)])

    def ready(staged) -> torch.Tensor:
        t, done = staged
        if done is not None:
            compute = torch.cuda.current_stream(t.device)
            compute.wait_event(done)
            t.record_stream(compute)
        return t

    q: "collections.deque" = collections.deque()
    idx = 0
    while q or idx < len(schedule):
        while idx < len(schedule) and len(q) < depth:
            q.append(stage(*schedule[idx]))
            idx += 1
        toks, mask = q.popleft()
        if sharding is None:
            yield ready(toks), ready(mask)
        else:
            yield (ShardedRows([ready(t) for t in toks]),
                   ShardedRows([ready(m) for m in mask]))


def encode_store(encode_fn: Callable, params, store: TokenStore, *,
                 device: torch.device, mesh=None,
                 axis_names=None) -> torch.Tensor:
    """Encode a whole TokenStore (the queries) -> (n_texts, D) on device.

    With ``mesh`` each chunk's rows are split over ``axis_names`` (default:
    every mesh axis) and each device encodes the rows of its shards in one
    call, the params replicated there (:func:`device_batches`); the
    embeddings are gathered onto ``device`` in shard order.
    ``store.chunk`` must divide the shard count (``chunk_geometry`` rounds
    the query chunk up to it)."""
    sharding = replicas = None
    if mesh is not None:
        sharding = rows_sharding(mesh, axis_names)
        replicas = replicated_sharding(mesh).put(params)
    outs = []
    for toks, mask in staged_batches(store, plan_schedule(store.n_chunks),
                                     device=device, sharding=sharding):
        if sharding is None:
            outs.append(encode_fn(params, toks, mask))
            continue
        blocks = [None] * len(toks.shards)
        for dev, sids, t, m in device_batches(toks, mask):
            emb = encode_fn(replicas.on(dev), t, m).to(device)
            for j, sid in enumerate(sids):
                blocks[sid] = emb[j * toks.rows:(j + 1) * toks.rows]
        outs.append(torch.cat(blocks))
    if not outs:
        return torch.zeros((0, 1), dtype=torch.float32, device=device)
    return torch.cat(outs, dim=0)[:store.n_texts]


def device_batches(toks: ShardedRows, mask: ShardedRows):
    """The shards of a staged chunk grouped by device: ``(device, shard
    ids, tokens, mask)`` per distinct device, in mesh order, with the rows
    of the device's shards concatenated in shard order.  A device computes
    everything it holds in one encoder call and one score product: on a
    mesh that repeats a device, its shards are one batch, so a one-device
    mesh runs the unsharded products (the encoder's rows do not depend on
    the batch, an f32 product's rounding does depend on its shape), while
    the shard split, the per-shard offsets and the merges stay per
    shard."""
    groups: Dict[torch.device, List[int]] = {}
    for sid, t in enumerate(toks.shards):
        groups.setdefault(t.device, []).append(sid)
    for dev, sids in groups.items():
        if len(sids) == 1:
            yield dev, sids, toks.shards[sids[0]], mask.shards[sids[0]]
        else:
            yield (dev, sids, torch.cat([toks.shards[i] for i in sids]),
                   torch.cat([mask.shards[i] for i in sids]))


# ---------------------------------------------------------------------------
# Stage 3: encode -> fold stages behind one interface
# ---------------------------------------------------------------------------


class Stage:
    """One streaming validation strategy: a device carry folded chunk by chunk.

    ``init(q_emb) -> carry``; ``step(params, q_emb, carry, toks, mask, base,
    n_valid) -> carry``; ``finalize(carry) -> (run, run_scores)``.

    A stage with ``takes_mark`` takes ``mark=`` in ``step`` (and
    ``step_window``): a hook it calls after each chunk's trunk and after
    its fold, where the engine's telemetry marks the device's progress.
    """

    name = "stage"
    takes_mark = False

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
    lower row).

    ``window`` > 1 lets the engine hand the stage a window of chunks per
    dispatch (:meth:`step_window`), staged in one copy.  The window's
    chunks are folded one at a time, in chunk order, through :meth:`step`:
    encoding a whole window in one call would round f32 products at
    another shape, and the results are bit-equal at every window."""

    name = "topk_torch"
    takes_mark = True

    def __init__(self, encode_fn: Callable, *, k: int, query_ids: List[str],
                 doc_ids: List[str], window: int = 8,
                 score_dtype: str = "f32"):
        self.encode_fn = encode_fn
        self.query_ids = query_ids
        self.doc_ids = doc_ids
        self.k = max(1, min(k, len(doc_ids))) if doc_ids else 0
        self.window = max(1, window)
        self.score_dtype = validate_score_dtype(score_dtype)

    def init(self, q_emb):
        Q = q_emb.shape[0]
        return (torch.full((Q, self.k), float("-inf"), device=q_emb.device),
                torch.zeros((Q, self.k), dtype=torch.int32,
                            device=q_emb.device))

    def step(self, params, q_emb, carry, toks, mask, base, n_valid,
             mark=None):
        run_s, run_i = carry
        emb = self.encode_fn(params, toks, mask)               # (chunk, D)
        if mark is not None:
            mark()
        s = chunk_scores(q_emb, emb, self.score_dtype)         # (Q, chunk)
        col = torch.arange(toks.shape[0], dtype=torch.int32,
                           device=s.device)
        s = s.masked_fill((col >= n_valid)[None, :], float("-inf"))
        gcol = (col + base).expand(s.shape[0], -1)
        carry = select_topk(torch.cat([run_s, s], dim=1),
                            torch.cat([run_i, gcol], dim=1), self.k)
        if mark is not None:
            mark()
        return carry

    def step_window(self, params, q_emb, carry, toks_w, mask_w, bases,
                    n_valids, mark=None):
        """Fold a window of chunks, ``toks_w`` / ``mask_w`` ``(w, chunk,
        L)``, one chunk at a time in chunk order."""
        for toks, mask, base, n_valid in zip(toks_w, mask_w, bases,
                                             n_valids):
            carry = self.step(params, q_emb, carry, toks, mask, int(base),
                              int(n_valid), mark)
        return carry

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
    version.  Every chunk goes through the kernel: ``window`` is 1, as the
    reference builds its Pallas stage."""

    name = "topk_cuda"

    def __init__(self, encode_fn: Callable, *, k: int, query_ids: List[str],
                 doc_ids: List[str], score_dtype: str = "f32"):
        super().__init__(encode_fn, k=k, query_ids=query_ids,
                         doc_ids=doc_ids, window=1, score_dtype=score_dtype)

    def step(self, params, q_emb, carry, toks, mask, base, n_valid,
             mark=None):
        emb = self.encode_fn(params, toks, mask)
        if mark is not None:
            mark()
        run_s, run_i = carry
        carry = mips_ops.topk_mips_chunk(q_emb, emb, run_s, run_i, base=base,
                                         n_valid=n_valid,
                                         score_dtype=self.score_dtype)
        if mark is not None:
            mark()
        return carry


class StreamRerankStage(Stage):
    """Rerank / average-rank modes: the carry is the padded per-query
    candidate score matrix (Q, Cmax); each chunk's scores are gathered into
    it where the candidates' global rows fall inside the chunk.

    With a ``store`` the stage precomputes a :class:`CandidateMap`, so the
    engine skips chunks with no candidate row (:meth:`wants_chunk`) and a
    step masks the rows no query names to ``-inf`` before the gather (the
    gather only reads member rows, so the carry is what an unmasked step
    gives).  ``compact=True`` packs the candidate rows into dense
    pseudo-chunks (:meth:`_pack_candidates`) when that at least halves the
    chunks to encode; the engine then streams ``store_override``.
    Finalization is :func:`repro_torch.core.retrieval.rank_candidates`,
    the stable selection the materialized ``rerank_run`` uses too, so both
    engines give the same run from the same score matrix."""

    name = "rerank"

    def __init__(self, encode_fn: Callable, *, k: int, query_ids: List[str],
                 doc_ids: List[str], per_query: Dict[str, List[str]],
                 store: Optional[TokenStore] = None,
                 score_dtype: str = "f32", compact: bool = False):
        self.encode_fn = encode_fn
        self.query_ids = query_ids
        self.k = k
        self.score_dtype = validate_score_dtype(score_dtype)
        cand_idx, self.cands = pad_candidates(query_ids, doc_ids, per_query)
        self.cmap = store.candidate_map(cand_idx) \
            if store is not None and store.n_chunks else None
        self.store_override: Optional[TokenStore] = None
        if compact and self.cmap is not None:
            packed = self._pack_candidates(store, cand_idx)
            if packed is not None:
                cand_idx, self.store_override = packed
                self.cmap = self.store_override.candidate_map(cand_idx)
        self.cand_idx = cand_idx
        self._device_cache: Dict[tuple, torch.Tensor] = {}

    @staticmethod
    def _pack_candidates(store: TokenStore, cand_idx: np.ndarray):
        """Pack candidate token rows into dense pseudo-chunks.

        Returns ``(remapped_cand_idx, compact_store)``, or ``None`` when the
        compacted store would need more than half the chunks the
        chunk-skipping schedule already encodes.  Costs one host gather of
        O(candidate rows x L) tokens, once per stage."""
        rows = np.unique(cand_idx[cand_idx >= 0])
        rows = rows[rows < store.n_texts]
        if not rows.size or not store.n_chunks:
            return None
        row_mask = np.zeros((store.n_chunks, store.chunk), bool)
        row_mask[rows // store.chunk, rows % store.chunk] = True
        surviving = int((row_mask.any(axis=1)).sum())
        n_compact = -(-int(rows.size) // store.chunk)
        if n_compact * 2 > surviving:
            return None
        L = store.tokens.shape[2]
        flat_t = store.tokens.reshape(store.n_chunks * store.chunk, L)
        flat_m = store.mask.reshape(store.n_chunks * store.chunk, L)
        toks = np.zeros((n_compact, store.chunk, L), np.int32)
        mask = np.zeros((n_compact, store.chunk, L), bool)
        toks.reshape(-1, L)[:rows.size] = flat_t[rows]   # memmap-safe copy
        mask.reshape(-1, L)[:rows.size] = flat_m[rows]
        compact = TokenStore(tokens=toks, mask=mask, chunk=store.chunk,
                             n_texts=int(rows.size))
        remapped = np.where(
            cand_idx >= 0,
            np.searchsorted(rows, np.clip(cand_idx, 0, None))
            .astype(np.int32),
            np.int32(-1))
        return np.asarray(remapped, np.int32), compact

    def wants_chunk(self, ci: int) -> bool:
        """False for chunks holding no candidate row: the engine neither
        stages nor encodes them (such a chunk writes no slot)."""
        return self.cmap is None or self.cmap.has_candidates(ci)

    def _on_device(self, key, host: np.ndarray,
                   device: torch.device) -> torch.Tensor:
        t = self._device_cache.get((key, device))
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(host)).to(device)
            self._device_cache[(key, device)] = t
        return t

    def _row_mask(self, ci: int, chunk: int,
                  device: torch.device) -> torch.Tensor:
        """Device-cached (chunk,) membership mask of chunk ``ci`` (all True
        when the stage was built without a store)."""
        if self.cmap is None:
            return self._on_device("all", np.ones((chunk,), bool), device)
        return self._on_device(("rows", ci), self.cmap.row_mask[ci], device)

    def init(self, q_emb):
        return torch.full((q_emb.shape[0], self.cand_idx.shape[1]),
                          float("-inf"), device=q_emb.device)

    def step(self, params, q_emb, carry, toks, mask, base, n_valid):
        chunk = toks.shape[0]
        ci = base // (self.cmap.chunk if self.cmap is not None
                      else max(chunk, 1))
        emb = self.encode_fn(params, toks, mask)               # (chunk, D)
        s = chunk_scores(q_emb, emb, self.score_dtype)         # (Q, chunk)
        s = s.masked_fill(~self._row_mask(ci, chunk, s.device)[None, :],
                          float("-inf"))
        cand_idx = self._on_device("cand_idx", self.cand_idx, s.device)
        local = cand_idx - base
        hit = (cand_idx >= 0) & (local >= 0) & (local < n_valid)
        g = torch.gather(s, 1, local.clamp(0, chunk - 1).long())
        return torch.where(hit, g, carry)

    def finalize(self, carry):
        return rank_candidates(self.query_ids, carry, self.cands, k=self.k)


class _MeshOperands:
    """The mesh-invariant operands of a sharded step, the params and the
    query matrix, on every device of the mesh: placed once per run (the
    engine hands every step of a run the same two objects) and dropped at
    ``finalize``."""

    def __init__(self, mesh):
        self._place = replicated_sharding(mesh)
        self._key: Optional[tuple] = None
        self._copies: Optional[tuple] = None

    def get(self, params, q_emb):
        if self._key is None or self._key[0] is not params \
                or self._key[1] is not q_emb:
            self._key = (params, q_emb)
            self._copies = (self._place.put(params), self._place.put(q_emb))
        return self._copies

    def clear(self) -> None:
        self._key = self._copies = None


class ShardedStreamTopKStage(StreamTopKStage):
    """Retrieval mode on the validator mesh: each chunk's rows are split
    over ``axis_names`` (the engine stages them so, ``input_sharding``);
    each device encodes and scores the rows of its shards
    (:func:`device_batches`), every shard takes the top k of its rows, the
    shards' candidates merge one mesh axis at a time, innermost first
    (:func:`~repro_torch.core.retrieval._hierarchical_topk_merge`, as
    :func:`~repro_torch.core.retrieval.topk_sharded` merges), and the merge
    into the carry happens on the mesh's first device.  Every selection is
    stable, so the carry equals the unsharded stage's wherever the shards'
    scores equal its own: bit for bit on a one-device mesh."""

    name = "topk_sharded"
    takes_mark = False         # a chunk's trunk and fold interleave by device

    def __init__(self, encode_fn: Callable, mesh, *, k: int,
                 query_ids: List[str], doc_ids: List[str],
                 axis_names=None, score_dtype: str = "f32"):
        # window=1: every sharded chunk goes through the mesh step below
        super().__init__(encode_fn, k=k, query_ids=query_ids,
                         doc_ids=doc_ids, window=1, score_dtype=score_dtype)
        self.axis_names = tuple(axis_names or mesh.axis_names)
        self.input_sharding = rows_sharding(mesh, self.axis_names)
        self._sizes = [mesh.shape[a] for a in self.axis_names]
        self._operands = _MeshOperands(mesh)

    def step(self, params, q_emb, carry, toks, mask, base, n_valid):
        run_s, run_i = carry
        p_on, q_on = self._operands.get(params, q_emb)
        rows = toks.rows
        parts: List[Optional[tuple]] = [None] * len(toks.shards)
        for dev, sids, t, m in device_batches(toks, mask):
            emb = self.encode_fn(p_on.on(dev), t, m)      # (rows x shards, D)
            # per-row quantization: a shard's narrow-dtype scores equal the
            # unsharded stage's slice
            s_dev = chunk_scores(q_on.on(dev), emb, self.score_dtype)
            for j, sid in enumerate(sids):
                s = s_dev[:, j * rows:(j + 1) * rows]
                col = sid * rows + torch.arange(rows, dtype=torch.int32,
                                                device=dev)
                s = s.masked_fill((col >= n_valid)[None, :], float("-inf"))
                bs, bi = select_topk(s, col.expand(s.shape[0], -1),
                                     min(self.k, rows))
                parts[sid] = (bs, bi + base)
        bs, bi = _hierarchical_topk_merge(parts, self._sizes, self.k)
        return select_topk(torch.cat([run_s, bs.to(run_s.device)], dim=1),
                           torch.cat([run_i, bi.to(run_i.device)], dim=1),
                           self.k)

    def finalize(self, carry):
        self._operands.clear()
        return super().finalize(carry)


class ShardedStreamRerankStage(StreamRerankStage):
    """Rerank / average-rank modes on the validator mesh, mirroring
    :class:`ShardedStreamTopKStage`: each device encodes and scores the
    rows of its shards, and every shard masks its candidate-member rows and
    writes them into its view of the ``(Q, Cmax)`` slot carry.  Each slot names one corpus row, which
    lies on one shard of one chunk, so the cross-shard merge is an
    elementwise max per mesh axis, innermost first (:func:`~repro_torch.
    core.retrieval._hierarchical_slot_max`): the written score where a
    shard hit, the carry everywhere else.  Carry, finalize and chunk
    skipping are the unsharded stage's, so the runs are its runs bit for
    bit."""

    name = "rerank_sharded"

    def __init__(self, encode_fn: Callable, mesh, *, k: int,
                 query_ids: List[str], doc_ids: List[str],
                 per_query: Dict[str, List[str]],
                 store: Optional[TokenStore] = None, axis_names=None,
                 score_dtype: str = "f32", compact: bool = False):
        super().__init__(encode_fn, k=k, query_ids=query_ids,
                         doc_ids=doc_ids, per_query=per_query, store=store,
                         score_dtype=score_dtype, compact=compact)
        self.axis_names = tuple(axis_names or mesh.axis_names)
        self.input_sharding = rows_sharding(mesh, self.axis_names)
        self._sizes = [mesh.shape[a] for a in self.axis_names]
        self._operands = _MeshOperands(mesh)

    def step(self, params, q_emb, carry, toks, mask, base, n_valid):
        rows = toks.rows
        chunk = rows * len(toks.shards)
        ci = base // (self.cmap.chunk if self.cmap is not None
                      else max(chunk, 1))
        host_mask = self.cmap.row_mask[ci] if self.cmap is not None \
            else np.ones((chunk,), bool)
        p_on, q_on = self._operands.get(params, q_emb)
        parts: List[Optional[torch.Tensor]] = [None] * len(toks.shards)
        for dev, sids, t, m in device_batches(toks, mask):
            emb = self.encode_fn(p_on.on(dev), t, m)
            s_dev = chunk_scores(q_on.on(dev), emb, self.score_dtype)
            cand_idx = self._on_device("cand_idx", self.cand_idx, dev)
            for j, sid in enumerate(sids):
                s = s_dev[:, j * rows:(j + 1) * rows]
                col = sid * rows + torch.arange(rows, device=dev)
                keep = self._on_device(
                    ("rows", ci if self.cmap is not None else -1, sid),
                    host_mask[sid * rows:(sid + 1) * rows], dev) \
                    & (col < n_valid)
                s = s.masked_fill(~keep[None, :], float("-inf"))
                pos = cand_idx - base - sid * rows           # shard-local
                hit = (cand_idx >= 0) & (cand_idx - base < n_valid) \
                    & (pos >= 0) & (pos < rows)
                g = torch.gather(s, 1, pos.clamp(0, rows - 1).long())
                parts[sid] = torch.where(hit, g, carry.to(dev))
        return _hierarchical_slot_max(parts, self._sizes).to(carry.device)

    def finalize(self, carry):
        self._operands.clear()
        return super().finalize(carry)


# ---------------------------------------------------------------------------
# Registry wiring: modes route to impls route to stage names
# ---------------------------------------------------------------------------


@register_impl("torch")
def _route_impl_torch(*, mesh=None) -> str:
    return "topk_sharded" if mesh is not None else "topk_torch"


@register_impl("cuda")
def _route_impl_cuda(*, mesh=None) -> str:
    # the topk_mips chunk-carry kernel is single-device: a mesh does not
    # override it (mesh users pick impl="torch", the sharded path)
    return "topk_cuda"


@register_mode("retrieval")
def _route_mode_retrieval(*, impl: str, mesh=None, per_query=None) -> str:
    return IMPLS.get(impl)(mesh=mesh)


@register_mode("rerank")
@register_mode("average_rank")
def _route_mode_rerank(*, impl: str, mesh=None, per_query=None) -> str:
    if not per_query:           # no candidate lists -> plain retrieval path
        return IMPLS.get(impl)(mesh=mesh)
    return "rerank_sharded" if mesh is not None else "rerank"


@register_stage("topk_torch")
def _stage_topk_torch(encode_fn, *, k, query_ids, doc_ids, scan_window=8,
                      per_query=None, mesh=None, store=None,
                      score_dtype="f32", rerank_compact=False) -> Stage:
    return StreamTopKStage(encode_fn, k=k, query_ids=query_ids,
                           doc_ids=doc_ids, window=scan_window,
                           score_dtype=score_dtype)


@register_stage("topk_cuda")
def _stage_topk_cuda(encode_fn, *, k, query_ids, doc_ids, scan_window=8,
                     per_query=None, mesh=None, store=None,
                     score_dtype="f32", rerank_compact=False) -> Stage:
    return CudaStreamTopKStage(encode_fn, k=k, query_ids=query_ids,
                               doc_ids=doc_ids, score_dtype=score_dtype)


@register_stage("topk_sharded")
def _stage_topk_sharded(encode_fn, *, k, query_ids, doc_ids, scan_window=8,
                        per_query=None, mesh=None, store=None,
                        score_dtype="f32", rerank_compact=False) -> Stage:
    return ShardedStreamTopKStage(encode_fn, mesh, k=k, query_ids=query_ids,
                                  doc_ids=doc_ids, score_dtype=score_dtype)


@register_stage("rerank")
def _stage_rerank(encode_fn, *, k, query_ids, doc_ids, scan_window=8,
                  per_query=None, mesh=None, store=None, score_dtype="f32",
                  rerank_compact=True) -> Stage:
    return StreamRerankStage(encode_fn, k=max(k, 1000), query_ids=query_ids,
                             doc_ids=doc_ids, per_query=per_query,
                             store=store, score_dtype=score_dtype,
                             compact=rerank_compact)


@register_stage("rerank_sharded")
def _stage_rerank_sharded(encode_fn, *, k, query_ids, doc_ids,
                          scan_window=8, per_query=None, mesh=None,
                          store=None, score_dtype="f32",
                          rerank_compact=True) -> Stage:
    return ShardedStreamRerankStage(encode_fn, mesh, k=max(k, 1000),
                                    query_ids=query_ids, doc_ids=doc_ids,
                                    per_query=per_query, store=store,
                                    score_dtype=score_dtype,
                                    compact=rerank_compact)


def make_stage(encode_fn: Callable, *, mode: str, impl: str, k: int,
               query_ids: List[str], doc_ids: List[str],
               per_query: Optional[Dict[str, List[str]]] = None,
               mesh=None, scan_window: int = 8,
               store: Optional[TokenStore] = None,
               score_dtype: str = "f32",
               rerank_compact: bool = True) -> Stage:
    """Route (mode, impl, mesh) to a registered Stage: the ``mode`` route
    picks a stage name (through the ``impl`` route for retrieval, and for
    rerank modes without candidate lists), the name a stage factory.  A
    ``mesh`` (:class:`~repro_torch.distributed.compat.DeviceMesh`) routes
    ``impl="torch"`` retrieval to ``topk_sharded`` and the rerank modes to
    ``rerank_sharded``; ``impl="cuda"`` stays on the single-device kernel.
    ``scan_window`` is the chunks per dispatch of the ``topk_torch`` stage;
    the other stages take one chunk per step.
    ``store``, the corpus TokenStore, lets the rerank stages skip
    candidate-free chunks (and, with ``rerank_compact``, pack sparse
    candidate rows).  Unknown names raise listing the registered
    alternatives."""
    name = MODES.get(mode)(impl=impl, mesh=mesh, per_query=per_query)
    return STAGES.get(name)(encode_fn, k=k, query_ids=query_ids,
                            doc_ids=doc_ids, scan_window=scan_window,
                            per_query=per_query, mesh=mesh, store=store,
                            score_dtype=score_dtype,
                            rerank_compact=rerank_compact)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


class StreamingEngine:
    """Drive a Stage over a TokenStore: peak embedding memory is
    O(chunk x D + Q x k); ``staging_depth`` batches are staged ahead.
    Stages with ``wants_chunk`` (rerank) prune the schedule before staging,
    so skipped chunks are never read off the store.  A stage with an
    ``input_sharding`` (the sharded stages) gets its chunks staged shard by
    shard; ``query_mesh`` shards the query encoding the same way."""

    name = "streaming"

    def __init__(self, spec, doc_store: TokenStore, query_store: TokenStore,
                 stage: Stage, *, staging: str = "double_buffered",
                 staging_depth: int = 2, query_mesh=None,
                 query_axis_names=None, telemetry=None):
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
        self.query_mesh = query_mesh
        self.query_axis_names = query_axis_names
        # nullable repro_torch.obs.Telemetry: observation only
        self.telemetry = telemetry

    @property
    def score_dtype(self) -> str:
        return getattr(self.stage, "score_dtype", "f32")

    def _synchronize(self, device: torch.device) -> None:
        """:func:`synchronize` on ``device`` and on every mesh device."""
        devices = [device] + (self.query_mesh.distinct_devices()
                              if self.query_mesh is not None else [])
        for dev in dict.fromkeys(devices):
            synchronize(dev)

    @torch.inference_mode()
    def run(self, params) -> Tuple[Run, Scores, Dict[str, float]]:
        tel = self.telemetry
        device = self.spec.device
        if tel is None:
            params = to_torch_tree(params, device)
        else:
            m0 = time.monotonic()
            params = to_torch_tree(params, device)
            tel.record("uploaded", m0, time.monotonic() - m0)
        t0 = time.time()
        m0 = time.monotonic() if tel is not None else 0.0
        q_emb = encode_store(self.spec.encode_query, params, self.query_store,
                             device=device, mesh=self.query_mesh,
                             axis_names=self.query_axis_names)
        self._synchronize(device)
        t_query = time.time() - t0
        clock = None
        if tel is not None:
            tel.record("encoded", m0, t_query, role="query")
            # the stream is idle here: the anchor's event runs at once
            clock = DeviceClock(device)
            clock.anchor()

        t0 = time.time()
        m_stream = time.monotonic() if tel is not None else 0.0
        # a compacting rerank stage streams its own packed store
        store = getattr(self.stage, "store_override", None) or self.doc_store
        carry = self.stage.init(q_emb)
        window = getattr(self.stage, "window", 1)
        use_window = window > 1 and hasattr(self.stage, "step_window")
        schedule = plan_schedule(store.n_chunks, window if use_window else 1)
        # a rerank stage drops chunks with no candidate row before staging
        wants = getattr(self.stage, "wants_chunk", None)
        if wants is not None:
            schedule = [(ci, w) for ci, w in schedule if wants(ci)]
        batches = staged_batches(
            store, schedule, device=device,
            depth=1 if self.staging == "sync" else self.staging_depth,
            sharding=getattr(self.stage, "input_sharding", None))
        # with telemetry: per schedule entry, the host interval of the wait
        # for its staged batch, and (host reading, device mark) pairs at its
        # start and, through the stage's hook, after each chunk's trunk and
        # fold (else at its end); read once the stream is synchronized below
        traced: List[tuple] = []
        split = tel is not None and getattr(self.stage, "takes_mark", False)
        kw: Dict[str, Callable] = {}

        def mark_now(marks):
            marks.append((time.monotonic(), clock.mark()))

        for ci, w in schedule:
            if tel is not None:
                h0 = time.monotonic()
            toks, mask = next(batches)
            if tel is not None:
                h1 = time.monotonic()
                marks = [(h1, clock.mark())]
                if split:
                    kw["mark"] = lambda marks=marks: mark_now(marks)
            if w > 1:
                bases = [store.chunk * j for j in range(ci, ci + w)]
                n_valids = [store.rows_valid(j) for j in range(ci, ci + w)]
                carry = self.stage.step_window(params, q_emb, carry, toks,
                                               mask, bases, n_valids, **kw)
            else:
                carry = self.stage.step(params, q_emb, carry, toks, mask,
                                        store.chunk * ci,
                                        store.rows_valid(ci), **kw)
            if tel is not None:
                if not split:
                    mark_now(marks)
                traced.append((ci, w, h0, h1, marks))
        self._synchronize(device)
        t_stream = time.time() - t0
        if tel is not None:
            self._record_chunks(tel, clock, traced, split, m_stream, t_stream)

        t0 = time.time()
        run, scores = self.stage.finalize(carry)
        t_final = time.time() - t0
        # the reference's key names: encode_corpus_s is the fused
        # encode-and-fold loop, retrieve_s the host-side finalize
        timings = {"encode_corpus_s": t_stream, "encode_query_s": t_query,
                   "retrieve_s": t_final,
                   "total_s": t_query + t_stream + t_final}
        return run, scores, timings

    def _record_chunks(self, tel, clock: DeviceClock, traced, split: bool,
                       m_stream: float, t_stream: float) -> None:
        """The spans of one encode-and-fold loop, its device work complete:
        the loop (``encoded``, ``role="corpus"``, the interval of
        ``encode_corpus_s``), a ``staged`` span per schedule entry and a
        ``chunk`` span per chunk (its host interval from its first mark to
        its last), whose ``dev_t0`` / ``dev_s`` is the chunk's device
        interval and, where the stage marks its fold, ``trunk_s`` /
        ``fold_s`` its two parts."""
        tel.record("encoded", m_stream, t_stream, role="corpus",
                   n_chunks=sum(w for _, w, *_ in traced))
        wait = 0.0
        for ci, w, h0, h1, marks in traced:
            wait += h1 - h0
            tel.record("staged", h0, h1 - h0, chunk=ci, n=w,
                       staging=self.staging)
            host = [h for h, _ in marks]
            dev = [clock.resolve(m) for _, m in marks]
            for j in range(w):
                # a chunk's marks: its start, then after its trunk and fold
                a, c = (2 * j, 2 * j + 2) if split else (0, -1)
                parts = {"trunk_s": dev[a + 1] - dev[a],
                         "fold_s": dev[c] - dev[a + 1]} if split else {}
                tel.record("chunk", host[a], host[c] - host[a],
                           chunk=ci + j, dev_t0=dev[a],
                           dev_s=dev[c] - dev[a], **parts)
        tel.metrics.histogram("engine.staging_wait_s").observe(wait)


class MaterializedEngine:
    """Encode everything, then retrieve or rerank: the reference's legacy
    path behind the same engine interface, kept for A/B runs against the
    streaming engine.

    The ``(N, D)`` corpus embeddings stay on the device: bf16-resident
    under ``score_dtype="bf16"`` (half the memory; the kernels and the
    rerank path read the bf16 values as they are), f32 otherwise, int8
    quantized at score time.  Each phase ends with a device synchronise
    before its clock is read."""

    name = "materialized"

    def __init__(self, spec, doc_texts: List[Tokens], query_texts: List[Tokens],
                 *, mode: str, k: int, impl: str, batch_size: int,
                 query_ids: List[str], doc_ids: List[str],
                 per_query: Optional[Dict[str, List[str]]] = None, mesh=None,
                 rerank_block: Optional[int] = None,
                 score_dtype: str = "f32", telemetry=None):
        self.telemetry = telemetry
        self.spec = spec
        self.doc_texts = doc_texts
        self.query_texts = query_texts
        self.mode = mode
        self.k = k
        self.impl = impl
        self.batch_size = batch_size
        self.query_ids = query_ids
        self.doc_ids = doc_ids
        self.per_query = per_query
        self.mesh = mesh
        # queries per rerank candidate gather (None = sized from
        # rerank_run's memory budget)
        self.rerank_block = rerank_block
        self.score_dtype = validate_score_dtype(score_dtype)

    @torch.inference_mode()
    def run(self, params) -> Tuple[Run, Scores, Dict[str, float]]:
        tel = self.telemetry
        device = self.spec.device
        params = to_torch_tree(params, device)
        t0 = time.time()
        m0 = time.monotonic() if tel is not None else 0.0
        c_emb, _ = encode_tensor(self.spec.encode_passage, params,
                                 self.doc_texts, max_len=self.spec.p_max_len,
                                 batch_size=self.batch_size, device=device)
        if self.score_dtype == "bf16":
            c_emb = c_emb.to(torch.bfloat16)
        synchronize(device)
        t_corpus = time.time() - t0
        if tel is not None:
            tel.record("encoded", m0, t_corpus, role="corpus")
        t0 = time.time()
        m0 = time.monotonic() if tel is not None else 0.0
        q_emb, _ = encode_tensor(self.spec.encode_query, params,
                                 self.query_texts, max_len=self.spec.q_max_len,
                                 batch_size=self.batch_size, device=device)
        synchronize(device)
        t_query = time.time() - t0
        if tel is not None:
            tel.record("encoded", m0, t_query, role="query")

        t0 = time.time()
        if self.mode in ("rerank", "average_rank") and self.per_query:
            run, scores = rerank_run(self.query_ids, q_emb, self.doc_ids,
                                     c_emb, self.per_query,
                                     k=max(self.k, 1000),
                                     q_block=self.rerank_block,
                                     score_dtype=self.score_dtype)
        else:
            run, scores = retrieve_run(self.query_ids, q_emb, self.doc_ids,
                                       c_emb, k=self.k, impl=self.impl,
                                       mesh=self.mesh,
                                       score_dtype=self.score_dtype)
        synchronize(device)
        t_retrieve = time.time() - t0
        timings = {"encode_corpus_s": t_corpus, "encode_query_s": t_query,
                   "retrieve_s": t_retrieve,
                   "total_s": t_corpus + t_query + t_retrieve}
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


def chunk_geometry(vcfg, n_docs: int, mesh=None) -> Tuple[int, int]:
    """(corpus chunk rows, query chunk rows): ``chunk_size`` defaults to
    ``batch_size``.  With a mesh both are rounded up to a multiple of the
    shard count, so every shard sees equal fixed-shape rows, in every
    mode."""
    chunk = vcfg.chunk_size or vcfg.batch_size
    chunk = max(1, min(chunk, max(n_docs, 1)))
    q_chunk = max(1, vcfg.batch_size)
    if mesh is not None:
        n_shards = mesh.devices.size
        chunk = -(-chunk // n_shards) * n_shards
        q_chunk = -(-q_chunk // n_shards) * n_shards
    return chunk, q_chunk


def doc_cache_dir(mmap_dir: Optional[str], index: int = 0) -> Optional[str]:
    """Cache subdirectory of the ``index``-th distinct corpus TokenStore
    under ``mmap_dir``: ``corpus_tokens`` for the first (the reference's
    name, so either package reuses the other's cache), numbered siblings
    after it."""
    if not mmap_dir:
        return None
    name = "corpus_tokens" if index == 0 else f"corpus_tokens_{index}"
    return os.path.join(mmap_dir, name)


@register_engine("streaming")
def make_streaming_engine(spec, store: ValidationStore, vcfg):
    """The default encode->fold data path (see module docstring)."""
    mesh = vcfg.mesh
    chunk, q_chunk = chunk_geometry(vcfg, len(store.doc_texts), mesh)
    tel = vcfg.telemetry
    doc_store = store.doc_store
    if doc_store is None:
        if vcfg.token_backing == "mmap" and not vcfg.mmap_dir:
            raise ValueError("token_backing='mmap' needs mmap_dir")
        if tel is not None:
            t0 = time.monotonic()
        doc_store = TokenStore.build(
            store.doc_texts, max_len=spec.p_max_len, chunk=chunk,
            backing=vcfg.token_backing,
            cache_dir=doc_cache_dir(vcfg.mmap_dir),
            fingerprint=vcfg.token_fingerprint)
        if tel is not None:
            tel.record("store_build", t0, time.monotonic() - t0,
                       n_docs=len(store.doc_texts),
                       backing=vcfg.token_backing)
    query_store = store.query_store
    if query_store is None:
        query_store = TokenStore.build(store.query_texts,
                                       max_len=spec.q_max_len, chunk=q_chunk)
    stage = make_stage(spec.encode_passage, mode=vcfg.mode, impl=vcfg.impl,
                       k=vcfg.k, query_ids=store.query_ids,
                       doc_ids=store.doc_ids, per_query=store.per_query,
                       mesh=mesh, scan_window=vcfg.scan_window,
                       store=doc_store, score_dtype=vcfg.score_dtype,
                       rerank_compact=vcfg.rerank_compact)
    return StreamingEngine(spec, doc_store, query_store, stage,
                           staging=vcfg.staging,
                           staging_depth=vcfg.staging_depth, query_mesh=mesh,
                           telemetry=tel)


# the suite routes the corpus TokenStore through its shared cache for every
# factory carrying this attribute
make_streaming_engine.uses_token_stores = True


@register_engine("materialized")
def make_materialized_engine(spec, store: ValidationStore, vcfg):
    """The encode-all-then-retrieve path, for A/B runs."""
    return MaterializedEngine(spec, store.doc_texts, store.query_texts,
                              mode=vcfg.mode, k=vcfg.k, impl=vcfg.impl,
                              batch_size=vcfg.batch_size,
                              query_ids=store.query_ids,
                              doc_ids=store.doc_ids,
                              per_query=store.per_query, mesh=vcfg.mesh,
                              rerank_block=vcfg.rerank_block,
                              score_dtype=vcfg.score_dtype,
                              telemetry=vcfg.telemetry)


def make_engine(spec, store: ValidationStore, vcfg):
    """Build the engine a :class:`~repro_torch.core.suite.ValidationConfig`
    asks for, through the :data:`~repro_torch.core.registry.ENGINES`
    registry."""
    MODES.get(vcfg.mode)
    IMPLS.get(vcfg.impl)
    return ENGINES.get(vcfg.engine)(spec, store, vcfg)
