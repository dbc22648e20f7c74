"""Cross-process snapshot spill — mmap-able, torn-write-safe, numpy-only
(``repro/handoff/spool.py``).

The in-process :class:`~repro_torch.handoff.channel.SnapshotChannel` hands
Python object references to a validator thread; a validator in another
process needs a filesystem representation instead.  The spool writes one
directory per snapshot (point ``root`` at ``/dev/shm/...`` to keep the
spill in RAM), in the reference's layout, so a spool written by either
package is read by the other::

    <root>/snap_0000001000/
        arrays/00000.npy …   # one .npy per pytree leaf (treedef order)
        manifest.json        # step, treedef proto hex, per-leaf dtype
        COMMIT               # written LAST — readers ignore dirs without it
    <root>/announce.jsonl    # {"kind": "snapshot"|"retired", "step": N}

Torn-write safety reuses the checkpoint layer's two-phase commit (tmp dir +
fsync + rename + COMMIT marker: a trainer killed mid-spill leaves a
snapshot no reader will ever claim), and the announce log goes through
:func:`repro_torch.core.jsonl.append_jsonl_atomic`, so a torn announce line
is dropped, never glued.

bf16 leaves are written as ``uint16`` arrays with ``"bfloat16"`` in the
manifest (the reference reads them through ``ml_dtypes``); the reference
writes them as 2-byte void records with the same name, which :meth:`load`
views as ``uint16``.  Readers map leaves with ``np.load(mmap_mode="r")``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Set

import numpy as np

from repro_torch.core.jsonl import append_jsonl_atomic, read_jsonl_tolerant

COMMIT_MARKER = "COMMIT"
SNAP_PREFIX = "snap_"
ANNOUNCE_LOG = "announce.jsonl"


def _snap_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{SNAP_PREFIX}{step:010d}")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SnapshotSpool:
    """Commit-marker snapshot directories plus an announce log, under one
    root.  One writer (the trainer's hand-off channel), many readers
    (validators in other processes, a poller's :meth:`poll`)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.announce_path = os.path.join(root, ANNOUNCE_LOG)
        self._polled: Set[int] = set()      # steps this handle announced
        self._pending: List[int] = []       # consumer surface: unclaimed

    # -- writer side ---------------------------------------------------------
    def publish(self, step: int, leaves: List[np.ndarray], treedef_hex: str,
                extra: Optional[dict] = None,
                dtypes: Optional[List[str]] = None) -> str:
        """Two-phase spill: arrays + manifest into a tmp dir, fsync, rename,
        COMMIT marker last — then announce.  A crash at ANY point leaves
        either an ignorable uncommitted dir or a complete snapshot.
        ``dtypes`` names each leaf's dtype in the manifest (``"bfloat16"``
        for a ``uint16`` view); ``None`` names each array's own."""
        final = _snap_dir(self.root, step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        arrays_dir = os.path.join(tmp, "arrays")
        os.makedirs(arrays_dir)
        manifest = {"step": int(step), "treedef": treedef_hex,
                    "leaves": [], "extra": extra or {}}
        for i, arr in enumerate(leaves):
            arr = np.asarray(arr)
            with open(os.path.join(arrays_dir, f"{i:05d}.npy"), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append({
                "shape": list(arr.shape),
                "dtype": dtypes[i] if dtypes is not None
                else str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):           # idempotent re-publish
            shutil.rmtree(final)
        os.rename(tmp, final)
        cpath = os.path.join(final, COMMIT_MARKER)
        with open(cpath, "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(final)
        append_jsonl_atomic(self.announce_path,
                            [{"kind": "snapshot", "step": int(step)}])
        return final

    def retire(self, step: int) -> None:
        """Delete a snapshot no longer needed (validated + durable, dropped
        by backpressure, or failed).  Announced so pollers converge."""
        shutil.rmtree(_snap_dir(self.root, step), ignore_errors=True)
        append_jsonl_atomic(self.announce_path,
                            [{"kind": "retired", "step": int(step)}])

    # -- reader side ---------------------------------------------------------
    def has(self, step: int) -> bool:
        """True iff ``step``'s snapshot is fully committed (COMMIT marker
        present) — a torn spill is invisible, by construction."""
        return os.path.exists(os.path.join(_snap_dir(self.root, step),
                                           COMMIT_MARKER))

    def steps(self) -> List[int]:
        """Committed snapshot steps, ascending (directory scan — the
        markers, not the announce log, are the claim authority)."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if not name.startswith(SNAP_PREFIX) or name.endswith(".tmp"):
                continue
            try:
                step = int(name[len(SNAP_PREFIX):])
            except ValueError:
                continue
            if self.has(step):
                out.append(step)
        return sorted(out)

    def poll(self) -> List[int]:
        """Newly announced-and-committed steps since the last poll on this
        handle — a poller's discovery feed.  Tolerates a torn final
        announce line (dropped; the step surfaces on a later poll once the
        announce is re-appended or via the durable watcher path)."""
        if not os.path.exists(self.announce_path):
            return []
        rows, _ = read_jsonl_tolerant(self.announce_path, kind="announce")
        retired = {int(r["step"]) for r in rows if r.get("kind") == "retired"}
        fresh = []
        for r in rows:
            if r.get("kind") != "snapshot":
                continue
            step = int(r["step"])
            if step in self._polled or step in retired:
                continue
            if self.has(step):          # marker authority: skip torn spills
                self._polled.add(step)
                fresh.append(step)
        return fresh

    def load(self, step: int):
        """``(leaves, treedef_hex, extra, dtypes)`` with leaves mmap'd
        read-only (a bf16 leaf as a ``uint16`` view, named ``"bfloat16"``
        in ``dtypes``).  Returns ``None`` when the snapshot is absent or
        uncommitted."""
        path = _snap_dir(self.root, step)
        if not self.has(step):
            return None
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, dtypes = [], []
        for i, meta in enumerate(manifest["leaves"]):
            arr = np.load(os.path.join(path, "arrays", f"{i:05d}.npy"),
                          mmap_mode="r")
            want = meta["dtype"]
            if want == "bfloat16" and arr.dtype.itemsize == 2:
                arr = arr.view(np.uint16)
            elif str(arr.dtype) != want:
                raise ValueError(f"{path}: leaf {i} is named {want} in the "
                                 f"manifest but holds {arr.dtype}")
            leaves.append(arr)
            dtypes.append(want)
        return leaves, manifest["treedef"], manifest.get("extra", {}), dtypes

    def get(self, step: int):
        """The :class:`~repro_torch.handoff.snapshot.ParamSnapshot` for
        ``step`` backed by mmap'd leaves, or ``None`` (mirrors
        ``SnapshotChannel.get``)."""
        loaded = self.load(step)
        if loaded is None:
            return None
        from repro_torch.handoff.snapshot import ParamSnapshot
        leaves, treedef_hex, extra, dtypes = loaded
        return ParamSnapshot(step=int(step), leaves=leaves,
                             treedef_hex=treedef_hex, extra=extra,
                             dtypes=dtypes)

    # -- channel-compatible consumer surface ---------------------------------
    # A solo AsyncValidator in ANOTHER process points snapshots= straight at
    # the spool: pending/claim/mark_validated/discard mirror the validator
    # half of SnapshotChannel.  All bookkeeping is LOCAL to this handle —
    # retirement (deleting the spill) stays with the writing channel, which
    # alone knows when a step is both validated and durable.
    def pending(self) -> List[int]:
        """Unclaimed announced-and-committed steps, in announce order."""
        self._pending.extend(s for s in self.poll()
                             if s not in self._pending)
        return [s for s in self._pending if self.has(s)]

    def claim(self, step: int):
        """Take ``step`` for validation (drops it from this handle's
        pending list); ``None`` if the snapshot is gone (retired by the
        writer — the watcher fallback owns the step then)."""
        snap = self.get(step)
        if step in self._pending:
            self._pending.remove(step)
        return snap

    def mark_validated(self, step: int) -> None:
        if step in self._pending:
            self._pending.remove(step)

    def discard(self, step: int) -> None:
        """Reader-side failure: forget the local claim only — the retry
        restores from the durable checkpoint; the spill stays owned by the
        writer."""
        if step in self._pending:
            self._pending.remove(step)
