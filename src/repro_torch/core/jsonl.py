"""Crash-tolerant JSONL loading, shared by every append-only fsync'd log.

The validator ledger and the control event log append one fsync'd JSON line
per record.  A process killed mid-append (crash / power loss) leaves a torn
FINAL line; :func:`read_jsonl_tolerant` drops exactly that line and
reports its byte offset, so the owning writer can cut it away before its
next append (:func:`truncate_torn_tail`; :func:`append_jsonl_atomic` does it
itself): a clean line instead of gluing onto the fragment.  Loading never
mutates the file — an offline audit reading a LIVE log must not race the
writer's in-flight append by truncating what merely looks torn.  A
malformed line anywhere ELSE means real corruption (bit rot, concurrent
writers, hand edits) and raises — silently dropping interior records would
corrupt replay.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Tuple

try:                                    # POSIX advisory locking (Linux/macOS)
    import fcntl
except ImportError:                     # pragma: no cover - non-POSIX hosts
    fcntl = None


def read_jsonl_tolerant(path: str, *,
                        kind: str = "row") -> Tuple[List[dict],
                                                    Optional[int]]:
    """Parse ``path`` as JSONL, tolerating a torn final line.

    Returns ``(records, torn_offset)`` — ``torn_offset`` is the byte offset
    of the dropped torn final line (None when the file is clean).  Readers
    leave the file untouched; the single writer that owns the file passes
    it to :func:`truncate_torn_tail` before its first append.  ``kind``
    names the record type in error messages."""
    with open(path, "rb") as f:
        raw = f.read()
    offset, lines = 0, []                # (lineno, byte offset, line)
    for i, ln in enumerate(raw.splitlines(keepends=True), 1):
        if ln.strip():
            lines.append((i, offset, ln))
        offset += len(ln)
    out: List[dict] = []
    for pos, (lineno, start, line) in enumerate(lines):
        try:
            out.append(json.loads(line))
        except ValueError:
            if pos == len(lines) - 1:
                # torn final line: the append died mid-write; dropped here,
                # truncated by the owning writer before its next append
                return out, start
            raise ValueError(
                f"corrupt {kind} at {path}:{lineno} (only a torn FINAL "
                f"line is recoverable)")
    return out, None


def truncate_torn_tail(path: str, torn_offset: Optional[int]) -> None:
    """Writer-side repair: cut the torn tail reported by
    :func:`read_jsonl_tolerant` so the next append starts a clean line.
    No-op when the load was clean."""
    if torn_offset is not None:
        with open(path, "r+b") as f:
            f.truncate(torn_offset)


def append_jsonl_atomic(path: str, records: Iterable[dict]) -> int:
    """Append ``records`` as JSONL in ONE atomic, fsync'd write — safe for
    MULTIPLE processes sharing the file (the validator-fleet work queue:
    claim records and result rows from N workers land in one ledger).

    Three guarantees, in write order:

      * tail repair — if the previous appender crashed mid-write the file
        ends in a torn fragment (no trailing newline); gluing onto it would
        turn a recoverable torn FINAL line into unrecoverable interior
        corruption, so the fragment is truncated away first;
      * atomicity — the file is opened ``O_APPEND`` and all records go out
        in a single ``os.write`` (POSIX appends are atomic w.r.t. the file
        offset), so concurrent appenders can interleave *records* but never
        tear one; an advisory ``flock`` additionally serializes the
        repair-then-append sequence so two restarting workers cannot race
        the truncation;
      * durability — fsync before returning, matching the ledger's
        discipline: no reader (in-process or crash-restarted) observes a
        record that could still disappear.

    Returns the number of records written."""
    recs = list(records)
    if not recs:
        return 0
    # key order is preserved (no sort_keys): result rows must serialize
    # byte-identically to the single-writer path they replace
    data = "".join(json.dumps(r) + "\n" for r in recs).encode()
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_RDWR, 0o644)
    try:
        if fcntl is not None:
            fcntl.flock(fd, fcntl.LOCK_EX)
        size = os.fstat(fd).st_size
        if size:
            last = os.pread(fd, 1, size - 1)
            if last != b"\n":
                # previous appender died mid-write: cut back to the last
                # complete line (the loader would have dropped the fragment
                # anyway — repairing here keeps OUR record un-glued)
                whole = os.pread(fd, size, 0)
                os.ftruncate(fd, whole.rfind(b"\n") + 1)
        os.write(fd, data)
        os.fsync(fd)
    finally:
        if fcntl is not None:
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    return len(recs)
