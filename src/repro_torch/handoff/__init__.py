"""Lazy snapshot hand-off: validate checkpoints before they are durable
(``repro/handoff``).

The watcher path can only start after full durable serialization plus a
poll interval, so checkpoint-to-verdict latency carries an
O(serialize + poll) prefix that has nothing to do with validation.  Here
the trainer hands the validator a host-resident parameter snapshot the
moment the device-to-host copy lands, while the durable two-phase
``ckpt.save`` races in the background.

  * :class:`~repro_torch.handoff.snapshot.ParamSnapshot`: one step's host
    tree (numpy leaves + the checkpoint manifest's treedef);
    ``state()`` rebuilds exactly what ``ckpt.restore`` returns, so snapshot
    validation is bit for bit durable validation.
  * :class:`~repro_torch.handoff.spool.SnapshotSpool`: the cross-process
    representation, in the reference's on-disk layout (commit-marker
    directories of ``.npy`` leaves and an fsync'd announce log).
  * :class:`~repro_torch.handoff.channel.SnapshotChannel`: the bounded ring
    between trainer and validator, drop-oldest-unvalidated backpressure
    (training never blocks), and the durability state
    (``pending``/``durable``/``failed``) the control plane gates GC on.

The watcher stays the fallback and the dedupe authority: a step that
arrives via both routes is validated once (ledger idempotency), and a
snapshot lost to backpressure or a failure is scored later from the
durable checkpoint.
"""

from repro_torch.handoff.channel import SnapshotChannel
from repro_torch.handoff.snapshot import ParamSnapshot
from repro_torch.handoff.spool import SnapshotSpool

__all__ = ["ParamSnapshot", "SnapshotChannel", "SnapshotSpool"]
