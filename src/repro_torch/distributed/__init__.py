"""The validator's device mesh and its placements (``repro/distributed``).

``compat`` builds the single-controller :class:`~repro_torch.distributed.
compat.DeviceMesh`, ``sharding`` places rows shard by shard on it, and
``fault`` holds the in-memory work queue with speculative re-execution.
Importing the package imports none of them.
"""
