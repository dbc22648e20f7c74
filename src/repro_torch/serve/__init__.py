"""Retrieval serving tier — the third leg of train -> validate -> serve
(``repro/serve/``).

The control plane (``repro_torch.control``) knows the best checkpoint at every
moment; this package puts it behind a query endpoint without ever forking
the scoring math.  Three planes:

  * index   — :class:`~repro_torch.serve.index.IndexBuilder` encodes the
    corpus once per promoted checkpoint through the same ``TokenStore`` /
    ``encode_store`` machinery the validator streams through, into a
    device-resident (optionally ``score_dtype``-quantized)
    :class:`~repro_torch.serve.index.ServingIndex`.
  * request — :class:`~repro_torch.serve.service.QueryService`
    micro-batches queries (max-latency flush), encodes them with the
    validator's encoder at one fixed shape, and scores through the same
    ``topk_exact`` / ``topk_mips`` dispatch the validator uses — so serving
    numbers are validation numbers (Kim et al. 2022's training-inference
    gap, closed by construction; bit for bit where the operand shapes are
    the validator's, tests/test_torch_serve_parity.py).
  * promotion — :class:`~repro_torch.serve.promoter.Promoter` tails the
    control plane's fsync'd ``select`` events and hot-swaps the live index
    with a zero-downtime two-phase flip (build -> verify -> atomic pointer
    swap, mirroring ``ckpt.save``'s commit discipline), each swap recorded
    as a replayable JSONL event with checkpoint/engine/``score_dtype``
    provenance.

:class:`~repro_torch.serve.admission.AdmissionController` bounds in-flight
requests so overload degrades by rejection, never by unbounded queueing.
"""

from repro_torch.serve.admission import AdmissionController, ServeOverloaded
from repro_torch.serve.index import IndexBuilder, ServeConfig, ServingIndex
from repro_torch.serve.promoter import Promoter, replay_swaps
from repro_torch.serve.service import QueryService, ServeResponse

__all__ = [
    "AdmissionController", "IndexBuilder", "Promoter", "QueryService",
    "ServeConfig", "ServeOverloaded", "ServeResponse", "ServingIndex",
    "replay_swaps",
]
