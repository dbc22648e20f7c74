"""Serve <-> validate parity on the port: serving numbers are validation
numbers.

For a fixed checkpoint, the port's ``QueryService`` (the real request path:
the threaded micro-batcher or the synchronous ``answer``) against the
port's ``ValidationSuite`` at every ``score_dtype``, both impls:

  * where every operand shape is the validator's — the same corpus chunks
    (``chunk_size``), the query block of the validator (``max_batch`` =
    its query batch, 12 queries), the validator's scoring block (``block``
    = its chunk under ``impl="torch"``; the materialized engine's one
    whole-corpus ``topk_mips`` call under ``impl="cuda"``) — ids, scores
    and tie order are bit-equal;
  * elsewhere (other ``max_batch``, the streaming engine's chunk-carry
    kernel under ``impl="cuda"``) scores agree within 1e-6 and the top-k
    id sets are equal, and int8 (exact integer sums) stays bit-equal.
    Eager PyTorch may sum a product of another shape in another order, so
    no bitwise assert spans two operand shapes (the reference's f32
    bitwise asserts across shapes are not copied).

Across the packages: the JAX package's ``QueryService`` (``impl="xla"``,
and ``"pallas"`` in interpret mode at f32) on the same params carried over
as numpy: scores within 1e-5, the same top-k id sets.  All on the CPU.
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tests.hypothesis_compat import given, settings, st

from benchmarks.common import toy_spec as jtoy_spec
import repro.serve as jserve
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.data import corpus as corpus_lib
from repro_torch.models.toy import toy_spec, train_toy_dr
from repro_torch.serve import IndexBuilder, QueryService, ServeConfig

K = 10
N_QUERIES = 12
CHUNK = 32
#: port serve vs port validator at other operand shapes (f32 sums in
#: another order), and port vs JAX (another library's sums)
SHAPE_TOL = 1e-6
CROSS_TOL = 1e-5
DTYPES = ("f32", "bf16", "int8")


@pytest.fixture(scope="module")
def setup():
    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=240,
                                                n_queries=N_QUERIES)
    spec = toy_spec(ds.vocab, device="cpu")
    _, snaps = train_toy_dr(ds, spec, steps=20, snapshot_every=20)
    return ds, spec, snaps[-1][1]


def _suite(ds, spec, *, score_dtype="f32", impl="torch",
           engine="streaming", batch_size=N_QUERIES, chunk_size=CHUNK):
    vcfg = ValidationConfig(metrics=("MRR@10",), k=K, batch_size=batch_size,
                            chunk_size=chunk_size, score_dtype=score_dtype,
                            impl=impl, engine=engine)
    return ValidationSuite(spec, [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)], vcfg)


def _serve_run(ds, spec, params, *, score_dtype="f32", impl="torch",
               max_batch=N_QUERIES, threaded=True, step=7,
               batch_size=N_QUERIES, chunk_size=CHUNK):
    """Answer every query through the real request path: a started
    micro-batcher with concurrent submits (arbitrary batch packing), or
    the synchronous ``answer`` path when ``threaded`` is False."""
    cfg = ServeConfig(k=K, score_dtype=score_dtype, impl=impl,
                      batch_size=batch_size, chunk_size=chunk_size,
                      block=CHUNK, max_batch=max_batch, flush_ms=2.0)
    builder = IndexBuilder(spec, ds.corpus, cfg)
    service = QueryService(spec, k=K, max_batch=max_batch, flush_ms=2.0)
    service.install(builder.build(params, step))
    items = [(q, ds.queries[q]) for q in ds.queries]
    if not threaded:
        resp = service.answer(items)
    else:
        service.start()
        try:
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                resp = list(pool.map(
                    lambda it: service.submit(it[0], it[1], timeout=30),
                    items))
        finally:
            service.stop()
    assert all(r.step == step for r in resp), \
        "every response must attribute the installed checkpoint"
    return ({r.qid: r.doc_ids for r in resp},
            {r.qid: r.scores for r in resp})


def _close(run_a, scores_a, run_b, scores_b, tol):
    """The same queries, the same top-k id sets, scores within ``tol``."""
    assert set(run_a) == set(run_b)
    for qid in run_a:
        assert set(run_a[qid]) == set(run_b[qid]), qid
        np.testing.assert_allclose(scores_a[qid], scores_b[qid], rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["answer", "threaded"])
@pytest.mark.parametrize("score_dtype", DTYPES)
def test_serve_matches_validator_bitwise_torch(setup, score_dtype,
                                               threaded):
    """``impl="torch"`` at the validator's operand shapes: ids, scores
    and tie order bit-identical; the metrics of the served run equal the
    ledger's."""
    ds, spec, params = setup
    suite = _suite(ds, spec, score_dtype=score_dtype)
    val_run, val_scores, _ = suite.engine("default").run(params)
    srv_run, srv_scores = _serve_run(ds, spec, params,
                                     score_dtype=score_dtype,
                                     threaded=threaded)
    assert srv_run == val_run          # ids, in rank (tie-broken) order
    assert srv_scores == val_scores    # float-exact scores
    suite_metrics = suite.validate_params(params, step=7,
                                          write_runs=False).metrics
    served = metrics_lib.compute_metrics(srv_run, ds.qrels, ["MRR@10"])
    assert served["MRR@10"] == suite_metrics["MRR@10"]


@pytest.mark.parametrize("score_dtype", DTYPES)
def test_serve_matches_materialized_validator_bitwise_cuda(setup,
                                                           score_dtype):
    """``impl="cuda"`` (the topk_mips wrapper; its plain version on CPU
    tensors) against the materialized engine, whose ``retrieve_run`` is
    the same one whole-corpus call: corpus encoded 12 rows a batch, 12
    queries in one block on both sides, bit-identical."""
    ds, spec, params = setup
    suite = _suite(ds, spec, score_dtype=score_dtype, impl="cuda",
                   engine="materialized", chunk_size=None)
    val_run, val_scores, _ = suite.engine("default").run(params)
    for threaded in (False, True):
        srv_run, srv_scores = _serve_run(
            ds, spec, params, score_dtype=score_dtype, impl="cuda",
            threaded=threaded, chunk_size=None)
        assert srv_run == val_run
        assert srv_scores == val_scores


@pytest.mark.parametrize("max_batch", [1, 5])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("score_dtype", DTYPES)
def test_serve_close_to_validator_at_other_shapes(setup, score_dtype, impl,
                                                  max_batch):
    """Other query blocks (and, under ``"cuda"``, the streaming engine's
    chunk-carry calls against serving's one whole-corpus call): the same
    top-k id sets, scores within 1e-6; int8 sums are exact integers, so
    its answers stay bit-identical."""
    ds, spec, params = setup
    suite = _suite(ds, spec, score_dtype=score_dtype, impl=impl)
    val_run, val_scores, _ = suite.engine("default").run(params)
    for threaded in (False, True):
        srv_run, srv_scores = _serve_run(
            ds, spec, params, score_dtype=score_dtype, impl=impl,
            max_batch=max_batch, threaded=threaded)
        _close(srv_run, srv_scores, val_run, val_scores, SHAPE_TOL)
        if score_dtype == "int8":
            assert srv_run == val_run and srv_scores == val_scores


@pytest.mark.parametrize("max_batch", [1, 3, N_QUERIES])
def test_micro_batch_packing_invariance(setup, max_batch):
    """A query's answer does not depend on where it lands in a
    micro-batch: every batch is encoded and searched at one fixed shape,
    so the threaded batcher's arbitrary packing equals the synchronous
    path bit for bit."""
    ds, spec, params = setup
    for impl in ("torch", "cuda"):
        a = _serve_run(ds, spec, params, impl=impl, max_batch=max_batch,
                       threaded=False)
        b = _serve_run(ds, spec, params, impl=impl, max_batch=max_batch,
                       threaded=True)
        assert a == b


def test_tie_break_parity_duplicate_docs(setup):
    """Exact score ties (duplicated passages) resolve identically on both
    paths at the validator's shapes: identical score sets give identical
    runs, not just identical up to tie order."""
    ds, spec, params = setup
    dup = dict(ds.corpus)
    for did, toks in list(ds.corpus.items())[:20]:
        dup[f"{did}__dup"] = list(toks)   # bitwise-equal duplicate rows
    ds_dup = dataclasses.replace(ds, corpus=dup)
    suite = _suite(ds_dup, spec)
    val_run, val_scores, _ = suite.engine("default").run(params)
    srv_run, srv_scores = _serve_run(ds_dup, spec, params)
    assert srv_run == val_run
    assert srv_scores == val_scores
    # the ties actually engaged: some query surfaced a duplicated doc
    assert any(d.endswith("__dup") or f"{d}__dup" in dup
               for r in val_run.values() for d in r)


def _seeded_parity(seed):
    ds = corpus_lib.synthetic_retrieval_dataset(seed, n_passages=120,
                                                n_queries=N_QUERIES)
    spec = toy_spec(ds.vocab, device="cpu")
    _, snaps = train_toy_dr(ds, spec, steps=10, snapshot_every=10)
    params = snaps[-1][1]
    val_run, val_scores, _ = _suite(ds, spec).engine("default").run(params)
    srv_run, srv_scores = _serve_run(ds, spec, params, threaded=False)
    assert srv_run == val_run
    assert srv_scores == val_scores


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=1, max_value=10_000))
def test_serve_parity_property(seed):
    """Property form: any synthetic corpus, any checkpoint — serve ==
    validate, bitwise, at the validator's shapes (f32)."""
    _seeded_parity(seed)


@pytest.mark.parametrize("seed", [11, 29, 47])
def test_serve_parity_seeded(seed):
    """Seeded form of the property, for environments without
    hypothesis."""
    _seeded_parity(seed)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("score_dtype", DTYPES)
def test_serve_matches_jax_query_service(setup, score_dtype, impl):
    """The port's serving path against the JAX package's on the same
    params (carried over as numpy): per query the same top-k id sets,
    scores within 1e-5.  The JAX side runs ``impl="xla"``, or the Pallas
    kernel in interpret mode for the port's ``"cuda"`` at f32."""
    ds, spec, params = setup
    table = params["table"].numpy()
    jspec = jtoy_spec(ds.vocab)
    jimpl = "pallas" if impl == "cuda" and score_dtype == "f32" else "xla"
    jcfg = jserve.ServeConfig(k=K, score_dtype=score_dtype, impl=jimpl,
                              batch_size=N_QUERIES)
    jsvc = jserve.QueryService(jspec, k=K, max_batch=5)
    jsvc.install(jserve.IndexBuilder(jspec, ds.corpus, jcfg).build(
        {"table": jnp.asarray(table)}, 7))
    jresp = jsvc.answer([(q, ds.queries[q]) for q in ds.queries])
    srv_run, srv_scores = _serve_run(ds, spec, {"table": table},
                                     score_dtype=score_dtype, impl=impl,
                                     max_batch=5, threaded=False)
    assert all(r.step == 7 for r in jresp)
    _close(srv_run, srv_scores, {r.qid: r.doc_ids for r in jresp},
           {r.qid: r.scores for r in jresp}, CROSS_TOL)
