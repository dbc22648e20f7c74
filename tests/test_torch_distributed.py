"""The port's single-controller mesh and its sharded paths against the JAX
package's sharded paths, and the fault-tolerance queue
(``repro_torch.distributed``).

Mirrors the ``fault.py`` tests of tests/test_distributed.py and the sharded
legs of tests/test_retrieval.py (``topk_sharded``), tests/test_engine.py
(the sharded stream), tests/test_engine_staging.py (sharded query
encoding), tests/test_distributed.py (the sharded rerank),
tests/test_serve_parity.py (padded sharded serving) and the ``mesh1``
cases of tests/test_rerank_parity.py.

The JAX side needs forced host devices, so it runs once, in one
module-scoped subprocess with ``--xla_force_host_platform_device_count=8``,
on seeded numpy inputs this module writes, and saves every reference
output to ``tmp_path``.  The port runs in-process on a
``make_mesh((4, 2), ("data", "model"), devices=[cpu] * 8)`` mesh and on
``make_mesh((8,), ("data",), ...)``: one device repeated, which runs the
whole sharded code (row split, per-shard offsets, pads, the hierarchical
merge) on the CPU.

Gates (ROADMAP "Parity gates"): f32 and bf16 scores allclose (rtol 1e-5,
atol 1e-6) with equal top-k id sets per query; int8 raw int32 scores
exact; duplicate-row ties in the reference's id order; the rerank
slot-max sharded equal to unsharded bit for bit on integer-valued inputs
and to the JAX sharded stage within the f32 gate; padded serving (205
docs over 8 shards) the unsharded run.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import retrieval as jretrieval
from repro.data import corpus as jcorpus
from repro_torch.core import engine as E
from repro_torch.core import retrieval as R
from repro_torch.core.precision import quantize_int8
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.data.corpus import pad_batch
from repro_torch.distributed import compat, fault
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.biencoder import EncoderSpec
from repro_torch.models.toy import toy_spec
from repro_torch.serve import IndexBuilder, ServeConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
DTYPES = ("f32", "bf16", "int8")
# topk_sharded (tests/test_retrieval.py:72)
TQ, TN, TD, TK, TBLOCK = 6, 400, 16, 17, 32
# the sharded stream (tests/test_engine.py:310)
SN, SQ, SD, SK, SCHUNK = 100, 5, 16, 17, 24
# the sharded rerank (tests/test_distributed.py:192)
RN, RQ, RD, RK, RCHUNK = 96, 6, 16, 50, 24
# sharded query encoding (tests/test_engine_staging.py:328)
EQ, ECHUNK = 50, 16
# padded serving (tests/test_serve_parity.py:180)
PN, PQ, PK = 205, 8, 10

RERANK_PER_QUERY = {
    "q0": ["d3", "d3", "d40", "d95"],           # duplicates
    "q1": [],                                   # empty
    "q2": [f"d{j}" for j in range(30)],         # ragged, 2 chunks
    "q3": ["d95"],                              # final chunk only
    "q4": ["d0", "d24", "d48", "d72"],          # one per chunk
    "q5": ["d7", "d7", "d9", "bogus"],          # dup + unknown
}


def mesh_4x2():
    return compat.make_mesh((4, 2), ("data", "model"), [CPU] * 8)


def mesh_8():
    return compat.make_mesh((8,), ("data",), [CPU] * 8)


MESHES = {"4x2": (mesh_4x2, ("data", "model")), "8": (mesh_8, ("data",))}


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "tq": rng.normal(size=(TQ, TD)).astype(np.float32),
        "tc": rng.normal(size=(TN, TD)).astype(np.float32),
        # integer rows from a 37-row table: exact scores, many exact ties
        "tc_dup": rng.integers(-4, 5, size=(37, TD)).astype(np.float32)[
            np.arange(TN) % 37],
        "tq_int": rng.integers(-4, 5, size=(TQ, TD)).astype(np.float32),
        "s_table": rng.normal(size=(64, SD)).astype(np.float32),
        "s_q": rng.normal(size=(SQ, SD)).astype(np.float32),
        "r_table": rng.integers(-4, 5, size=(64, RD)).astype(np.float32),
        "r_q": rng.integers(-4, 5, size=(RQ, RD)).astype(np.float32),
        "p_table": (0.1 * rng.standard_normal((503, 32))).astype(np.float32),
    }


_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from benchmarks.common import toy_spec
    from repro.core import engine as E
    from repro.core import retrieval as R
    from repro.core.encoder import jitted_encoder
    from repro.data import corpus as corpus_lib
    from repro.data.corpus import pad_batch
    from repro.distributed import compat
    from repro.serve import IndexBuilder, ServeConfig

    assert jax.device_count() == 8
    inp = dict(np.load(sys.argv[1]))
    out, js = {}, {}
    meshes = {"4x2": (compat.make_mesh((4, 2), ("data", "model")),
                      ("data", "model")),
              "8": (compat.make_mesh((8,), ("data",)), ("data",))}
    TK, TBLOCK, SK, SCHUNK, RK, RCHUNK = %(consts)s
    for mname, (mesh, axes) in meshes.items():
        for dt in ("f32", "bf16", "int8"):
            s, i = R.topk_sharded(mesh, jnp.asarray(inp["tq"]),
                                  jnp.asarray(inp["tc"]), k=TK,
                                  axis_names=axes, block=TBLOCK,
                                  score_dtype=dt)
            out[f"topk_{mname}_{dt}_s"] = np.asarray(s)
            out[f"topk_{mname}_{dt}_i"] = np.asarray(i)
        s, i = R.topk_sharded(mesh, jnp.asarray(inp["tq_int"]),
                              jnp.asarray(inp["tc_dup"]), k=TK,
                              axis_names=axes, block=TBLOCK)
        out[f"ties_{mname}_s"] = np.asarray(s)
        out[f"ties_{mname}_i"] = np.asarray(i)

        def enc(params, tokens, mask):
            return jnp.take(params["table"], tokens[:, 0], axis=0)

        params = {"table": jnp.asarray(inp["s_table"])}
        docs = [[int(j %% 64)] for j in range(%(SN)d)]
        store = E.TokenStore.build(docs, max_len=2, chunk=SCHUNK)
        for dt in ("f32", "bf16", "int8"):
            stage = E.ShardedStreamTopKStage(
                enc, mesh, k=SK, query_ids=[f"q{j}" for j in range(%(SQ)d)],
                doc_ids=[f"d{j}" for j in range(%(SN)d)], score_dtype=dt)
            carry = stage.init(jnp.asarray(inp["s_q"]))
            for toks, mask, base, n_valid in store.chunks():
                carry = stage.step(params, jnp.asarray(inp["s_q"]), carry,
                                   toks, mask, base, n_valid)
            out[f"stream_{mname}_{dt}_s"] = np.asarray(carry[0])
            out[f"stream_{mname}_{dt}_i"] = np.asarray(carry[1])

        q_texts = [[int(j %% 64), 1] for j in range(%(EQ)d)]
        qstore = E.TokenStore.build(q_texts, max_len=2, chunk=%(ECHUNK)d)
        out[f"encode_{mname}"] = np.asarray(
            E.encode_store(enc, params, qstore, mesh=mesh))

        rparams = {"table": jnp.asarray(inp["r_table"])}
        rdocs = [[int(j %% 64)] for j in range(%(RN)d)]
        rstore = E.TokenStore.build(rdocs, max_len=2, chunk=RCHUNK)
        qids = [f"q{j}" for j in range(%(RQ)d)]
        stage = E.ShardedStreamRerankStage(
            enc, mesh, k=RK, query_ids=qids,
            doc_ids=[f"d{j}" for j in range(%(RN)d)],
            per_query=json.loads(sys.argv[3]), store=rstore)
        carry = stage.init(jnp.asarray(inp["r_q"]))
        for toks, mask, base, n_valid in rstore.chunks():
            if not stage.wants_chunk(base // rstore.chunk):
                continue
            carry = stage.step(rparams, jnp.asarray(inp["r_q"]), carry, toks,
                               mask, base, n_valid)
        js[f"rerank_{mname}"] = stage.finalize(carry)

    ds = corpus_lib.synthetic_retrieval_dataset(3, n_passages=%(PN)d,
                                                n_queries=%(PQ)d)
    spec = toy_spec(ds.vocab)
    params = {"table": jnp.asarray(inp["p_table"])}
    qids = list(ds.queries)
    toks, mask = pad_batch([ds.queries[q] for q in qids], spec.q_max_len)
    q_emb = jitted_encoder(spec.encode_query)(params, jnp.asarray(toks),
                                              jnp.asarray(mask))
    idx = IndexBuilder(spec, ds.corpus, ServeConfig(
        k=%(PK)d, mesh=meshes["8"][0], batch_size=32)).build(params, 1)
    js["serve_n_pad"] = idx.n_pad
    js["serve"] = idx.search_run(qids, q_emb, k=%(PK)d)
    np.savez(sys.argv[2], **out)
    with open(sys.argv[2] + ".json", "w") as f:
        json.dump(js, f)
    print("REF_OK")
""") % {"consts": (TK, TBLOCK, SK, SCHUNK, RK, RCHUNK), "SN": SN, "SQ": SQ,
        "EQ": EQ, "ECHUNK": ECHUNK, "RN": RN, "RQ": RQ, "PN": PN, "PQ": PQ,
        "PK": PK}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX reference output, from one subprocess with 8 forced host
    devices."""
    base = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(str(base / "inputs.npz"), **inp)
    out = str(base / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(base / "inputs.npz"), out,
         json.dumps(RERANK_PER_QUERY)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert "REF_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out + ".json") as f:
        js = json.load(f)
    return inp, dict(np.load(out)), js


def _gate(got_s, got_i, want_s, want_i, dt, *, q=None, c=None):
    """The parity gate at ``dt``: f32 / bf16 scores allclose with equal
    top-k id sets per query; int8 the same ids and exact raw int32 scores
    at them (dequantized within rtol 1e-6)."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    assert got_s.shape == want_s.shape and got_i.shape == want_i.shape
    if dt != "int8":
        np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=ATOL)
        for a, b in zip(got_i, want_i):
            assert set(a.tolist()) == set(b.tolist())
        return
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    qv, _ = quantize_int8(torch.from_numpy(q))
    cv, _ = quantize_int8(torch.from_numpy(c))
    raw = (qv.long() @ cv.long().T).numpy()
    # the reference's raw sums, from its own quantization of the same rows
    from repro.kernels.topk_mips.ops import quantize_int8 as jquant
    jq, _ = jquant(q)
    jc, _ = jquant(c)
    jraw = np.asarray(jq, np.int64) @ np.asarray(jc, np.int64).T
    np.testing.assert_array_equal(np.take_along_axis(raw, got_i, axis=1),
                                  np.take_along_axis(jraw, want_i, axis=1))


# ---------------------------------------------------------------------------
# The mesh and its placements
# ---------------------------------------------------------------------------

def test_make_mesh_holds_devices_shaped_by_axes():
    mesh = mesh_4x2()
    assert mesh.devices.shape == (4, 2) and mesh.devices.size == 8
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 2}
    assert all(d == CPU for d in mesh.devices.flat)
    assert mesh.distinct_devices() == [CPU] and mesh.home == CPU
    with pytest.raises(ValueError, match="needs 8 devices"):
        compat.make_mesh((4, 2), ("data", "model"), [CPU] * 4)
    with pytest.raises(ValueError, match="axis"):
        compat.make_mesh((8,), ("data", "model"), [CPU] * 8)


def test_unavailable_mesh_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="not available"):
        compat.make_mesh((2,), ("data",), ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="needs 1 devices, got 0"):
        compat.make_mesh((1,), ("data",))        # default: visible cards
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_mesh.make_validator_mesh()


def test_launch_meshes():
    mesh = launch_mesh.make_validator_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4, "model": 1}
    assert mesh.devices.size == 4 and mesh.distinct_devices() == [CPU]
    assert launch_mesh.make_validator_mesh(
        4, model_axis=2, device="cpu").shape == {"data": 2, "model": 2}
    assert launch_mesh.make_validator_mesh(device="cpu").devices.size == 1
    with pytest.raises(ValueError):
        launch_mesh.make_validator_mesh(3, model_axis=2, device="cpu")
    with pytest.raises(RuntimeError, match=">= 2 devices"):
        launch_mesh.make_disaggregated_meshes(device="cpu")


def test_shard_order_is_the_reference_axis_index():
    """Shard ``i`` of several axes reads their coordinates row-major, the
    first axis major (``lax.axis_index`` over the same names); axes not
    named are taken at coordinate 0."""
    # shard_devices reads only the device array: tag its positions 0..7
    tagged = np.empty((4, 2), dtype=object)
    for idx, v in np.ndenumerate(np.arange(8).reshape(4, 2)):
        tagged[idx] = int(v)
    mesh = compat.DeviceMesh(tagged, ("data", "model"))
    assert shd.shard_devices(mesh, ("data", "model")) == list(range(8))
    assert shd.shard_devices(mesh, ("model", "data")) == \
        [0, 2, 4, 6, 1, 3, 5, 7]
    assert shd.shard_devices(mesh, ("data",)) == [0, 2, 4, 6]
    assert shd.shard_devices(mesh, ("model",)) == [0, 1]
    with pytest.raises(ValueError):
        shd.shard_devices(mesh, ("pod",))


def test_rows_and_replicated_placements():
    mesh = mesh_4x2()
    x = torch.arange(48, dtype=torch.float32).reshape(16, 3)
    rows = shd.rows_sharding(mesh).put(x)
    assert len(rows.shards) == 8 and rows.rows == 2
    assert rows.shape == (16, 3) and rows.dtype == torch.float32
    assert torch.equal(rows.gather(CPU), x)
    assert torch.equal(rows.shards[3], x[6:8])
    assert shd.rows_sharding(mesh, ("data",)).n_shards == 4
    with pytest.raises(ValueError, match="pad first"):
        shd.rows_sharding(mesh).put(x[:15])
    tree = {"a": np.ones((2, 2), np.float32), "b": {"c": x}}
    reps = shd.replicated_sharding(mesh).put(tree)
    assert set(reps.copies) == {CPU}
    assert reps.on("cpu")["b"]["c"] is x
    assert shd.batch_axes(mesh) == ("data",)
    pod = compat.make_mesh((2, 2), ("pod", "data"), [CPU] * 4)
    assert shd.batch_axes(pod) == ("pod", "data")


# ---------------------------------------------------------------------------
# topk_sharded (tests/test_retrieval.py:72)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("dt", DTYPES)
def test_topk_sharded_matches_reference(ref, mname, dt):
    inp, out, _ = ref
    make, axes = MESHES[mname]
    q, c = torch.from_numpy(inp["tq"]), torch.from_numpy(inp["tc"])
    s, i = R.topk_sharded(make(), q, c, k=TK, axis_names=axes,
                          block=TBLOCK, score_dtype=dt)
    assert i.dtype == torch.int32
    _gate(s, i, out[f"topk_{mname}_{dt}_s"], out[f"topk_{mname}_{dt}_i"],
          dt, q=inp["tq"], c=inp["tc"])
    # and the port's own unsharded scan, on the same gate
    es, ei = R.topk_exact(q, c, k=TK, block=TBLOCK, score_dtype=dt)
    _gate(s, i, es, ei, dt, q=inp["tq"], c=inp["tc"])


@pytest.mark.parametrize("mname", list(MESHES))
def test_topk_sharded_duplicate_row_ties_in_reference_order(ref, mname):
    """Integer rows repeated every 37: exact scores with many ties.  The
    ids come back in the reference's order (the lower row first), which is
    also the unsharded scan's and ``lax.top_k``'s over the whole matrix."""
    inp, out, _ = ref
    make, axes = MESHES[mname]
    q, c = torch.from_numpy(inp["tq_int"]), torch.from_numpy(inp["tc_dup"])
    s, i = R.topk_sharded(make(), q, c, k=TK, axis_names=axes, block=TBLOCK)
    np.testing.assert_array_equal(i.numpy(), out[f"ties_{mname}_i"])
    np.testing.assert_array_equal(s.numpy(), out[f"ties_{mname}_s"])
    es, ei = R.topk_exact(q, c, k=TK, block=TBLOCK)
    np.testing.assert_array_equal(i.numpy(), ei.numpy())
    import jax
    js, ji = jax.lax.top_k(inp["tq_int"] @ inp["tc_dup"].T, TK)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_topk_sharded_takes_placed_rows_and_checks_shards():
    mesh = mesh_8()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    placed = shd.rows_sharding(mesh, ("data",)).put(c)
    a = R.topk_sharded(mesh, q, placed, k=5, axis_names=("data",))
    b = R.topk_sharded(mesh, q, c, k=5, axis_names=("data",))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="pad first"):
        R.topk_sharded(mesh, q, c[:63], k=5, axis_names=("data",))
    with pytest.raises(ValueError, match="shards"):
        R.topk_sharded(mesh_4x2(), q, placed, k=5, axis_names=("data",))


def test_retrieve_run_routes_the_mesh(ref):
    inp, out, _ = ref
    qids = [f"q{j}" for j in range(TQ)]
    dids = [f"d{j}" for j in range(TN)]
    run, scores = R.retrieve_run(qids, inp["tq"], dids, inp["tc"], k=TK,
                                 mesh=mesh_4x2(), block=TBLOCK)
    jrun, jscores = jretrieval.retrieve_run(qids, inp["tq"], dids,
                                            inp["tc"], k=TK, block=TBLOCK)
    for qid in qids:
        assert set(run[qid]) == set(jrun[qid])
        np.testing.assert_allclose(scores[qid], jscores[qid], rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# The sharded stream (tests/test_engine.py:310)
# ---------------------------------------------------------------------------

def _gather_enc(params, tokens, mask):
    return params["table"][tokens[:, 0].long()]


def _drive(stage, store, params, q_emb, sharding=None):
    carry = stage.init(q_emb)
    schedule = E.plan_schedule(store.n_chunks)
    wants = getattr(stage, "wants_chunk", None)
    if wants is not None:
        schedule = [(ci, w) for ci, w in schedule if wants(ci)]
    for (ci, _), (toks, mask) in zip(schedule, E.staged_batches(
            store, schedule, device=CPU, sharding=sharding)):
        carry = stage.step(params, q_emb, carry, toks, mask,
                           store.chunk * ci, store.rows_valid(ci))
    return carry


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("dt", DTYPES)
def test_sharded_stream_matches_reference(ref, mname, dt):
    inp, out, _ = ref
    make, _ = MESHES[mname]
    params = {"table": torch.from_numpy(inp["s_table"])}
    q_emb = torch.from_numpy(inp["s_q"])
    docs = [[j % 64] for j in range(SN)]
    store = E.TokenStore.build(docs, max_len=2, chunk=SCHUNK)
    qids = [f"q{j}" for j in range(SQ)]
    dids = [f"d{j}" for j in range(SN)]
    stage = E.ShardedStreamTopKStage(_gather_enc, make(), k=SK,
                                     query_ids=qids, doc_ids=dids,
                                     score_dtype=dt)
    carry = _drive(stage, store, params, q_emb, stage.input_sharding)
    c_emb = inp["s_table"][np.arange(SN) % 64]
    _gate(carry[0], carry[1], out[f"stream_{mname}_{dt}_s"],
          out[f"stream_{mname}_{dt}_i"], dt, q=inp["s_q"], c=c_emb)
    single = E.StreamTopKStage(_gather_enc, k=SK, query_ids=qids,
                               doc_ids=dids, score_dtype=dt)
    want = _drive(single, store, params, q_emb)
    _gate(carry[0], carry[1], want[0], want[1], dt, q=inp["s_q"], c=c_emb)
    run, _ = stage.finalize(carry)
    assert list(run) == qids and all(len(v) == SK for v in run.values())


def test_sharded_stream_equals_unsharded_bitwise_on_exact_scores():
    """Integer-valued embeddings: every score is exact, so the sharded
    carry equals the unsharded one bit for bit, ties included."""
    rng = np.random.default_rng(5)
    params = {"table": torch.from_numpy(
        rng.integers(-3, 4, size=(16, 8)).astype(np.float32))}
    q_emb = torch.from_numpy(rng.integers(-3, 4, size=(4, 8))
                             .astype(np.float32))
    docs = [[j % 16] for j in range(70)]
    store = E.TokenStore.build(docs, max_len=2, chunk=16)
    qids, dids = [f"q{j}" for j in range(4)], [f"d{j}" for j in range(70)]
    for dt in DTYPES:
        stage = E.ShardedStreamTopKStage(_gather_enc, mesh_4x2(), k=23,
                                         query_ids=qids, doc_ids=dids,
                                         score_dtype=dt)
        got = _drive(stage, store, params, q_emb, stage.input_sharding)
        want = _drive(E.StreamTopKStage(_gather_enc, k=23, query_ids=qids,
                                        doc_ids=dids, score_dtype=dt),
                      store, params, q_emb)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dt", DTYPES)
def test_one_device_mesh_runs_the_unsharded_products(dt):
    """Float scores: shards on one device are encoded and scored in one
    call, so a mesh that repeats one device gives the unsharded stage's
    carry bit for bit (retrieval and rerank), whatever the shape-dependent
    rounding of a product."""
    rng = np.random.default_rng(11)
    params = {"table": torch.from_numpy(
        rng.normal(size=(48, 12)).astype(np.float32))}
    q_emb = torch.from_numpy(rng.normal(size=(7, 12)).astype(np.float32))
    docs = [[j % 48] for j in range(90)]
    store = E.TokenStore.build(docs, max_len=2, chunk=32)
    qids, dids = [f"q{j}" for j in range(7)], [f"d{j}" for j in range(90)]
    per_query = {q: [f"d{int(j)}" for j in rng.integers(0, 90, size=15)]
                 for q in qids}
    stage = E.ShardedStreamTopKStage(_gather_enc, mesh_4x2(), k=19,
                                     query_ids=qids, doc_ids=dids,
                                     score_dtype=dt)
    got = _drive(stage, store, params, q_emb, stage.input_sharding)
    want = _drive(E.StreamTopKStage(_gather_enc, k=19, query_ids=qids,
                                    doc_ids=dids, score_dtype=dt),
                  store, params, q_emb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rstage = E.ShardedStreamRerankStage(_gather_enc, mesh_8(), k=10,
                                        query_ids=qids, doc_ids=dids,
                                        per_query=per_query, store=store,
                                        score_dtype=dt)
    single = E.StreamRerankStage(_gather_enc, k=10, query_ids=qids,
                                 doc_ids=dids, per_query=per_query,
                                 store=store, score_dtype=dt)
    assert torch.equal(_drive(rstage, store, params, q_emb,
                              rstage.input_sharding),
                       _drive(single, store, params, q_emb))


def test_device_batches_group_shards_by_device():
    """Each distinct device gets one batch: its shards' rows concatenated
    in shard order, in the order the devices first appear."""
    meta = torch.device("meta")
    toks = shd.ShardedRows([torch.full((2, 3), i) if i % 2 == 0
                            else torch.empty((2, 3), device=meta)
                            for i in range(4)])
    groups = list(E.device_batches(toks, toks))
    assert [(d.type, sids) for d, sids, _, _ in groups] == [
        ("cpu", [0, 2]), ("meta", [1, 3])]
    assert torch.equal(groups[0][2][:, 0], torch.tensor([0, 0, 2, 2]))
    one = shd.ShardedRows([torch.zeros((2, 3))])
    (dev, sids, t, _), = E.device_batches(one, one)
    assert sids == [0] and t is one.shards[0]


def test_routes_take_the_mesh():
    mesh = mesh_4x2()
    kw = dict(k=3, query_ids=["q0"], doc_ids=["d0", "d1"])
    assert E.make_stage(_gather_enc, mode="retrieval", impl="torch",
                        mesh=mesh, **kw).name == "topk_sharded"
    assert E.make_stage(_gather_enc, mode="retrieval", impl="torch",
                        **kw).name == "topk_torch"
    # the topk_mips chunk-carry kernel is single-device: the mesh is ignored
    assert E.make_stage(_gather_enc, mode="retrieval", impl="cuda",
                        mesh=mesh, **kw).name == "topk_cuda"
    assert E.make_stage(_gather_enc, mode="rerank", impl="torch", mesh=mesh,
                        per_query={"q0": ["d1"]}, **kw).name == \
        "rerank_sharded"
    assert E.make_stage(_gather_enc, mode="rerank", impl="cuda", mesh=mesh,
                        per_query={"q0": ["d1"]}, **kw).name == \
        "rerank_sharded"
    assert E.make_stage(_gather_enc, mode="rerank", impl="torch", mesh=mesh,
                        **kw).name == "topk_sharded"


def test_chunk_geometry_rounds_to_the_shards():
    vcfg = ValidationConfig(batch_size=10, chunk_size=20)
    assert E.chunk_geometry(vcfg, 1000) == (20, 10)
    assert E.chunk_geometry(vcfg, 1000, mesh_4x2()) == (24, 16)
    assert E.chunk_geometry(vcfg, 5, mesh_8()) == (8, 16)


# ---------------------------------------------------------------------------
# Sharded query encoding (tests/test_engine_staging.py:328)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname", list(MESHES))
def test_sharded_query_encoding_matches_reference(ref, mname):
    inp, out, _ = ref
    make, axes = MESHES[mname]
    params = {"table": torch.from_numpy(inp["s_table"])}
    store = E.TokenStore.build([[j % 64, 1] for j in range(EQ)], max_len=2,
                               chunk=ECHUNK)
    plain = E.encode_store(_gather_enc, params, store, device=CPU)
    sharded = E.encode_store(_gather_enc, params, store, device=CPU,
                             mesh=make(), axis_names=axes)
    assert sharded.shape == (EQ, SD)
    assert torch.equal(sharded, plain)
    np.testing.assert_allclose(sharded.numpy(), out[f"encode_{mname}"],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="pad first"):
        E.encode_store(_gather_enc, params,
                       E.TokenStore.build([[1]] * 10, max_len=1, chunk=5),
                       device=CPU, mesh=make())


@pytest.fixture(scope="module")
def ds():
    return jcorpus.synthetic_retrieval_dataset(0, n_passages=200,
                                               n_queries=20)


def _suite(ds, spec, **kw):
    vcfg = ValidationConfig(metrics=("MRR@10", "Recall@50"), k=50,
                            batch_size=40, chunk_size=40, **kw)
    return ValidationSuite(spec, [ValidationTask(
        "default", ds.corpus, ds.queries, ds.qrels)], vcfg)


def test_sharded_suite_matches_unsharded(ds):
    """The whole engine on a mesh (sharded query encoding, pre-sharded
    staging, the sharded stage) against the single-device suite: the
    f32 gate on every list and score, and equal metrics."""
    spec = toy_spec(ds.vocab, device="cpu")
    params = spec.init(0)
    mesh = mesh_4x2()
    on_mesh = _suite(ds, spec, mesh=mesh)
    eng = on_mesh.engine("default")
    assert eng.stage.name == "topk_sharded" and eng.query_mesh is mesh
    assert eng.doc_store.chunk == 40 and eng.query_store.chunk == 40
    single = _suite(ds, spec)
    run_m, scores_m, _ = eng.run(params)
    run_s, scores_s, _ = single.engine("default").run(params)
    for qid in run_s:
        assert set(run_m[qid]) == set(run_s[qid])
        np.testing.assert_allclose(scores_m[qid], scores_s[qid], rtol=RTOL,
                                   atol=ATOL)
    rm, rs = on_mesh.validate_params(params), single.validate_params(params)
    for name, v in rs.metrics.items():
        assert abs(rm.metrics[name] - v) <= 1e-6, name
    assert on_mesh.plan_units(1)[0].requires_dict == {"mesh_size": 8}
    assert single.plan_units(1)[0].requires_dict == {"mesh_size": 1}


def test_materialized_engine_takes_the_mesh(ds):
    spec = toy_spec(ds.vocab, device="cpu")
    params = spec.init(0)
    corpus = dict(list(ds.corpus.items())[:192])      # divides 8 shards
    qrels = {q: r for q, r in ds.qrels.items()}
    kw = dict(metrics=("MRR@10",), k=20, batch_size=32,
              engine="materialized")
    run = {}
    for name, mesh in (("mesh", mesh_4x2()), ("single", None)):
        suite = ValidationSuite(spec, [ValidationTask(
            "default", corpus, ds.queries, qrels)],
            ValidationConfig(mesh=mesh, **kw))
        run[name] = suite.engine("default").run(params)
    for qid in run["single"][0]:
        assert set(run["mesh"][0][qid]) == set(run["single"][0][qid])
        np.testing.assert_allclose(run["mesh"][1][qid],
                                   run["single"][1][qid], rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# The sharded rerank (tests/test_distributed.py:192)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname", list(MESHES))
def test_sharded_rerank_matches_unsharded_and_reference(ref, mname):
    inp, _, js = ref
    make, _ = MESHES[mname]
    params = {"table": torch.from_numpy(inp["r_table"])}
    q_emb = torch.from_numpy(inp["r_q"])
    docs = [[j % 64] for j in range(RN)]
    store = E.TokenStore.build(docs, max_len=2, chunk=RCHUNK)
    qids = [f"q{j}" for j in range(RQ)]
    dids = [f"d{j}" for j in range(RN)]
    c_emb = torch.from_numpy(inp["r_table"][np.arange(RN) % 64])
    want = R.rerank_run(qids, q_emb, dids, c_emb, RERANK_PER_QUERY, k=RK)
    stage = E.ShardedStreamRerankStage(_gather_enc, make(), k=RK,
                                       query_ids=qids, doc_ids=dids,
                                       per_query=RERANK_PER_QUERY,
                                       store=store)
    got_carry = _drive(stage, store, params, q_emb, stage.input_sharding)
    single = E.StreamRerankStage(_gather_enc, k=RK, query_ids=qids,
                                 doc_ids=dids, per_query=RERANK_PER_QUERY,
                                 store=store)
    want_carry = _drive(single, store, params, q_emb)
    assert torch.equal(got_carry, want_carry)     # slot-max, bit for bit
    got = stage.finalize(got_carry)
    assert got == want
    jrun, jscores = js[f"rerank_{mname}"]
    assert got[0] == jrun
    for qid in qids:
        np.testing.assert_allclose(got[1][qid], jscores[qid], rtol=RTOL,
                                   atol=ATOL)


def test_sharded_rerank_suite_matches_unsharded(ds):
    spec = toy_spec(ds.vocab, device="cpu")
    params = spec.init(1)
    base_run = jcorpus.lexical_baseline_run(ds, k=30)
    from repro_torch.core.samplers import RerankTopK
    out = {}
    for name, mesh in (("mesh", mesh_4x2()), ("single", None)):
        suite = ValidationSuite(spec, [ValidationTask(
            "default", ds.corpus, ds.queries, ds.qrels,
            sampler=RerankTopK(depth=10), baseline_run=base_run)],
            ValidationConfig(metrics=("MRR@10",), mode="rerank", k=100,
                             batch_size=40, chunk_size=40, mesh=mesh))
        eng = suite.engine("default")
        assert eng.stage.name == ("rerank_sharded" if mesh else "rerank")
        out[name] = (eng.run(params)[:2],
                     suite.validate_params(params).metrics)
    for qid in out["single"][0][0]:
        assert out["mesh"][0][0][qid] == out["single"][0][0][qid]
        np.testing.assert_allclose(out["mesh"][0][1][qid],
                                   out["single"][0][1][qid], rtol=RTOL,
                                   atol=ATOL)
    for m, v in out["single"][1].items():
        assert abs(out["mesh"][1][m] - v) <= 1e-6


# ---------------------------------------------------------------------------
# Rerank parity on a mesh (the mesh1 cases of tests/test_rerank_parity.py)
# ---------------------------------------------------------------------------

DIM, VOCAB = 8, 64


def _int_setup(n_docs, n_queries, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(-4, 5, size=(VOCAB, DIM)).astype(np.float32)
    doc_texts = [[int(i % VOCAB)] for i in range(n_docs)]
    c_emb = table[[t[0] for t in doc_texts]]
    q_emb = rng.integers(-4, 5, size=(n_queries, DIM)).astype(np.float32)
    return {"table": torch.from_numpy(table)}, doc_texts, c_emb, q_emb


def _check_parity(mesh, n_docs, cand_lists, *, k, chunk, seed=0):
    """The reference's dense ``rerank_run``, the port's ``rerank_run``, its
    unsharded and its sharded streaming stage agree bit for bit."""
    Q = len(cand_lists)
    params, doc_texts, c_emb, q_emb = _int_setup(n_docs, Q, seed)
    qids = [f"q{i}" for i in range(Q)]
    dids = [f"d{i}" for i in range(n_docs)]
    per_query = {qid: list(c) for qid, c in zip(qids, cand_lists)}
    ref_run = jretrieval.rerank_run(qids, q_emb, dids, c_emb, per_query,
                                    k=k, q_block=max(Q, 1))
    got = R.rerank_run(qids, torch.from_numpy(q_emb), dids,
                       torch.from_numpy(c_emb), per_query, k=k)
    assert got == ref_run, "port rerank_run diverged from the reference"
    n = mesh.devices.size
    store = E.TokenStore.build(doc_texts, max_len=2,
                               chunk=-(-chunk // n) * n)
    q = torch.from_numpy(q_emb)
    single = E.StreamRerankStage(_gather_enc, k=k, query_ids=qids,
                                 doc_ids=dids, per_query=per_query,
                                 store=store)
    assert single.finalize(_drive(single, store, params, q)) == ref_run
    sharded = E.ShardedStreamRerankStage(_gather_enc, mesh, k=k,
                                         query_ids=qids, doc_ids=dids,
                                         per_query=per_query, store=store)
    assert sharded.finalize(_drive(sharded, store, params, q,
                                   sharded.input_sharding)) == ref_run
    return ref_run


@pytest.fixture(scope="module", params=["mesh1", "4x2"])
def rmesh(request):
    if request.param == "mesh1":
        return compat.make_mesh((1,), ("data",), [CPU])
    return mesh_4x2()


def test_parity_ragged_duplicate_unknown_empty(rmesh):
    run, scores = _check_parity(rmesh, 37, [
        ["d3", "d3", "d10", "d36"],
        [],
        [f"d{j}" for j in range(20)] + ["nope"],
        ["d36"],
        ["d0", "d5", "d5", "d7"],
    ], k=50, chunk=8)
    assert run["q1"] == [] and scores["q1"] == []
    assert len(run["q0"]) == 4
    assert len(run["q2"]) == 20


def test_parity_all_queries_empty(rmesh):
    run, scores = _check_parity(rmesh, 12, [[], [], []], k=5, chunk=4)
    assert all(v == [] for v in run.values())
    assert all(v == [] for v in scores.values())


def test_parity_duplicate_tie_order_is_slot_stable(rmesh):
    run, _ = _check_parity(rmesh, 10, [["d2", "d2", "d2"]], k=3, chunk=4)
    assert run["q0"] == ["d2", "d2", "d2"]


@pytest.mark.parametrize("n_docs,chunk,k", [
    (1, 1, 1), (9, 1, 3), (16, 16, 100), (23, 7, 2)])
def test_parity_shape_extremes(rmesh, n_docs, chunk, k):
    rng = np.random.default_rng(n_docs)
    cand_lists = [[f"d{j}" for j in rng.integers(0, n_docs, size=m)]
                  for m in (1, 0, min(5, n_docs))]
    _check_parity(rmesh, n_docs, cand_lists, k=k, chunk=chunk, seed=n_docs)


def test_parity_candidates_confined_to_one_chunk(rmesh):
    _check_parity(rmesh, 40, [["d8", "d9", "d10"], ["d11", "d8"]], k=10,
                  chunk=8)


def test_parity_seeded_fuzz(rmesh):
    rng = np.random.default_rng(7)
    for i in range(12):
        n_docs = int(rng.integers(1, 41))
        chunk = int(rng.choice([1, 3, 8, 13]))
        cand_lists = [[f"d{int(j)}"
                       for j in rng.integers(0, n_docs + 3,
                                             size=int(rng.integers(0, 9)))]
                      for _ in range(int(rng.integers(1, 5)))]
        k = int(rng.integers(1, 61))
        _check_parity(rmesh, n_docs, cand_lists, k=k, chunk=chunk, seed=i)


def test_pipeline_rerank_all_paths_identical(rmesh):
    """Through the suite: streaming sharded, streaming single-device and
    materialized (blocked at 1 query, and dense) give identical runs,
    scores and metrics."""
    from repro_torch.core.samplers import SubsetResult

    class _Fixed:
        name = "fixed"

        def __init__(self, per_query):
            self.per_query = per_query

        def sample(self, corpus_ids, run, qrels):
            union = sorted({d for c in self.per_query.values() for d in c
                            if d in set(corpus_ids)})
            return SubsetResult(doc_ids=union, per_query=self.per_query)

    n_docs, n_queries = 30, 4
    rng = np.random.default_rng(5)
    params, doc_texts, _, _ = _int_setup(n_docs, n_queries, seed=5)
    corpus = {f"d{i}": doc_texts[i] for i in range(n_docs)}
    queries = {f"q{i}": [int(rng.integers(0, VOCAB))]
               for i in range(n_queries)}
    qrels = {f"q{i}": {f"d{i}": 1} for i in range(n_queries)}
    per_query = {"q0": ["d1", "d1", "d4", "d29"], "q1": [],
                 "q2": [f"d{j}" for j in range(12)], "q3": ["d29", "d0"]}
    spec = EncoderSpec(name="gather", dim=DIM, encode_query=_gather_enc,
                       encode_passage=_gather_enc, init=lambda s: params,
                       param_shapes={"table": (VOCAB, DIM)}, device=CPU,
                       q_max_len=2, p_max_len=2)
    outs = {}
    for name, kw in {"stream_sharded": dict(mesh=rmesh),
                     "stream_single": dict(),
                     "mat_blocked": dict(engine="materialized",
                                         rerank_block=1),
                     "mat_dense": dict(engine="materialized")}.items():
        suite = ValidationSuite(spec, [ValidationTask(
            "default", corpus, queries, qrels, sampler=_Fixed(per_query))],
            ValidationConfig(metrics=("MRR@10",), mode="rerank", k=10,
                             batch_size=8, chunk_size=6, **kw))
        run, scores, _ = suite.engine("default").run(params)
        outs[name] = (run, scores, suite.validate_params(params).metrics)
    for name, got in outs.items():
        assert got == outs["mat_dense"], f"{name} diverged"


# ---------------------------------------------------------------------------
# Padded sharded serving (tests/test_serve_parity.py:180)
# ---------------------------------------------------------------------------

def test_serve_padded_sharded_matches_unsharded(ref):
    """205 docs over 8 shards: the zero pads (3, in the last shard), the
    over-request of k + n_pad and the host filter give the unsharded
    search_run; and the reference's padded sharded run within the f32
    gate."""
    inp, _, js = ref
    ds = jcorpus.synthetic_retrieval_dataset(3, n_passages=PN,
                                             n_queries=PQ)
    spec = toy_spec(ds.vocab, device="cpu")
    params = {"table": torch.from_numpy(inp["p_table"])}
    qids = list(ds.queries)
    toks, mask = pad_batch([ds.queries[q] for q in qids], spec.q_max_len)
    q_emb = spec.encode_query(params, torch.from_numpy(toks),
                              torch.from_numpy(mask))
    runs = []
    for mesh in (None, mesh_8()):
        idx = IndexBuilder(spec, ds.corpus, ServeConfig(
            k=PK, mesh=mesh, batch_size=32)).build(params, 1)
        assert (idx.n_pad > 0) == (mesh is not None)
        assert idx.finite()
        runs.append(idx.search_run(qids, q_emb, k=PK))
    assert idx.n_pad == js["serve_n_pad"] == 3
    assert isinstance(idx.emb, shd.ShardedRows) and idx.emb.rows == 26
    assert not idx.emb.shards[-1][-3:].any()
    assert runs[1][0] == runs[0][0]
    for qid in qids:
        np.testing.assert_allclose(runs[1][1][qid], runs[0][1][qid],
                                   rtol=RTOL, atol=ATOL)
    jrun, jscores = js["serve"]
    for qid in qids:
        assert set(runs[1][0][qid]) == set(jrun[qid])
        np.testing.assert_allclose(runs[1][1][qid], jscores[qid], rtol=RTOL,
                                   atol=ATOL)


def test_serve_cuda_impl_keeps_the_padded_matrix_whole(ds):
    """Under impl="cuda" the mesh is ignored (the kernel is single-device):
    the padded matrix stays whole on the mesh's first device, and the
    over-request and pad filter still hold."""
    spec = toy_spec(ds.vocab, device="cpu")
    params = {"table": torch.from_numpy(spec.init(2)["table"])}
    corpus = dict(list(ds.corpus.items())[:61])
    qids = list(ds.queries)[:4]
    toks, mask = pad_batch([ds.queries[q] for q in qids], spec.q_max_len)
    q_emb = spec.encode_query(params, torch.from_numpy(toks),
                              torch.from_numpy(mask))
    runs = []
    for mesh in (None, mesh_8()):
        idx = IndexBuilder(spec, corpus, ServeConfig(
            k=7, mesh=mesh, impl="cuda", batch_size=16)).build(params, 1)
        runs.append(idx.search_run(qids, q_emb, k=7))
    assert isinstance(idx.emb, torch.Tensor) and idx.n_pad == 3
    assert runs[0][0] == runs[1][0]


# ---------------------------------------------------------------------------
# The fault-tolerant chunk queue (tests/test_distributed.py:113-185)
# ---------------------------------------------------------------------------

def test_make_chunks_over_decomposition():
    chunks = fault.make_chunks(list(range(100)), n_workers=4, over_factor=4)
    assert 13 <= len(chunks) <= 16
    assert [x for c in chunks for x in c.payload] == list(range(100))


def test_run_chunked_basic_order():
    out = fault.run_chunked(list(range(50)), lambda xs: [x * 2 for x in xs],
                            n_workers=3)
    assert [x for c in out for x in c] == [x * 2 for x in range(50)]


def test_run_chunked_with_straggler():
    delays = {"w0": 0.05, "w1": 0.0, "w2": 0.0, "w3": 0.0}
    out = fault.run_chunked(list(range(40)), lambda xs: [x + 1 for x in xs],
                            n_workers=4, worker_delay=lambda w: delays[w])
    assert [x for c in out for x in c] == [x + 1 for x in range(40)]


def test_run_chunked_with_injected_failures():
    out = fault.run_chunked(list(range(30)), lambda xs: list(xs),
                            n_workers=3, fail_once=(0, 2))
    assert [x for c in out for x in c] == list(range(30))


def test_run_chunked_surfaces_a_real_error():
    def boom(xs):
        raise KeyError("bad chunk")

    with pytest.raises(KeyError):
        fault.run_chunked(list(range(6)), boom, n_workers=2)


def test_workqueue_first_result_wins():
    chunks = fault.make_chunks([1, 2, 3, 4], n_workers=1, over_factor=1)
    q = fault.WorkQueue(chunks)
    c = q.acquire("a")
    c2 = q.acquire("b")
    assert c2 is not None and c2.chunk_id == c.chunk_id
    assert q.complete("a", c.chunk_id, "A") is True
    assert q.complete("b", c.chunk_id, "B") is False
    assert q.results()[0].value == "A"
    assert q.finished


def test_workqueue_permanent_failure_surfaces():
    """A chunk out of attempts is no longer handed out, not even as a
    speculative duplicate (the reference's queue raises there: ``min`` of
    an empty in-flight set)."""
    chunks = fault.make_chunks([1], n_workers=1, over_factor=1)
    q = fault.WorkQueue(chunks, max_attempts=2)
    for _ in range(2):
        c = q.acquire("w")
        q.fail("w", c.chunk_id)
    assert q.failed_chunks == [0]
    assert q.acquire("w") is None and not q.finished


def test_elastic_workers_join_mid_run():
    chunks = fault.make_chunks(list(range(20)), n_workers=2, over_factor=2)
    q = fault.WorkQueue(chunks)
    for _ in range(2):
        c = q.acquire("w1")
        q.complete("w1", c.chunk_id, sum(c.payload))
    while not q.finished:
        c = q.acquire("w2")
        if c is None:
            break
        q.complete("w2", c.chunk_id, sum(c.payload))
    assert q.finished
