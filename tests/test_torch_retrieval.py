"""The port's retrieval module against ``repro.core.retrieval``.

The same seeded numpy inputs go through both packages: ``topk_exact`` and
``retrieve_run`` at f32, bf16 and int8 (allclose, equal top-k rank sets;
the JAX side under ``impl="xla"``, and ``impl="pallas"`` in interpret mode
against the port's ``impl="cuda"``, whose wrapper takes its plain version
for CPU tensors), ``rank_candidates`` (identical runs), ``rerank_run``
(equal runs, scores within 1e-6, and the same run at every query block),
and the kernels' whole-corpus selection over several windows, emulated as
tests/test_torch_topk_mips.py emulates it, with ties across window edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoder as jencoder
from repro.core import retrieval as JR
from repro_torch.core import encoder, retrieval as R
from tests.test_torch_topk_mips import _emulate

DTYPES = ["f32", "bf16", "int8"]


def _qc(Q=8, N=500, D=24, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    c = rng.normal(size=(N, D)).astype(np.float32)
    return q, c


def _assert_same_topk(js, ji, ts, ti, tol=1e-6):
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = np.asarray(ts), np.asarray(ti)
    assert js.shape == ts.shape and ji.shape == ti.shape
    np.testing.assert_allclose(ts, js, rtol=tol, atol=tol)
    for a, b in zip(ti, ji):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("score_dtype", DTYPES)
@pytest.mark.parametrize("k,block", [(25, 64), (7, 4096), (600, 128)])
def test_topk_exact_matches_jax(score_dtype, k, block):
    q, c = _qc()
    js, ji = JR.topk_exact(jnp.asarray(q), jnp.asarray(c), k=k, block=block,
                           score_dtype=score_dtype)
    ts, ti = R.topk_exact(torch.from_numpy(q), torch.from_numpy(c), k=k,
                          block=block, score_dtype=score_dtype)
    assert ts.shape == (8, min(k, 500)) and ti.dtype == torch.int32
    _assert_same_topk(js, ji, ts, ti)


def test_topk_exact_is_block_invariant_and_stable():
    """Every block size gives the same result, ties to the earlier row:
    integer rows repeated four times tie exactly."""
    rng = np.random.default_rng(1)
    c = np.tile(rng.integers(-3, 4, size=(30, 16)), (4, 1)).astype(np.float32)
    q = torch.from_numpy(rng.integers(-3, 4, size=(5, 16))
                         .astype(np.float32))
    outs = [R.topk_exact(q, torch.from_numpy(c), k=40, block=b)
            for b in (1, 7, 64, 4096)]
    for s, i in outs[1:]:
        assert torch.equal(s, outs[0][0]) and torch.equal(i, outs[0][1])
    js, ji = JR.topk_exact(jnp.asarray(q.numpy()), jnp.asarray(c), k=40,
                           block=16)
    np.testing.assert_array_equal(outs[0][0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(outs[0][1].numpy(), np.asarray(ji))


@pytest.mark.parametrize("score_dtype", DTYPES)
@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"),
                                        ("cuda", "pallas")])
def test_retrieve_run_matches_jax(impl, jimpl, score_dtype):
    q, c = _qc(6, 300, 32, seed=2)
    qids = [f"q{i}" for i in range(6)]
    dids = [f"d{i}" for i in range(300)]
    jrun, jscores = JR.retrieve_run(qids, jnp.asarray(q), dids,
                                    jnp.asarray(c), k=10, impl=jimpl,
                                    score_dtype=score_dtype)
    run, scores = R.retrieve_run(qids, torch.from_numpy(q), dids,
                                 torch.from_numpy(c), k=10, impl=impl,
                                 score_dtype=score_dtype)
    assert list(run) == qids
    for qid in qids:
        assert set(run[qid]) == set(jrun[qid])
        np.testing.assert_allclose(scores[qid], jscores[qid], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_retrieve_run_k_above_corpus(impl):
    """A subset smaller than the cut-off returns every row (k_eff =
    min(k, N)), as the reference does."""
    q, c = _qc(3, 9, 8, seed=3)
    qids, dids = ["a", "b", "c"], [f"d{i}" for i in range(9)]
    jrun, _ = JR.retrieve_run(qids, jnp.asarray(q), dids, jnp.asarray(c),
                              k=100)
    run, _ = R.retrieve_run(qids, q, dids, c, k=100, impl=impl)
    assert run == jrun and all(len(v) == 9 for v in run.values())


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_bf16_resident_corpus_is_not_rounded_twice(impl):
    """The materialized engine keeps a bf16 corpus under score_dtype bf16;
    scoring it gives what scoring the f32 corpus at bf16 gives."""
    q, c = _qc(4, 200, 16, seed=4)
    qids, dids = [f"q{i}" for i in range(4)], [f"d{i}" for i in range(200)]
    c32 = torch.from_numpy(c)
    want = R.retrieve_run(qids, q, dids, c32, k=20, impl=impl,
                          score_dtype="bf16")
    got = R.retrieve_run(qids, q, dids, c32.to(torch.bfloat16), k=20,
                         impl=impl, score_dtype="bf16")
    assert got == want
    pq = {qid: dids[i::7] for i, qid in enumerate(qids)}
    assert R.rerank_run(qids, q, dids, c32.to(torch.bfloat16), pq, k=50,
                        score_dtype="bf16") == \
        R.rerank_run(qids, q, dids, c32, pq, k=50, score_dtype="bf16")


def test_pad_candidates_matches_jax():
    qids = ["a", "b", "c", "d"]
    dids = [f"d{i}" for i in range(10)]
    pq = {"a": ["d3", "d3", "x", "d9"], "b": [], "d": ["d0"]}
    idx, cands = R.pad_candidates(qids, dids, pq)
    jidx, jcands = JR.pad_candidates(qids, dids, pq)
    np.testing.assert_array_equal(idx, jidx)
    assert cands == jcands
    idx, _ = R.pad_candidates(qids, dids, {})
    np.testing.assert_array_equal(idx, JR.pad_candidates(qids, dids, {})[0])


_RANK_CASES = {
    # duplicate slots, exact ties, -inf pads, k above the list
    "ties_and_pads": (np.asarray([[1.0, 3.0, 3.0, -np.inf],
                                  [2.0, 2.0, 2.0, 2.0],
                                  [-np.inf, -np.inf, -np.inf, -np.inf]],
                                 np.float32),
                      [["x", "y", "y"], ["p", "q", "p", "r"], []], 9),
    "k_cuts": (np.asarray([[0.5, 0.25, 0.5, 1.0]], np.float32),
               [["a", "b", "c", "d"]], 2),
    "pads_never_surface": (np.asarray([[3.0, -np.inf], [1.0, 2.0]],
                                      np.float32), [["x"], ["y", "z"]], 9),
}


@pytest.mark.parametrize("case", sorted(_RANK_CASES))
def test_rank_candidates_matches_jax(case):
    s, cands, k = _RANK_CASES[case]
    qids = [f"q{i}" for i in range(len(cands))]
    want = JR.rank_candidates(qids, s, cands, k=k)
    assert R.rank_candidates(qids, s, cands, k=k) == want
    assert R.rank_candidates(qids, torch.from_numpy(s), cands, k=k) == want


@pytest.mark.parametrize("score_dtype", DTYPES)
def test_rerank_run_matches_jax(score_dtype):
    q, c = _qc(5, 60, 12, seed=5)
    qids = [f"q{i}" for i in range(5)]
    dids = [f"d{i}" for i in range(60)]
    rng = np.random.default_rng(6)
    pq = {qid: [f"d{j}" for j in rng.integers(0, 64, size=m)]
          for qid, m in zip(qids, (7, 0, 20, 3, 12))}
    pq["q3"] += pq["q3"][:1]                        # a duplicate id
    jrun, jscores = JR.rerank_run(qids, jnp.asarray(q), dids, jnp.asarray(c),
                                  pq, k=10, score_dtype=score_dtype)
    runs = []
    for qb in (1, 3, 5, None):
        run, scores = R.rerank_run(qids, torch.from_numpy(q), dids,
                                   torch.from_numpy(c), pq, k=10, q_block=qb,
                                   score_dtype=score_dtype)
        runs.append((run, scores))
        assert run == jrun, qb
        for qid in qids:
            np.testing.assert_allclose(scores[qid], jscores[qid], rtol=1e-6,
                                       atol=1e-6)
    assert all(r == runs[0] for r in runs)
    empty = {qid: [] for qid in qids}
    assert R.rerank_run(qids, q, dids, c, {}, k=10) == (empty, empty)


def test_rerank_block_rows_sizing():
    assert R.rerank_block_rows(None, n_queries=7000, c_max=1000, dim=768) \
        == (256 << 20) // (1000 * 768 * 4)
    assert R.rerank_block_rows(None, n_queries=3, c_max=1, dim=1) == 3
    assert R.rerank_block_rows(0, n_queries=3, c_max=1, dim=1) == 1
    assert R.rerank_block_rows(50, n_queries=3, c_max=1, dim=1) == 3


@pytest.mark.parametrize("score_dtype", DTYPES)
def test_whole_corpus_windows_fold_ties_to_earlier_rows(score_dtype):
    """The materialized engine's ``retrieve_run(impl="cuda")`` is one
    ``topk_mips`` call over the whole corpus, which the wrapper cuts into
    windows folded through a carry.  Emulated with a candidate budget that
    makes five windows, over integer rows repeated so that equal scores
    straddle every window edge: the earlier row wins each tie, as in the
    JAX package's whole-corpus top-k."""
    rng = np.random.default_rng(8)
    base = rng.integers(-3, 4, size=(90, 32)).astype(np.float32)
    c = np.concatenate([base, base[::-1], base, base[::-1]])   # 360 rows
    q = rng.integers(-3, 4, size=(6, 32)).astype(np.float32)
    k = 40
    from repro_torch.kernels.topk_mips import ops
    plan = ops._windows(len(c), k, 0, 32, 128)
    assert len(plan) > 4
    ts, ti = _emulate(score_dtype, torch.from_numpy(q), torch.from_numpy(c),
                      k_target=k, n_valid=len(c), max_cand=128)
    js, ji = JR.topk_exact(jnp.asarray(q), jnp.asarray(c), k=k,
                           score_dtype=score_dtype)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_encode_corpus_dict_matches_jax():
    table = np.random.default_rng(9).normal(size=(40, 6)).astype(np.float32)

    def tenc(params, tokens, mask):
        emb = params["t"][tokens]
        return (emb * mask.to(emb.dtype)[..., None]).sum(1)

    def jenc(params, tokens, mask):
        emb = jnp.take(params["t"], tokens, axis=0)
        return (emb * mask.astype(emb.dtype)[..., None]).sum(1)

    corpus = {f"d{i}": [1 + i % 30, 2 + i % 7] for i in range(11)}
    ids, embs, stats = encoder.encode_corpus_dict(
        tenc, {"t": torch.from_numpy(table)}, corpus, max_len=4,
        batch_size=4, subset_ids=["d3", "d0", "d9"], device="cpu")
    jids, jembs, jstats = jencoder.encode_corpus_dict(
        jenc, {"t": jnp.asarray(table)}, corpus, max_len=4, batch_size=4,
        subset_ids=["d3", "d0", "d9"])
    assert ids == jids and stats.n_batches == jstats.n_batches == 1
    np.testing.assert_allclose(embs, jembs, rtol=1e-6, atol=1e-6)
    ids, embs, _ = encoder.encode_corpus_dict(
        tenc, {"t": torch.from_numpy(table)}, corpus, max_len=4,
        batch_size=4, device="cpu")
    assert ids == list(corpus) and embs.shape == (11, 6)


@pytest.mark.parametrize("D", [1, 5, 64, 768])
def test_fixed_order_dots_do_not_depend_on_the_batch(D):
    """Each dot product of the rerank path is summed by one fixed tree, so
    any slice of queries or candidates gives the same bits, within f32
    rounding of the exact product."""
    rng = np.random.default_rng(D)
    rows = torch.from_numpy(rng.normal(size=(6, 9, D)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(6, D)).astype(np.float32))
    full = R.fixed_order_dots(rows, q)
    assert full.shape == (6, 9) and full.dtype == torch.float32
    assert torch.equal(R.fixed_order_dots(rows[2:3], q[2:3]), full[2:3])
    assert torch.equal(R.fixed_order_dots(rows[:, 4:], q), full[:, 4:])
    exact = np.einsum("bcd,bd->bc", rows.double().numpy(), q.double().numpy())
    np.testing.assert_allclose(full.numpy(), exact, rtol=1e-5, atol=1e-5)
