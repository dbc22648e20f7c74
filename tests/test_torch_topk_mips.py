"""The port's topk_mips wrapper against the JAX package's, on the CPU.

Both sides get the same numpy inputs (seeded).  The JAX side runs its Pallas
kernel in interpret mode, as its own tests do; the port's wrapper runs its
plain version because the tensors are on the CPU.

Tolerances: f32 and bf16 scores within 1e-5 (the two sides sum in different
orders) with equal top-k rank sets; int8 images and raw int32 scores equal,
dequantized scores within rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_mips import ops as jops
from repro_torch.kernels.topk_mips import ops, ref

SHAPES = [(4, 300, 17, 10), (128, 2048, 128, 100), (7, 50, 64, 60),
          (1, 4096, 256, 1), (33, 1000, 96, 128)]
NARROW_SHAPES = [(4, 300, 17, 10), (16, 1024, 128, 50), (7, 50, 64, 60)]


def _inputs(Q, N, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


def _assert_same_topk(js, ji, ts, ti, rtol):
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = ts.numpy(), ti.numpy()
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=rtol)
    for r in range(js.shape[0]):
        assert set(ti[r]) == set(ji[r])


@pytest.mark.parametrize("score_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Q,N,D,k", SHAPES)
def test_topk_mips_matches_jax(Q, N, D, k, score_dtype):
    q, c = _inputs(Q, N, D)
    js, ji = jops.topk_mips(jnp.asarray(q), jnp.asarray(c), k=k,
                            score_dtype=score_dtype)
    ts, ti = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=k,
                           score_dtype=score_dtype)
    _assert_same_topk(js, ji, ts, ti, 1e-5)


@pytest.mark.parametrize("Q,N,D,k", NARROW_SHAPES)
def test_topk_mips_int8_matches_jax(Q, N, D, k):
    q, c = _inputs(Q, N, D, seed=1)
    jqv, jqs = (np.asarray(a) for a in jops.quantize_int8(jnp.asarray(q)))
    jcv, jcs = (np.asarray(a) for a in jops.quantize_int8(jnp.asarray(c)))
    tqv, tqs = ops.quantize_int8(torch.from_numpy(q))
    tcv, tcs = ops.quantize_int8(torch.from_numpy(c))
    np.testing.assert_array_equal(tqv.numpy(), jqv)       # int8 images
    np.testing.assert_array_equal(tcv.numpy(), jcv)
    np.testing.assert_array_equal(tqs.numpy(), jqs)
    raw_j = jqv.astype(np.int32) @ jcv.astype(np.int32).T
    raw_t = (tqv.double() @ tcv.double().T).numpy()
    np.testing.assert_array_equal(raw_t.astype(np.int32), raw_j)
    js, ji = jops.topk_mips(jnp.asarray(q), jnp.asarray(c), k=k,
                            score_dtype="int8")
    ts, ti = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=k,
                           score_dtype="int8")
    _assert_same_topk(js, ji, ts, ti, 1e-6)


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_topk_mips_chunk_carry_matches_jax(score_dtype):
    """Fold a corpus chunk by chunk into the (Q, k) carry, ragged tail
    included, on both sides."""
    Q, D, k, chunk = 9, 48, 20, 64
    q, c = _inputs(Q, 200, D, seed=2)
    jrun = (jnp.full((Q, k), -jnp.inf, jnp.float32),
            jnp.zeros((Q, k), jnp.int32))
    trun = (torch.full((Q, k), float("-inf")),
            torch.zeros((Q, k), dtype=torch.int32))
    for base in range(0, 200, chunk):
        part = np.zeros((chunk, D), np.float32)
        n_valid = min(chunk, 200 - base)
        part[:n_valid] = c[base:base + n_valid]
        part[n_valid:] = 1e3                    # padding rows must not win
        jrun = jops.topk_mips_chunk(jnp.asarray(q), jnp.asarray(part),
                                    *jrun, base=base, n_valid=n_valid,
                                    score_dtype=score_dtype)
        trun = ops.topk_mips_chunk(torch.from_numpy(q),
                                   torch.from_numpy(part), *trun, base=base,
                                   n_valid=n_valid, score_dtype=score_dtype)
    _assert_same_topk(*jrun, *trun, 1e-5 if score_dtype != "int8" else 1e-6)
    assert trun[1].max() < 200


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_topk_mips_duplicate_rows_tie_order(score_dtype):
    """Every corpus row appears 4 times with integer values, so scores tie
    exactly: the lower index must win, as lax.top_k orders them."""
    rng = np.random.default_rng(3)
    q = rng.integers(-3, 4, size=(6, 32)).astype(np.float32)
    c = np.tile(rng.integers(-3, 4, size=(25, 32)).astype(np.float32),
                (4, 1))
    js, ji = jops.topk_mips(jnp.asarray(q), jnp.asarray(c), k=30,
                            score_dtype=score_dtype)
    ts, ti = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=30,
                           score_dtype=score_dtype)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_topk_mips_n_valid_and_k_clipping():
    q, c = _inputs(5, 40, 16, seed=4)
    s, i = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=60,
                         n_valid=30)
    assert s.shape == (5, 30) and int(i.max()) < 30


def test_wrapper_dispatch_is_by_device():
    """CPU tensors take the plain version; other devices and oversized k
    raise rather than fall back."""
    q = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.topk_mips(q, q, k=1)
    with pytest.raises(ValueError, match="maximum"):
        ops.topk_mips(torch.zeros(2, 8), torch.zeros(3, 8), k=ops.MAX_K + 1)
    before = dict(ops.launches)
    ops.topk_mips(torch.zeros(2, 8), torch.zeros(3, 8), k=2)
    assert ops.launches == before           # the plain version launches none


def test_plain_select_is_stable():
    s = torch.tensor([[1.0, 2.0, 2.0, 1.0, 2.0]])
    i = torch.arange(5, dtype=torch.int32)[None]
    top_s, top_i = ref.select_topk(s, i, 4)
    assert top_i.tolist() == [[1, 2, 4, 0]]


@pytest.mark.parametrize("k,n_valid,carry", [(5, 500, False), (30, 437, True),
                                             (64, 64, False), (3, 1, True)])
def test_window_plan_folds_to_the_whole_corpus_top_k(k, n_valid, carry):
    """The CUDA wrapper's window plan, replayed with the plain version at a
    tiny block geometry (8 columns, 64 candidates): folding window by
    window into the carry gives the top k of carry + whole corpus, and no
    launch exceeds pass 2's candidate budget."""
    cn, max_cand, base = 8, 64, 1000
    q, c = (torch.from_numpy(a) for a in _inputs(3, 500, 12, seed=5))
    init = (torch.randn(3, k).sort(dim=1, descending=True).values,
            torch.arange(k, dtype=torch.int32).expand(3, -1))
    run = init if carry else None
    plan = ops._windows(500, n_valid, k, k if carry else 0, cn, max_cand)
    assert plan[0][0] == 0 and sum(w[2] for w in plan) == n_valid
    for w0, width, nv, kc, k_out in plan:
        assert kc + -(-width // cn) * min(k, cn) <= max_cand
        s = ref.scores_ref(q, c[w0:w0 + width])[:, :nv]
        i = (torch.arange(nv, dtype=torch.int32) + base + w0).expand(3, -1)
        run = ref.select_topk(s, i, k_out) if run is None else \
            ref.select_topk(torch.cat([run[0], s], 1),
                            torch.cat([run[1], i], 1), k_out)
    s = ref.scores_ref(q, c)[:, :n_valid]
    i = (torch.arange(n_valid, dtype=torch.int32) + base).expand(3, -1)
    if carry:
        want = ref.select_topk(torch.cat([init[0], s], 1),
                               torch.cat([init[1], i], 1), k)
    else:
        want = ref.select_topk(s, i, min(k, n_valid))
    assert torch.equal(run[0], want[0]) and torch.equal(run[1], want[1])
