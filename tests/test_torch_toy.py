"""The port's toy retriever (``repro_torch.models.toy``) against the JAX
package's (``benchmarks/common.py``).

The same seeded numpy table and token batches go through both packages'
``toy_encode`` (allclose 1e-6) and through 20 SGD steps of their
``contrastive_step`` / ``train_toy_dr`` from one initial table (losses and
the tables within 1e-5: float32 sums in another order drift the table by
about 3e-7 over 20 steps at lr 0.5).  The port's ``init`` draws from a
numpy seed (a divergence by design), so both trainings start from the table
the test hands them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jtoy
from repro.data import corpus as jcorpus
from repro_torch.data import corpus as corpus_lib
from repro_torch.models import toy

ENC_TOL = 1e-6
TRAIN_TOL = 1e-5
STEPS = 20


@pytest.fixture(scope="module")
def ds():
    return corpus_lib.synthetic_retrieval_dataset(0, n_passages=180,
                                                  n_queries=10)


def _table(vocab, seed=3):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (vocab, toy.DIM))).astype(np.float32)


def test_dataset_is_the_reference_dataset(ds):
    ref = jcorpus.synthetic_retrieval_dataset(0, n_passages=180, n_queries=10)
    assert ds.corpus == ref.corpus and ds.queries == ref.queries
    assert ds.qrels == ref.qrels and ds.vocab == ref.vocab


@pytest.mark.parametrize("max_len", [1, 10, 26])
def test_toy_encode_matches_jax(ds, max_len):
    table = _table(ds.vocab)
    texts = list(ds.corpus.values())[:40] + [[], [5]]
    toks, mask = corpus_lib.pad_batch(texts, max_len)
    want = np.asarray(jtoy.toy_encode({"table": jnp.asarray(table)},
                                      jnp.asarray(toks), jnp.asarray(mask)))
    got = toy.toy_encode({"table": torch.from_numpy(table)},
                         torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=ENC_TOL, atol=ENC_TOL)
    # an all-padding row encodes to zeros on both sides
    np.testing.assert_array_equal(got.numpy()[-2], 0.0)


def test_toy_spec_matches_jax_spec(ds):
    spec = toy.toy_spec(ds.vocab, device="cpu")
    ref = jtoy.toy_spec(ds.vocab)
    assert (spec.name, spec.dim, spec.q_max_len, spec.p_max_len) == \
        (ref.name, ref.dim, ref.q_max_len, ref.p_max_len)
    assert spec.param_shapes == {"table": (ds.vocab, toy.DIM)}
    init = spec.init(0)
    assert init["table"].shape == (ds.vocab, toy.DIM)
    assert init["table"].dtype == np.float32
    np.testing.assert_array_equal(init["table"], spec.init(0)["table"])
    assert not np.array_equal(init["table"], spec.init(1)["table"])
    assert spec.device == torch.device("cpu")
    assert toy.toy_spec(ds.vocab).device == torch.device("cuda")


def _batches(ds, spec, steps, seed=0, batch=32):
    """The batches ``train_toy_dr`` draws (numpy tokens)."""
    qids = sorted(ds.qrels)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        pick = rng.choice(len(qids), size=batch)
        qt, qm = corpus_lib.pad_batch([ds.queries[qids[j]] for j in pick],
                                      spec.q_max_len)
        pt, pm = corpus_lib.pad_batch(
            [ds.corpus[next(iter(ds.qrels[qids[j]]))] for j in pick],
            spec.p_max_len)
        out.append({"q_tokens": qt, "q_mask": qm, "p_tokens": pt,
                    "p_mask": pm})
    return out


def test_contrastive_loss_curve_matches_jax(ds):
    spec = toy.toy_spec(ds.vocab, device="cpu")
    jspec = jtoy.toy_spec(ds.vocab)
    step, jstep = toy.contrastive_step(spec), jtoy.contrastive_step(jspec)
    table = _table(ds.vocab)
    params = {"table": torch.from_numpy(table.copy())}
    jparams = {"table": jnp.asarray(table)}
    losses, jlosses = [], []
    for b in _batches(ds, spec, STEPS):
        params, loss = step(params, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        jparams, jloss = jstep(jparams, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        losses.append(float(loss))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    assert losses[-1] < losses[0]               # it learns
    np.testing.assert_allclose(params["table"].numpy(),
                               np.asarray(jparams["table"]),
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    assert params["table"].dtype == torch.float32
    assert not params["table"].requires_grad


def test_train_toy_dr_matches_jax(ds):
    """Both packages' ``train_toy_dr`` from one initial table: the same
    batches, snapshots at the same steps, tables within the tolerance."""
    table = _table(ds.vocab, seed=5)
    spec = toy.toy_spec(ds.vocab, device="cpu")
    jspec = dataclasses.replace(jtoy.toy_spec(ds.vocab),
                                init=lambda rng: {"table": jnp.asarray(table)})
    params, snaps = toy.train_toy_dr(ds, spec, steps=STEPS,
                                     snapshot_every=10,
                                     params={"table": table})
    jparams, jsnaps = jtoy.train_toy_dr(ds, jspec, steps=STEPS,
                                        snapshot_every=10)
    assert [s for s, _ in snaps] == [s for s, _ in jsnaps] == [0, 10, 20]
    np.testing.assert_array_equal(snaps[0][1]["table"].numpy(), table)
    for (_, p), (_, jp) in zip(snaps, jsnaps):
        np.testing.assert_allclose(p["table"].numpy(),
                                   np.asarray(jp["table"]),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL)
    assert snaps[-1][1] is params


def test_train_toy_dr_default_init_is_spec_init(ds):
    spec = toy.toy_spec(ds.vocab, device="cpu")
    _, snaps = toy.train_toy_dr(ds, spec, steps=1, seed=4)
    np.testing.assert_array_equal(snaps[0][1]["table"].numpy(),
                                  spec.init(4)["table"])
