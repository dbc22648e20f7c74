"""The port's recommenders (bert4rec, sasrec, mind, deepfm) and embedding
ops against the JAX package's, on the CPU.

The JAX-initialised parameters of each smoke config (``nn.materialize(
rcs.init(...))`` as numpy) and the same seeded numpy batches go through
``loss_fn``, ``serve_fn`` and ``item_embeddings`` of both packages.  At
compute f32 losses, scores and embeddings agree within atol 2e-5 (f32 sums
in another order); at the configs' bf16 the losses agree within 2e-2 and
the scores by a per-row cosine of at least 0.999.  ``hash_bucket`` must be
bit-equal, and the embedding bags agree within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import embedding_ops as jemb
from repro.models import nn as jnn
from repro.models import recsys as jrcs
from repro_torch.configs import registry
from repro_torch.models import embedding_ops as emb
from repro_torch.models import nn
from repro_torch.models import recsys as rcs

ARCHS = ["bert4rec", "sasrec", "mind", "deepfm"]
ATOL = 2e-5
_SMALL = {"item_vocab": 500, "seq_len": 16, "n_negatives": 32,
          "n_serve_candidates": 20}


def _configs(arch: str, dt: str = "f32"):
    kw = {} if arch == "deepfm" else dict(_SMALL)
    jc = dataclasses.replace(jregistry.get(arch).smoke_config(), **kw)
    tc = dataclasses.replace(registry.get(arch).smoke_config(), **kw)
    if dt == "f32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    return jc, tc


_TREES = {}


def _tree(arch: str):
    if arch not in _TREES:
        jc, _ = _configs(arch)
        tree = jnn.materialize(jrcs.init(jax.random.PRNGKey(0), jc))
        _TREES[arch] = jax.tree_util.tree_map(np.asarray, tree)
    return _TREES[arch]


def _batch(cfg, B=4, seed=1):
    """The reference's test batches (numpy), with padding in sasrec and
    mind histories so the key masks matter."""
    rng = np.random.default_rng(seed)
    S, V = cfg.seq_len, cfg.item_vocab
    if cfg.model_type == "sasrec":
        hist = rng.integers(1, V, (B, S)).astype(np.int32)
        hist[1, 10:] = 0
        pos = rng.integers(1, V, (B, S)).astype(np.int32)
        pos[2, 5:] = 0
        return {"hist": hist, "pos": pos,
                "neg_ids": rng.integers(1, V, (cfg.n_negatives,))
                .astype(np.int32)}
    if cfg.model_type == "bert4rec":
        M = 4
        tokens = rng.integers(1, V, (B, S)).astype(np.int32)
        tokens[3, 12:] = 0
        mlm_mask = np.ones((B, M), np.float32)
        mlm_mask[0, 3] = 0
        return {"tokens": tokens,
                "mlm_positions": rng.integers(0, S, (B, M)).astype(np.int32),
                "mlm_labels": rng.integers(1, V, (B, M)).astype(np.int32),
                "mlm_mask": mlm_mask,
                "neg_ids": rng.integers(1, V, (cfg.n_negatives,))
                .astype(np.int32)}
    if cfg.model_type == "mind":
        hist = rng.integers(1, V, (B, S)).astype(np.int32)
        hist[0, 7:] = 0
        return {"hist": hist,
                "target": rng.integers(1, V, (B,)).astype(np.int32),
                "neg_ids": rng.integers(1, V, (cfg.n_negatives,))
                .astype(np.int32)}
    F, M = cfg.n_fields, cfg.max_hot
    valid = rng.random((B, F, M)) < 0.7
    valid[:, :, 0] = True
    return {"ids": rng.integers(0, cfg.total_rows, (B, F, M))
            .astype(np.int32), "valid": valid,
            "label": rng.integers(0, 2, (B,)).astype(np.float32)}


def _serve_batch(cfg, B=3, seed=2):
    if cfg.model_type == "deepfm":
        return {k: v for k, v in _batch(cfg, B=B, seed=seed).items()
                if k != "label"}
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, cfg.item_vocab, (B, cfg.seq_len)).astype(np.int32)
    hist[-1, 3:] = 0
    return {"hist": hist,
            "cand_ids": rng.integers(1, cfg.item_vocab,
                                     (cfg.n_serve_candidates,))
            .astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    jc, tc = _configs(arch)
    tree = _tree(arch)
    batch = _batch(jc)
    jl, jm = jrcs.loss_fn(tree, jc, _j(batch))
    tl, tm = rcs.loss_fn(nn.to_torch_tree(tree), tc, _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_fn_matches_jax(arch):
    jc, tc = _configs(arch)
    tree = _tree(arch)
    batch = _serve_batch(jc)
    want = jrcs.serve_fn(tree, jc, _j(batch))
    got = rcs.serve_fn(nn.to_torch_tree(tree), tc, _t(batch))
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_scores(arch):
    """The configs' own compute dtype (bf16)."""
    jc, tc = _configs(arch, "bf16")
    tree = _tree(arch)
    params = nn.to_torch_tree(tree)
    batch = _batch(jc, seed=3)
    jl, _ = jrcs.loss_fn(tree, jc, _j(batch))
    tl, _ = rcs.loss_fn(params, tc, _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), atol=2e-2, rtol=0)
    sb = _serve_batch(jc, seed=4)
    want = _np(jrcs.serve_fn(tree, jc, _j(sb)))
    got = _np(rcs.serve_fn(params, tc, _t(sb)))
    if want.ndim == 1:                      # deepfm: one logit a row
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
        return
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos.min()


@pytest.mark.parametrize("arch", ARCHS)
def test_item_embeddings_and_user_embed(arch):
    jc, tc = _configs(arch)
    tree = _tree(arch)
    params = nn.to_torch_tree(tree)
    if arch == "deepfm":
        with pytest.raises(KeyError):
            rcs.item_embeddings(params, tc, torch.arange(3))
        return
    ids = np.arange(0, jc.item_vocab, 7, dtype=np.int32)
    want = jrcs.item_embeddings(tree, jc, jnp.asarray(ids))
    got = rcs.item_embeddings(params, tc, torch.from_numpy(ids))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    hist = _serve_batch(jc)["hist"]
    want = jrcs.user_embed(tree, jc, jnp.asarray(hist))
    got = rcs.user_embed(params, tc, torch.from_numpy(hist))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("iters", [1, 3])
def test_capsule_routing_matches_jax(iters):
    rng = np.random.default_rng(5)
    B, S, K, D = 3, 9, 4, 16
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = rng.random((B, S)) < 0.7
    mask[:, 0] = True
    init = rng.standard_normal((K, S)).astype(np.float32)
    w = (rng.standard_normal((D, D)) / 4).astype(np.float32)
    want = jrcs.capsule_routing(*map(jnp.asarray, (h, mask, init, w)),
                                iters)
    got = rcs.capsule_routing(*map(torch.from_numpy, (h, mask, init, w)),
                              iters)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    z = rng.standard_normal((B, K, D)).astype(np.float32)
    np.testing.assert_allclose(_np(rcs._squash(torch.from_numpy(z))),
                               _np(jrcs._squash(jnp.asarray(z))),
                               atol=1e-6, rtol=0)


def test_label_aware_user_and_sampled_softmax_match_jax():
    rng = np.random.default_rng(6)
    u = rng.standard_normal((4, 3, 8)).astype(np.float32)
    t = rng.standard_normal((4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        _np(rcs._label_aware_user(torch.from_numpy(u), torch.from_numpy(t))),
        _np(jrcs._label_aware_user(jnp.asarray(u), jnp.asarray(t))),
        atol=1e-6, rtol=0)
    uv, pos = (rng.standard_normal((4, 5, 8)).astype(np.float32)
               for _ in range(2))
    neg = rng.standard_normal((11, 8)).astype(np.float32)
    mask = rng.random((4, 5)) < 0.6
    for m in (None, mask):
        jl, jn = jrcs._sampled_softmax(*map(jnp.asarray, (uv, pos, neg)),
                                       None if m is None else
                                       jnp.asarray(m))
        tl, tn = rcs._sampled_softmax(*map(torch.from_numpy, (uv, pos, neg)),
                                      None if m is None else
                                      torch.from_numpy(m))
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-6)
        np.testing.assert_allclose(_np(tn), _np(jn), atol=1e-5, rtol=0)


def test_hash_bucket_bit_equal():
    rng = np.random.default_rng(7)
    ids = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 5000),
                          [0, 1, -1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    for n_rows in (1, 7, 1_000_003, 2 ** 31 - 1):
        for salt in (0, 3, 2 ** 32 - 1):
            want = np.asarray(jemb.hash_bucket(jnp.asarray(ids), n_rows,
                                               salt))
            got = emb.hash_bucket(torch.from_numpy(ids), n_rows, salt).numpy()
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_jax(mode, masked, weighted):
    rng = np.random.default_rng(8)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (40,)).astype(np.int32)
    seg = rng.integers(0, 9, (40,)).astype(np.int32)
    seg[seg == 4] = 5                       # bag 4 stays empty
    valid = rng.random(40) > 0.25
    weights = rng.random(40).astype(np.float32)
    kw_j = {"mode": mode, "valid": jnp.asarray(valid) if masked else None,
            "weights": jnp.asarray(weights) if weighted else None}
    kw_t = {"mode": mode, "valid": torch.from_numpy(valid) if masked
            else None, "weights": torch.from_numpy(weights) if weighted
            else None}
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(seg), 9, **kw_j)
    got = emb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(seg), 9, **kw_t)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    assert not got[4].any()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_multi_hot_bag_matches_jax(mode):
    rng = np.random.default_rng(9)
    table = rng.standard_normal((30, 6)).astype(np.float32)
    ids = rng.integers(0, 30, (4, 3, 5)).astype(np.int32)
    valid = rng.random((4, 3, 5)) < 0.5
    valid[0, 1] = False                      # an empty bag
    for cd in (None, jnp.bfloat16):
        want = jemb.multi_hot_bag(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(valid), mode=mode,
                                  compute_dtype=cd)
        got = emb.multi_hot_bag(torch.from_numpy(table),
                                torch.from_numpy(ids),
                                torch.from_numpy(valid), mode=mode,
                                compute_dtype=None if cd is None
                                else torch.bfloat16)
        tol = 1e-6 if cd is None else 2e-2
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def test_embedding_lookup_and_table_init():
    rng = np.random.default_rng(10)
    table = emb.embedding_table_init(rng, 20, 4, stddev=0.5)
    assert table.shape == (20, 4) and table.dtype == np.float32
    ids = np.array([3, 0, 19, 3], np.int32)
    want = jemb.embedding_lookup(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.bfloat16)
    got = emb.embedding_lookup(torch.from_numpy(table),
                               torch.from_numpy(ids), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_dtypes_match_reference_full_config(arch):
    """The full configs' trees (deepfm's 33.8M-row tables, the 10^6-item
    tables) without allocating them, dtypes included."""
    jc = jregistry.get(arch).full_config()
    jshapes, _ = jnn.abstract_init(jrcs.init, jax.random.PRNGKey(0), jc)
    tc = registry.get(arch).full_config()
    assert rcs.param_shapes(tc) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jshapes)
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    assert rcs.param_dtypes(tc) == jax.tree_util.tree_map(
        lambda s: dt[s.dtype.type], jshapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_numpy_runs_the_models(arch):
    """The port's own seeded parameters have the template's structure and
    give finite losses."""
    _, tc = _configs(arch)
    tree = rcs.init_numpy(tc, 3)
    flat = jax.tree_util.tree_leaves(tree)
    shapes = jax.tree_util.tree_leaves(
        rcs.param_shapes(tc), is_leaf=lambda x: isinstance(x, tuple))
    assert [a.shape for a in flat] == [tuple(s) for s in shapes]
    loss, _ = rcs.loss_fn(nn.to_torch_tree(tree), tc,
                          _t(_batch(tc)))
    assert np.isfinite(float(loss))


def test_registry_matches_reference():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.ASSIGNED_ARCH_IDS == jregistry.ASSIGNED_ARCH_IDS
    assert registry.RECSYS_SHAPES == jregistry.RECSYS_SHAPES
    assert registry.GNN_SHAPES == jregistry.GNN_SHAPES
    assert registry.LM_SHAPES == jregistry.LM_SHAPES
    assert registry.BIENCODER_SHAPES == jregistry.BIENCODER_SHAPES
    for arch in registry.ARCH_IDS:
        spec, jspec = registry.get(arch), jregistry.get(arch)
        assert spec.family == jspec.family and spec.shapes == jspec.shapes
        for which in ("smoke_config", "full_config"):
            got, want = getattr(spec, which)(), getattr(jspec, which)()
            assert type(got).__name__ == type(want).__name__
            for f in dataclasses.fields(got):
                value, ref = getattr(got, f.name), getattr(want, f.name)
                if isinstance(value, torch.dtype):
                    continue
                if f.name == "attn_impl":       # the port's names
                    ref = {"xla": "torch", "pallas": "cuda"}[ref]
                assert value == ref, (arch, f.name)
