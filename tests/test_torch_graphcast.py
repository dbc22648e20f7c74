"""The port's GraphCast GNN, neighbour sampler and synthetic batches
against the JAX package's, on the CPU.

The JAX-initialised parameters of the smoke config (as numpy) and the same
seeded numpy graphs go through ``forward``, ``loss_fn`` and
``encode_nodes`` of both packages: at compute f32 within atol 2e-5 (f32
sums in another order; the port sums each node's messages in edge order),
at the config's bf16 the node latents by a per-row cosine of at least
0.999.  The sampler
and every ``synthetic`` builder, given generators of one seed, return
bit-equal arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import sampler as jsampler
from repro.data import synthetic as jsynth
from repro.models import graphcast as jgc
from repro.models import nn as jnn
from repro_torch.configs import registry
from repro_torch.data import sampler, synthetic
from repro_torch.models import graphcast as gc
from repro_torch.models import nn

ATOL = 2e-5


def _configs(dt: str = "f32", **kw):
    jc = dataclasses.replace(jregistry.get("graphcast").smoke_config(), **kw)
    tc = dataclasses.replace(registry.get("graphcast").smoke_config(), **kw)
    if dt == "f32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    return jc, tc


_TREES = {}


def _tree(seed: int = 0):
    if seed not in _TREES:
        jc, _ = _configs()
        tree = jnn.materialize(jgc.init(jax.random.PRNGKey(seed), jc))
        _TREES[seed] = jax.tree_util.tree_map(np.asarray, tree)
    return _TREES[seed]


def _graph(cfg, n=20, e=60, seed=5):
    rng = np.random.default_rng(seed)
    return {"node_feat": rng.standard_normal((n, cfg.d_feat))
            .astype(np.float32),
            "src": rng.integers(0, n, (e,)).astype(np.int32),
            "dst": rng.integers(0, n, (e,)).astype(np.int32),
            "target": rng.standard_normal((n, cfg.n_vars)).astype(np.float32)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _args(g, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(g[k]) for k in ("node_feat", "src", "dst")]


@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
def test_forward_matches_jax(aggregator):
    jc, tc = _configs(aggregator=aggregator)
    tree = _tree()
    # every node has an incoming edge (max of nothing is -inf)
    g = _graph(jc, n=12, e=40)
    g["dst"][:12] = np.arange(12)
    want = jgc.forward(tree, jc, *_args(g, "jax"))
    got = gc.forward(nn.to_torch_tree(tree), tc, *_args(g, "torch"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (12, jc.n_vars)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
def test_aggregate_matches_jax(aggregator):
    rng = np.random.default_rng(11)
    msgs = rng.standard_normal((50, 6)).astype(np.float32)
    dst = rng.integers(0, 9, (50,)).astype(np.int32)
    dst[dst == 3] = 2                        # node 3 receives nothing
    want = jgc._aggregate(jnp.asarray(msgs), jnp.asarray(dst), 9, aggregator)
    got = gc._aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), 9,
                        aggregator)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)


def test_loss_fn_with_and_without_node_mask():
    jc, tc = _configs()
    tree = _tree()
    params = nn.to_torch_tree(tree)
    g = _graph(jc)
    mask = np.random.default_rng(12).random(20) < 0.6
    for m in (None, mask):
        jb = {k: jnp.asarray(v) for k, v in g.items()}
        tb = {k: torch.from_numpy(v) for k, v in g.items()}
        if m is not None:
            jb["node_mask"], tb["node_mask"] = jnp.asarray(m), \
                torch.from_numpy(m)
        jl, _ = jgc.loss_fn(tree, jc, jb)
        tl, metrics = gc.loss_fn(params, tc, tb)
        assert metrics == {}
        np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)


def test_encode_nodes_matches_jax():
    jc, tc = _configs()
    tree = _tree(1)
    g = _graph(jc, n=15, e=33, seed=6)
    want = jgc.encode_nodes(tree, jc, *_args(g, "jax"))
    got = gc.encode_nodes(nn.to_torch_tree(tree), tc, *_args(g, "torch"))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0,
                               rtol=1e-5)


def test_bf16_forward_cosine():
    """The node latents (d_hidden wide) by row cosine; the 7 predictions
    of a node, values near 2.4 where a bf16 ulp is 2**-6, within 2**-3."""
    jc, tc = _configs("bf16")
    tree = _tree()
    params = nn.to_torch_tree(tree)
    g = _graph(jc, n=30, e=90, seed=7)
    want = _np(jgc.encode_nodes(tree, jc, *_args(g, "jax")))
    got = _np(gc.encode_nodes(params, tc, *_args(g, "torch")))
    assert (got * want).sum(-1).min() >= 0.999
    want = _np(jgc.forward(tree, jc, *_args(g, "jax")))
    got = _np(gc.forward(params, tc, *_args(g, "torch")))
    np.testing.assert_allclose(got, want, atol=2.0 ** -3, rtol=0)


def test_isolated_node_invariance():
    """A node with no incident edges is moved only by its own MLP path."""
    _, tc = _configs()
    params = nn.to_torch_tree(_tree())
    rng = np.random.default_rng(6)
    feat = torch.from_numpy(rng.standard_normal((10, tc.d_feat))
                            .astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 5, (20,)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 5, (20,)).astype(np.int32))
    p1 = gc.forward(params, tc, feat, src, dst)
    feat2 = feat.clone()
    feat2[0] = 0.0
    p2 = gc.forward(params, tc, feat2, src, dst)
    assert torch.equal(p1[9], p2[9])
    assert not torch.equal(p1[0], p2[0])


def test_segment_sum_is_run_independent():
    """Two calls on the same data give the same bits, under deterministic
    algorithms too."""
    rng = np.random.default_rng(13)
    msgs = torch.from_numpy(rng.standard_normal((400, 5)).astype(np.float32))
    dst = torch.from_numpy(rng.integers(0, 7, (400,)))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = nn.segment_sum(msgs, dst, 9)
        b = nn.segment_sum(msgs, dst, 9)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(a, b) and not a[7:].any()


def test_param_shapes_and_dtypes_match_reference_full_config():
    jc = jregistry.get("graphcast").full_config()
    jshapes, _ = jnn.abstract_init(jgc.init, jax.random.PRNGKey(0), jc)
    tc = registry.get("graphcast").full_config()
    assert gc.param_shapes(tc) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jshapes)
    assert all(d == torch.float32 for d in jax.tree_util.tree_leaves(
        gc.param_dtypes(tc)))
    tree = gc.init_numpy(registry.get("graphcast").smoke_config(), 0)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, _tree()))


@pytest.mark.parametrize("fanout", [(5, 3), (2,), (4, 4, 2)])
def test_sampler_bit_equal(fanout):
    rng = np.random.default_rng(7)
    n, e = 200, 1200
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    jg = jsampler.CSRGraph.from_edges(src, dst, n)
    tg = sampler.CSRGraph.from_edges(src, dst, n)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    assert tg.n_nodes == jg.n_nodes == n
    seeds = rng.choice(n, 8, replace=False).astype(np.int64)
    want = jsampler.sample_subgraph(jg, seeds, fanout,
                                    np.random.default_rng(3))
    got = sampler.sample_subgraph(tg, seeds, fanout, np.random.default_rng(3))
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w)
    assert sampler.sampled_subgraph_shape(8, fanout) == \
        jsampler.sampled_subgraph_shape(8, fanout)


def _same(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("name,args", [
    ("lm_batch", (97, 3, 11)),
    ("biencoder_batch", (97, 3, 5, 9)),
    ("graph_batch", (40, 130, 6, 3)),
    ("batched_molecule_graphs", (4, 7, 12, 5, 2)),
    ("sasrec_batch", (300, 5, 9, 16)),
    ("bert4rec_batch", (300, 5, 12, 3, 16)),
    ("mind_batch", (300, 5, 9, 16)),
    ("deepfm_batch", ((13, 7, 31), 6, 3)),
])
def test_synthetic_bit_equal(name, args):
    want = getattr(jsynth, name)(np.random.default_rng(21), *args)
    got = getattr(synthetic, name)(np.random.default_rng(21), *args)
    _same(got, want)
