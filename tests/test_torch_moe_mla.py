"""The port's MoE and MLA transformer layers against the JAX package's, on
the CPU, for the smoke configs of arctic-480b (GQA, residual 8-expert top-2
MoE) and deepseek-v2-lite-16b (MLA, a dense first layer, 8-expert top-2 MoE
with 2 shared experts).

The same JAX-initialised parameters (``nn.materialize(init(...))`` as
numpy) and the same seeded numpy inputs go through both.  The dispatch is
compared slot by slot and must be equal; at compute f32 outputs, logits and
caches agree within atol 2e-5 and losses within 1e-5 (f32 sums in another
order: the port's combine sums each token's K slots where the reference
scatter-adds slots).  Routers are drawn at random, so no two router
probabilities of a token tie (``torch.topk`` does not promise
``lax.top_k``'s lower-index-first order on ties).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.launch import lm_demo as jdemo
from repro.models import nn as jnn
from repro.models import transformer as jtfm
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.launch import lm_demo
from repro_torch.models import nn
from repro_torch.models import transformer as tfm

MOE = ["arctic-480b", "deepseek-v2-lite-16b"]
ATOL = 2e-5
_TORCH_OF = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _configs(arch: str, **kw):
    jc = dataclasses.replace(jregistry.get(arch).smoke_config(),
                             compute_dtype=jnp.float32, **kw)
    tc = dataclasses.replace(registry.get(arch).smoke_config(),
                             compute_dtype=torch.float32, **kw)
    return jc, tc


_TREES = {}


def _tree(arch: str):
    if arch not in _TREES:
        jc = jregistry.get(arch).smoke_config()
        tree = jnn.materialize(jtfm.init(jax.random.PRNGKey(0), jc))
        _TREES[arch] = jax.tree_util.tree_map(np.asarray, tree)
    return _TREES[arch]


def _tokens(vocab: int, B: int = 2, S: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(B, S)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _layer0(stack):
    return jax.tree_util.tree_map(lambda a: a[0], stack)


def _routing(seed, S, E, K, D=16):
    """x (S, D), and top-k experts and renormalised gates of a random
    router's softmax (no ties), as the reference's ``_moe_block`` draws
    them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, D)).astype(np.float32)
    logits = rng.standard_normal((S, E)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, idx = jax.lax.top_k(probs, K)
    gates = gates / gates.sum(-1, keepdims=True)
    return x, np.array(idx), np.array(gates)


@pytest.mark.parametrize("capacity", [1, 3, 6, 64])
@pytest.mark.parametrize("S,E,K", [(24, 8, 2), (13, 4, 3), (32, 16, 6)])
def test_moe_dispatch_slot_by_slot(S, E, K, capacity):
    x, idx, gates = _routing(S * 7 + capacity, S, E, K)
    want = jtfm._moe_dispatch(jnp.asarray(x), jnp.asarray(idx),
                              jnp.asarray(gates), E, capacity)
    got = tfm._moe_dispatch(torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(gates), E, capacity)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # each kept assignment's slot holds its token and gate
    tok_slot = got[4].numpy().reshape(-1)
    slot_tok, slot_gate = got[1].numpy(), got[2].numpy()
    for n, slot in enumerate(tok_slot):
        if slot < E * capacity:
            assert slot_tok[slot] == n // K
            assert slot_gate[slot] == gates.reshape(-1)[n]
    assert (tok_slot < E * capacity).sum() == got[3].numpy().sum()


def test_moe_dispatch_groups_match_vmapped_reference():
    """Leading batch axes are groups, as the reference's ``vmap``."""
    E, K, C, B, S = 8, 2, 4, 3, 16
    parts = [_routing(40 + b, S, E, K) for b in range(B)]
    x, idx, gates = (np.stack([p[i] for p in parts]) for i in range(3))
    want = jax.vmap(lambda a, b, c: jtfm._moe_dispatch(a, b, c, E, C))(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates))
    got = tfm._moe_dispatch(torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(gates), E, C)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tuple(got[0].shape) == (B, E, C, 16)
    assert tuple(got[4].shape) == (B, S, K)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 100, 2048])
@pytest.mark.parametrize("arch", MOE + ["arctic-full", "deepseek-full"])
def test_capacity_matches_reference(arch, S):
    name = {"arctic-full": "arctic-480b",
            "deepseek-full": "deepseek-v2-lite-16b"}.get(arch, arch)
    full = arch.endswith("-full")
    jc = getattr(jregistry.get(name), "full_config" if full
                 else "smoke_config")()
    tc = getattr(registry.get(name), "full_config" if full
                 else "smoke_config")()
    want = max(1, int(S * jc.moe_top_k / jc.moe_num_experts
                      * jc.moe_capacity_factor))
    assert tfm.moe_capacity(tc, S) == want


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_output_and_aux(arch, factor):
    """One MoE layer at capacity factors that drop tokens (0.5, 1.0) and
    that do not (8.0 = E)."""
    jc, tc = _configs(arch, moe_capacity_factor=factor)
    p = _layer0(_tree(arch)["moe_layers"]["moe"])
    x = np.random.default_rng(3).standard_normal(
        (3, 20, jc.d_model)).astype(np.float32)
    want, waux = jtfm._moe_block(p, jnp.asarray(x), jc)
    got, gaux = tfm._moe_block(nn.to_torch_tree(p), torch.from_numpy(x),
                               tc)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(gaux), float(waux), atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", MOE)
def test_capacity_drops_zero_the_dropped_tokens(arch):
    """With capacity 1 per expert most assignments drop; a token whose K
    assignments all dropped gets only the shared experts' output (none for
    arctic), as in the reference."""
    jc, tc = _configs(arch, moe_capacity_factor=0.01)
    p = _layer0(_tree(arch)["moe_layers"]["moe"])
    x = np.random.default_rng(4).standard_normal(
        (2, 32, jc.d_model)).astype(np.float32)
    tp = nn.to_torch_tree(p)
    got, _ = tfm._moe_block(tp, torch.from_numpy(x), tc)
    want, _ = jtfm._moe_block(p, jnp.asarray(x), jc)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    shared = tfm._dense_mlp(tp["shared"], torch.from_numpy(x), tc) \
        if tc.moe_num_shared else torch.zeros(x.shape)
    routed = (got - shared).abs().amax(-1)
    assert tfm.moe_capacity(tc, 32) == 1
    # at most E tokens per group keep an assignment
    assert int((routed > 0).sum(-1).max()) <= tc.moe_num_experts


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_deterministic_algorithms(arch):
    """The combine is allowed under deterministic algorithms and gives the
    same bits on a second call."""
    _, tc = _configs(arch)
    p = nn.to_torch_tree(_layer0(_tree(arch)["moe_layers"]["moe"]))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, tc.d_model)).astype(np.float32))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a, _ = tfm._moe_block(p, x, tc)
        b, _ = tfm._moe_block(p, x, tc)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(a, b)


def test_expert_blocks_cast_a_few_experts_at_a_time(monkeypatch):
    """bf16 experts under an f32 computation are cast in blocks of experts
    and give what one cast of all of them gives."""
    _, tc = _configs("arctic-480b")
    p = {k: v.to(torch.bfloat16) for k, v in nn.to_torch_tree(
        _layer0(_tree("arctic-480b")["moe_layers"]["moe"])).items()
        if k in ("w1", "w3", "w2")}
    xt = torch.randn(8, 5, tc.d_model, generator=torch.Generator()
                     .manual_seed(0))
    whole = tfm._expert_swiglu({k: v.float() for k, v in p.items()}, xt,
                               torch.float32)
    E, D, F = p["w1"].shape
    real_bmm, calls = torch.bmm, []

    def bmm(a, b):
        calls.append(b.shape[0])
        return real_bmm(a, b)

    monkeypatch.setattr(torch, "bmm", bmm)
    monkeypatch.setattr(tfm, "_EXPERT_BLOCK_ELEMENTS", 3 * D * F)
    blocked = tfm._expert_swiglu(p, xt, torch.float32)
    assert calls == [3] * 3 + [3] * 3 + [2] * 3
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("cached", [False, True])
def test_mla_prefill_matches_jax(cached):
    """One MLA layer: train / no-cache, and prefill into a cache."""
    arch = "deepseek-v2-lite-16b"
    jc, tc = _configs(arch)
    p = _layer0(_tree(arch)["dense_layers"]["attn"])
    B, S, T = 2, 11, 16
    x = np.random.default_rng(6).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    jcache = tcache = None
    kw = {}
    if cached:
        jcache = {"ckv": jnp.zeros((B, T, jc.kv_lora_rank)),
                  "krope": jnp.zeros((B, T, jc.qk_rope_dim))}
        tcache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
        kw = {"cache_index": 0}
    want, wc = jtfm._mla_attention(p, jnp.asarray(x), jc,
                                   positions=jnp.asarray(pos), cache=jcache,
                                   **({"cache_index": jnp.asarray(0)}
                                      if cached else {}))
    got, gc = tfm._mla_attention(nn.to_torch_tree(p),
                                 torch.from_numpy(x), tc,
                                 positions=torch.from_numpy(pos),
                                 cache=tcache, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    if cached:
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(_np(gc[key]), _np(wc[key]),
                                       atol=ATOL, rtol=0)


def test_mla_absorbed_decode_matches_jax():
    """Absorbed decode steps against a prefilled compressed cache, with and
    without a caller's key mask."""
    arch = "deepseek-v2-lite-16b"
    jc, tc = _configs(arch)
    p = _layer0(_tree(arch)["dense_layers"]["attn"])
    tp = nn.to_torch_tree(p)
    B, T = 2, 12
    rng = np.random.default_rng(7)
    cc = rng.standard_normal((B, T, jc.kv_lora_rank)).astype(np.float32)
    cr = rng.standard_normal((B, T, jc.qk_rope_dim)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 3:5] = False
    for index, kv_mask in ((5, None), (9, mask), (T - 1, None)):
        x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        pos = np.full((B, 1), index, np.int32)
        want, wc = jtfm._mla_attention(
            p, jnp.asarray(x), jc, positions=jnp.asarray(pos),
            cache={"ckv": jnp.asarray(cc), "krope": jnp.asarray(cr)},
            cache_index=jnp.asarray(index),
            kv_mask=None if kv_mask is None else jnp.asarray(kv_mask))
        tcache = {"ckv": torch.from_numpy(cc.copy()),
                  "krope": torch.from_numpy(cr.copy())}
        got, gc = tfm._mla_attention(
            tp, torch.from_numpy(x), tc, positions=torch.from_numpy(pos),
            cache=tcache, cache_index=index,
            kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask))
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(_np(gc["ckv"]), _np(wc["ckv"]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_caches_match_jax(arch):
    jc, tc = _configs(arch)
    tree = _tree(arch)
    params = tfm.params_from_numpy(tree)
    P, steps = 9, 4
    toks = _tokens(jc.vocab_size, S=P + steps, seed=2)
    jl, jcache = jtfm.prefill(tree, jc, jnp.asarray(toks[:, :P]),
                              max_len=P + steps)
    tl, tcache = tfm.prefill(params, tc, torch.from_numpy(toks[:, :P]),
                             max_len=P + steps)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
    for i in range(1, steps):
        tok = toks[:, P + i - 1:P + i]
        jl, jcache = jtfm.decode_step(tree, jc, jcache, jnp.asarray(tok),
                                      jnp.asarray(P + i - 1, jnp.int32))
        tl, tcache = tfm.decode_step(params, tc, tcache,
                                     torch.from_numpy(tok), P + i - 1)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
    assert set(tcache) == set(jcache) == {"dense", "moe"}
    for group in ("dense", "moe"):
        if jcache[group] is None:
            assert tcache[group] is None
            continue
        assert set(tcache[group]) == set(jcache[group])
        for key in jcache[group]:
            np.testing.assert_allclose(_np(tcache[group][key]),
                                       _np(jcache[group][key]), atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_full_forward(arch, impl):
    """prefill + decode_step reproduce the no-cache forward's logits when
    no token drops (capacity factor E), as the reference's own check."""
    jc, tc = _configs(arch, moe_capacity_factor=8.0)
    tc = dataclasses.replace(tc, attn_impl=impl)
    tree = _tree(arch)
    params = tfm.params_from_numpy(tree)
    B, S = 2, 10
    toks = _tokens(jc.vocab_size, B=B, S=S, seed=3)
    hidden, _, _ = tfm.forward(params, tc, torch.from_numpy(toks))
    full = tfm.logits(params, tc, hidden)
    _, caches = tfm.prefill(params, tc, torch.from_numpy(toks[:, :S - 1]),
                            max_len=S)
    step, _ = tfm.decode_step(params, tc, caches,
                              torch.from_numpy(toks[:, S - 1:]), S - 1)
    np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, -1]),
                               atol=2e-4, rtol=2e-4)
    jh, _, _ = jtfm.forward(tree, jc, jnp.asarray(toks))
    np.testing.assert_allclose(_np(full), _np(jtfm.logits(tree, jc, jh)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("vocab_chunk", [0, 64])
@pytest.mark.parametrize("arch", MOE)
def test_lm_loss_with_aux(arch, vocab_chunk):
    jc, tc = _configs(arch, vocab_chunk=vocab_chunk)
    tree = _tree(arch)
    toks = _tokens(jc.vocab_size, S=20, seed=1)
    jl, jm = jtfm.lm_loss(tree, jc, {"tokens": jnp.asarray(toks)})
    tl, tm = tfm.lm_loss(tfm.params_from_numpy(tree), tc,
                         {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               atol=1e-6, rtol=0)
    assert float(tm["aux"]) > 0
    assert torch.equal(tl, tm["xent"] + tc.router_aux_coef * tm["aux"])


@pytest.mark.parametrize("arch", MOE)
def test_serve_batch_tokens_equal_jax(arch):
    jc, tc = _configs(arch)
    tree = _tree(arch)
    prompts = _tokens(jc.vocab_size, B=3, S=7, seed=3)
    want = jdemo.serve_batch(tree, jc, jnp.asarray(prompts), 6)
    got = lm_demo.serve_batch(tfm.params_from_numpy(tree), tc,
                              torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def attention_spy(monkeypatch):
    calls = {"flash": 0, "decode": 0}
    real = {"flash": tfm.flash_attention, "decode": tfm.decode_attention}

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return call

    monkeypatch.setattr(tfm, "flash_attention", counted("flash"))
    monkeypatch.setattr(tfm, "decode_attention", counted("decode"))
    return calls


@pytest.mark.parametrize("arch", MOE)
def test_kernel_call_sites(attention_spy, arch):
    """Under "cuda", arctic's GQA layers call the flash kernel once per
    layer per forward and the decode kernel once per layer per decode
    step; MLA calls neither, in any entry point."""
    _, tc = _configs(arch, attn_impl="cuda")
    params = tfm.params_from_numpy(_tree(arch))
    toks = torch.from_numpy(_tokens(tc.vocab_size, S=12, seed=9))
    tfm.lm_loss(params, tc, {"tokens": toks})
    per_forward = attention_spy["flash"]
    _, caches = tfm.prefill(params, tc, toks[:, :8], max_len=12)
    assert attention_spy["flash"] == per_forward
    for i in range(3):
        tfm.decode_step(params, tc, caches, toks[:, 8 + i:9 + i], 8 + i)
    gqa = not tc.mla
    assert per_forward == (tc.n_layers if gqa else 0)
    assert attention_spy["decode"] == (3 * tc.n_layers if gqa else 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE)
def test_param_shapes_and_dtypes_match_reference(arch, dtype):
    """The full configs' trees without allocating them, dtypes included
    (the router stays f32 at a bf16 ``param_dtype``)."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jcfg = dataclasses.replace(jregistry.get(arch).full_config(),
                               param_dtype=jdt)
    tcfg = dataclasses.replace(registry.get(arch).full_config(),
                               param_dtype=_TORCH_OF[jdt])
    jshapes, _ = jnn.abstract_init(jtfm.init, jax.random.PRNGKey(0), jcfg)
    assert tfm.param_shapes(tcfg) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jshapes)
    assert tfm.param_dtypes(tcfg) == jax.tree_util.tree_map(
        lambda s: _TORCH_OF[s.dtype.type], jshapes)


def test_restore_reads_jax_bf16_arctic_checkpoint(tmp_path):
    """A bf16 arctic smoke checkpoint saved by the JAX package (its router
    f32) restores through ``ckpt.restore`` with ``param_shapes`` as the
    template, every leaf at the reference's dtype and value."""
    jc = dataclasses.replace(jregistry.get("arctic-480b").smoke_config(),
                             param_dtype=jnp.bfloat16)
    tree = jnn.materialize(jtfm.init(jax.random.PRNGKey(2), jc))
    jckpt.save(str(tmp_path), 5, {"params": tree}, extra={"arch": "lm"})
    tc = dataclasses.replace(registry.get("arctic-480b").smoke_config(),
                             param_dtype=torch.bfloat16)
    state, extra = ckpt.restore(str(tmp_path),
                                template={"params": tfm.param_shapes(tc)})
    assert extra == {"arch": "lm"}
    got = dict(ckpt.flatten(state["params"]))
    dtypes = dict(ckpt.flatten(tfm.param_dtypes(tc)))
    want = dict(ckpt.flatten(jax.tree_util.tree_map(np.asarray, tree)))
    assert sorted(got) == sorted(want) == sorted(dtypes)
    assert got["moe_layers/moe/router"].dtype == torch.float32
    assert got["moe_layers/moe/w1"].dtype == torch.bfloat16
    for path, arr in want.items():
        assert got[path].dtype == dtypes[path], path
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      arr.astype(np.float32))
    toks = torch.from_numpy(_tokens(tc.vocab_size, seed=7))
    a = tfm.forward(tfm.params_from_numpy(state["params"]), tc, toks)[0]
    b = tfm.forward(tfm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree)), tc, toks)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", MOE)
def test_init_cache_groups(arch):
    for dt in (torch.float32, torch.bfloat16):
        tc = registry.get(arch).smoke_config()
        got = tfm.init_cache(tc, 3, 17, dtype=dt)
        jc = jregistry.get(arch).smoke_config()
        want = jtfm.init_cache(jc, 3, 17)
        assert set(got) == set(want)
        for group in want:
            if want[group] is None:
                assert got[group] is None
                continue
            assert {k: tuple(v.shape) for k, v in got[group].items()} == \
                {k: tuple(v.shape) for k, v in want[group].items()}
            assert all(v.dtype == dt and not v.any()
                       for v in got[group].values())
