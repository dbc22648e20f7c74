"""The port's dense LM trunk against the JAX package's, on the CPU.

The same JAX-initialised parameters (``nn.materialize(tfm.init(...))``,
converted with ``params_from_numpy``) and the same numpy tokens go through
both, for the smoke configs of the three dense architectures.  At compute
f32 the hidden states agree within atol 2e-5 (f32 sums in another order) and
losses within 1e-5.  At bf16 the two frameworks round
at different places, so the gate is a per-row cosine of at least 0.999.
``attn_impl="cuda"`` takes the flash kernel's plain version on CPU tensors;
the JAX side runs ``attn_impl="pallas"`` in interpret mode.  The cached
path (prefill, decode, ``serve_batch``) is tested in
``test_torch_lm_decode.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.models import nn as jnn
from repro.models import transformer as jtfm
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.models import nn
from repro_torch.models import transformer as tfm

DENSE = ["qwen2-0.5b", "qwen2-72b", "deepseek-67b"]
_JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
_IMPL = {"torch": "xla", "cuda": "pallas"}
ATOL = 2e-5


def _configs(arch: str, dt: str = "f32", impl: str = "torch", **kw):
    jc = dataclasses.replace(jregistry.get(arch).smoke_config(),
                             compute_dtype=_JAX_DT[dt], attn_impl=_IMPL[impl],
                             **kw)
    tc = dataclasses.replace(registry.get(arch).smoke_config(),
                             compute_dtype=_TORCH_DT[dt], attn_impl=impl,
                             **kw)
    return jc, tc


_TREES = {}


def _tree(arch: str):
    """JAX parameters of the arch's smoke config, as numpy."""
    if arch not in _TREES:
        jc = jregistry.get(arch).smoke_config()
        tree = jnn.materialize(jtfm.init(jax.random.PRNGKey(0), jc))
        _TREES[arch] = jax.tree_util.tree_map(np.asarray, tree)
    return _TREES[arch]


def _tokens(vocab: int, B: int = 2, S: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(B, S)).astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, impl):
    jc, tc = _configs(arch, impl=impl)
    tree, toks = _tree(arch), _tokens(jc.vocab_size)
    want, _, _ = jtfm.forward(tree, jc, jnp.asarray(toks))
    got, caches, aux = tfm.forward(tfm.params_from_numpy(tree), tc,
                                   torch.from_numpy(toks))
    assert caches is None and float(aux) == 0.0
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_bidirectional_ragged_chunks_match_jax(arch):
    """No causal mask, and query chunks of 7 rows that do not divide S."""
    jc, tc = _configs(arch, causal=False, q_chunk=7)
    tree, toks = _tree(arch), _tokens(jc.vocab_size, S=23, seed=8)
    want, _, _ = jtfm.forward(tree, jc, jnp.asarray(toks))
    got, _, _ = tfm.forward(tfm.params_from_numpy(tree), tc,
                            torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("vocab_chunk", [0, 64])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_matches_jax(arch, vocab_chunk):
    jc, tc = _configs(arch, vocab_chunk=vocab_chunk)
    tree, toks = _tree(arch), _tokens(jc.vocab_size, S=20, seed=1)
    mask = np.ones(toks.shape, bool)
    mask[1, 15:] = False
    jl, jm = jtfm.lm_loss(tree, jc, {"tokens": jnp.asarray(toks),
                                     "mask": jnp.asarray(mask)})
    tl, tm = tfm.lm_loss(tfm.params_from_numpy(tree), tc,
                         {"tokens": torch.from_numpy(toks),
                          "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               atol=1e-5, rtol=0)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("arch", DENSE)
def test_bf16_forward_cosine(arch, impl):
    jc, tc = _configs(arch, "bf16", impl)
    tree, toks = _tree(arch), _tokens(jc.vocab_size, seed=4)
    want = _np(jtfm.forward(tree, jc, jnp.asarray(toks))[0])
    got = tfm.forward(tfm.params_from_numpy(tree), tc,
                      torch.from_numpy(toks))[0]
    assert got.dtype == torch.bfloat16
    got = _np(got)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos.min()


def test_full_width_qwen2_layer():
    """One layer of qwen2-0.5b at full width (d_model 896, 14/2 heads of 64,
    d_ff 4864, vocab 151936), f32, S=16, both attention impls.  The
    parameters come from the port's ``init_numpy`` (the JAX side takes numpy
    trees too), which is quicker than JAX's init at this size."""
    jc = dataclasses.replace(jregistry.get("qwen2-0.5b").full_config(),
                             n_layers=1, compute_dtype=jnp.float32)
    tc = dataclasses.replace(registry.get("qwen2-0.5b").full_config(),
                             n_layers=1, compute_dtype=torch.float32)
    tree = tfm.init_numpy(tc, 0)
    params = tfm.params_from_numpy(tree)
    toks = _tokens(jc.vocab_size, B=2, S=16, seed=5)
    want = _np(jtfm.forward(tree, jc, jnp.asarray(toks))[0])
    for impl in ("torch", "cuda"):
        got = tfm.forward(params, dataclasses.replace(tc, attn_impl=impl),
                          torch.from_numpy(toks))[0]
        np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_param_shapes_match_reference_full_config(arch):
    """The full configs' parameter trees, without allocating them."""
    jshapes, _ = jnn.abstract_init(jtfm.init, jax.random.PRNGKey(0),
                                   jregistry.get(arch).full_config())
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), jshapes)
    got = tfm.param_shapes(registry.get(arch).full_config())
    assert got == want


def test_config_defaults_equal_reference():
    """Every field both configs have defaults to the same value (the JAX
    dtypes map to torch's)."""
    jfields = {f.name: f.default for f in
               dataclasses.fields(jtfm.TransformerConfig)}
    tfields = {f.name: f.default for f in
               dataclasses.fields(tfm.TransformerConfig)}
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for name, default in tfields.items():
        if name == "attn_impl":
            assert (jfields[name], default) == ("xla", "torch")
            continue
        assert name in jfields, name
        assert dtypes.get(jfields[name], jfields[name]) == default, name
    jax_only = {"remat", "layer_unroll", "attn_unroll", "xent_unroll",
                "attn_expand_kv"}
    not_yet_ported = {"moe_top_k", "moe_d_ff", "moe_num_shared", "moe_mode",
                      "moe_capacity_factor", "first_k_dense",
                      "router_aux_coef", "kv_lora_rank", "qk_nope_dim",
                      "qk_rope_dim", "v_head_dim"}
    assert set(jfields) - set(tfields) == jax_only | not_yet_ported


@pytest.mark.parametrize("field,value", [("moe_num_experts", 4),
                                         ("mla", True)])
def test_moe_and_mla_raise(field, value):
    _, tc = _configs("deepseek-67b")
    with pytest.raises(NotImplementedError, match="A13"):
        tfm.param_shapes(dataclasses.replace(tc, **{field: value}))


@pytest.mark.parametrize("arch", DENSE)
def test_rope_frequencies_bitwise(arch):
    for cfg in (jregistry.get(arch).full_config(),
                jregistry.get(arch).smoke_config()):
        want = np.asarray(jnn.rope_frequencies(cfg.head_dim, cfg.rope_theta))
        got = nn.rope_frequencies(cfg.head_dim, cfg.rope_theta).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_and_rmsnorm_match_jax(dt):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = np.array([[0, 1, 2, 2047, 4095], [7, 100, 1000, 3000, 4000]],
                   np.int32)
    jx = jnp.asarray(x, _JAX_DT[dt])
    tx = torch.from_numpy(x).to(_TORCH_DT[dt])
    want = _np(jnn.apply_rope(jx, jnp.asarray(pos), 1e6))
    got = _np(nn.apply_rope(tx, torch.from_numpy(pos), 1e6))
    # cos/sin of angles up to 4095 rad: f32 ulps of the two libraries
    tol = 2e-5 if dt == "f32" else 1e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    scale = rng.standard_normal(64).astype(np.float32)
    want = _np(jnn.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6))
    got = _np(nn.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6))
    np.testing.assert_allclose(got, want, atol=1e-5 if dt == "f32" else 1e-2,
                               rtol=0)


def test_restore_reads_jax_lm_checkpoint(tmp_path):
    tree = _tree("qwen2-72b")                      # untied: has lm_head
    jckpt.save(str(tmp_path), 3, {"params": tree}, extra={"arch": "lm"})
    cfg = registry.get("qwen2-72b").smoke_config()
    state, extra = ckpt.restore(str(tmp_path),
                                template={"params": tfm.param_shapes(cfg)})
    assert extra == {"arch": "lm"}
    got = dict(ckpt.flatten(state["params"]))
    want = dict(ckpt.flatten(tree))
    assert sorted(got) == sorted(want) and "lm_head/w" in got
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path].numpy(), arr)
    toks = _tokens(cfg.vocab_size, seed=7)
    a = tfm.forward(tfm.params_from_numpy(state["params"]), cfg,
                    torch.from_numpy(toks))[0]
    b = tfm.forward(tfm.params_from_numpy(tree), cfg,
                    torch.from_numpy(toks))[0]
    assert torch.equal(a, b)
