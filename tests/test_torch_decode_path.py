"""The port's decode step under ``attn_impl="cuda"`` against the JAX package's
``decode_step``, on the CPU.

With ``"cuda"``, the cached single-token step of ``transformer._attention``
calls ``decode_attention`` (on CPU tensors its plain version).  The same
JAX-initialised parameters and numpy tokens go through the reference's
``prefill`` + ``decode_step`` (its chunked XLA path) and the port's, for the
smoke configs of the three dense architectures: at compute f32 logits and
caches agree within atol 2e-5 (as in ``test_torch_lm_decode.py``) and greedy
tokens are equal; at bf16 the logits' rows have cosine >= 0.999 (the port
keeps p in f32 where the reference rounds it to bf16).  A spy on
``transformer.decode_attention`` shows where the kernel is called: once per
layer per decode step with ``length = index + 1``, never from prefill, from a
call with a caller's key mask, or under ``"torch"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import lm_demo as jdemo
from repro.models import nn as jnn
from repro.models import transformer as jtfm
from repro_torch.configs import registry
from repro_torch.launch import lm_demo
from repro_torch.models import transformer as tfm

DENSE = ["qwen2-0.5b", "qwen2-72b", "deepseek-67b"]
ATOL = 2e-5
_JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _configs(arch: str, dt: str = "f32"):
    jc = dataclasses.replace(jregistry.get(arch).smoke_config(),
                             compute_dtype=_JAX_DT[dt])
    tc = dataclasses.replace(registry.get(arch).smoke_config(),
                             compute_dtype=_TORCH_DT[dt], attn_impl="cuda")
    return jc, tc


def _tree(arch: str):
    """JAX parameters of the arch's smoke config, as numpy."""
    jc = jregistry.get(arch).smoke_config()
    tree = jnn.materialize(jtfm.init(jax.random.PRNGKey(1), jc))
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(vocab: int, B: int = 2, S: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(B, S)).astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _run_both(arch, dt, P=9, steps=4):
    """Logits of prefill and each decode step, and the final caches, from
    the reference and the port on the same parameters and tokens."""
    jc, tc = _configs(arch, dt)
    tree = _tree(arch)
    params = tfm.params_from_numpy(tree)
    toks = _tokens(jc.vocab_size, S=P + steps, seed=4)
    jl, jcache = jtfm.prefill(tree, jc, jnp.asarray(toks[:, :P]),
                              max_len=P + steps)
    tl, tcache = tfm.prefill(params, tc, torch.from_numpy(toks[:, :P]),
                             max_len=P + steps)
    pairs = [(jl, tl)]
    for i in range(1, steps):
        tok = toks[:, P + i - 1:P + i]
        jl, jcache = jtfm.decode_step(tree, jc, jcache, jnp.asarray(tok),
                                      jnp.asarray(P + i - 1, jnp.int32))
        tl, tcache = tfm.decode_step(params, tc, tcache,
                                     torch.from_numpy(tok), P + i - 1)
        pairs.append((jl, tl))
    return pairs, jcache, tcache


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_jax_f32(arch):
    pairs, jcache, tcache = _run_both(arch, "f32")
    for jl, tl in pairs:
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["dense"][key]),
                                   _np(jcache["dense"][key]), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_bf16_cosine(arch):
    pairs, _, _ = _run_both(arch, "bf16")
    for jl, tl in pairs[1:]:
        assert tl.dtype == torch.bfloat16
        got, want = _np(tl)[:, 0], _np(jl)[:, 0]
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999, cos.min()


@pytest.mark.parametrize("arch", DENSE)
def test_serve_batch_tokens_equal_jax(arch):
    jc, tc = _configs(arch)
    tree = _tree(arch)
    prompts = _tokens(jc.vocab_size, B=3, S=7, seed=5)
    want = jdemo.serve_batch(tree, jc, jnp.asarray(prompts), 6)
    got = lm_demo.serve_batch(tfm.params_from_numpy(tree), tc,
                              torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def decode_spy(monkeypatch):
    """Record (q shape, k shape, length) of every decode_attention call."""
    calls = []
    real = tfm.decode_attention

    def spy(q, k, v, length):
        calls.append((tuple(q.shape), tuple(k.shape), length))
        return real(q, k, v, length)

    monkeypatch.setattr(tfm, "decode_attention", spy)
    return calls


def test_kernel_called_once_per_layer_per_decode_step(decode_spy):
    _, tc = _configs("qwen2-0.5b")
    params = tfm.params_from_numpy(tfm.init_numpy(tc, 0))
    B, P, gen = 2, 5, 4
    prompts = torch.ones((B, P), dtype=torch.int32)
    lm_demo.serve_batch(params, tc, prompts, gen)
    G = tc.n_heads // tc.n_kv_heads
    want = [((B, tc.n_kv_heads, G, tc.head_dim),
             (B, tc.n_kv_heads, P + gen, tc.head_dim), P + i + 1)
            for i in range(gen - 1) for _ in range(tc.n_layers)]
    assert decode_spy == want


def test_kernel_not_called_from_prefill_mask_or_torch(decode_spy):
    _, tc = _configs("qwen2-72b")
    params = tfm.params_from_numpy(tfm.init_numpy(tc, 0))
    tokens = torch.ones((2, 4), dtype=torch.int32)
    _, caches = tfm.prefill(params, tc, tokens, max_len=8)
    assert decode_spy == []
    # a single-token cached call with a caller's key mask: chunked path
    mask = torch.ones((2, 8), dtype=torch.bool)
    tfm.forward(params, tc, tokens[:, :1], caches=caches, cache_index=4,
                kv_mask=mask)
    assert decode_spy == []
    # "torch" decodes through the chunked path
    lm_demo.serve_batch(params, dataclasses.replace(tc, attn_impl="torch"),
                        tokens, 3)
    assert decode_spy == []
    # and "cuda" through the kernel
    tfm.decode_step(params, tc, caches, tokens[:, :1], 4)
    assert len(decode_spy) == tc.n_layers
