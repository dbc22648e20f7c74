"""The port's cached LM path against the JAX package's, on the CPU:
``prefill`` + ``decode_step`` and ``lm_demo.serve_batch``.

The same JAX-initialised parameters (converted with ``params_from_numpy``)
and the same numpy tokens go through both, for the smoke configs of the
three dense architectures, at compute f32: logits and caches agree within
atol 2e-5 (f32 sums in another order; the reference's own prefill/decode
check uses 2e-4) and greedy tokens are equal.  The cached path never
reaches the flash kernel, in the reference or in the port.
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


def _configs(arch: str):
    jc = dataclasses.replace(jregistry.get(arch).smoke_config(),
                             compute_dtype=jnp.float32)
    tc = dataclasses.replace(registry.get(arch).smoke_config(),
                             compute_dtype=torch.float32)
    return jc, tc


def _tree(arch: str):
    """JAX parameters of the arch's smoke config, as numpy."""
    jc = jregistry.get(arch).smoke_config()
    tree = jnn.materialize(jtfm.init(jax.random.PRNGKey(0), jc))
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(vocab: int, B: int = 2, S: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(B, S)).astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
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
    for i in range(steps):
        if i:
            tok = toks[:, P + i - 1:P + i]
            jl, jcache = jtfm.decode_step(tree, jc, jcache, jnp.asarray(tok),
                                          jnp.asarray(P + i - 1, jnp.int32))
            tl, tcache = tfm.decode_step(params, tc, tcache,
                                         torch.from_numpy(tok), P + i - 1)
            np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
        assert tcache["moe"] is None and jcache["moe"] is None
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tcache["dense"][key]),
                                       _np(jcache["dense"][key]), atol=ATOL,
                                       rtol=0)
    # the last decode step's logits equal the no-cache forward's last row
    full, _, _ = tfm.forward(params, tc, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(_np(tl[:, 0]),
                               _np(tfm.logits(params, tc, full)[:, -1]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_batch_tokens_equal_jax(arch):
    jc, tc = _configs(arch)
    tree = _tree(arch)
    prompts = _tokens(jc.vocab_size, B=3, S=7, seed=3)
    want = jdemo.serve_batch(tree, jc, jnp.asarray(prompts), 6)
    got = lm_demo.serve_batch(tfm.params_from_numpy(tree), tc,
                              torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_demo_main_runs_on_cpu(capsys):
    lm_demo.main(["--arch", "qwen2-0.5b", "--batch", "2", "--prompt-len",
                  "5", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[lm_demo] arch=qwen2-0.5b device=cpu batch=2" in out
    assert "6 tokens in" in out and out.splitlines()[1].startswith("sample:")


def test_lm_demo_main_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        lm_demo.main(["--gen", "2"])


def test_cached_path_launches_no_flash_kernel(monkeypatch):
    """attn_impl="cuda" sends only cache-free, mask-free calls to the flash
    kernel: prefill takes the chunked path and each decode step the decode
    kernel (``tests/test_torch_decode_path.py``), on any device."""
    _, tc = _configs("qwen2-72b")
    tc = dataclasses.replace(tc, attn_impl="cuda")
    params = tfm.params_from_numpy(tfm.init_numpy(tc, 0))
    calls = []
    real = tfm.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfm, "flash_attention", spy)
    tokens = torch.ones((2, 4), dtype=torch.int32)
    lm_demo.serve_batch(params, tc, tokens, 3)
    assert calls == []
    tfm.forward(params, tc, tokens)
    assert calls == [(2, tc.n_heads, 4, tc.head_dim)] * tc.n_layers
