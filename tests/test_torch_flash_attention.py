"""The port's ``flash_attention`` against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX ``flash_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
the port's ``ops.flash_attention`` on CPU tensors, which takes the plain
version of ``ref.py``.  Tolerances are those of the reference's own kernel
tests: 2e-4 at f32 (f32 sums in another order), 3e-2 at bf16 (one bf16
rounding of the output, and the reference wrapper's rescale of q in bf16
when it pads d to 128), 3e-4 for the property.  The kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref as jref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}

# the cases of tests/test_kernels.py::test_flash_attention_matches_ref
CASES = [
    (2, 4, 2, 64, 64, 32, True),       # GQA causal
    (1, 8, 8, 33, 57, 64, False),      # MHA ragged bidir
    (2, 2, 1, 128, 256, 128, True),    # MQA cross-len
    (1, 14, 2, 40, 40, 64, True),      # qwen2-0.5b head config
]


def _inputs(B, H, KV, S, T, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, d)).astype(np.float32),
            rng.standard_normal((B, KV, T, d)).astype(np.float32),
            rng.standard_normal((B, KV, T, d)).astype(np.float32))


def _both(arrays, dt):
    """(jax arrays, torch tensors) of the same values in dtype ``dt``."""
    jx = [jnp.asarray(a, _JAX_DT[dt]) for a in arrays]
    tx = [torch.from_numpy(a).to(_TORCH_DT[dt]) for a in arrays]
    return jx, tx


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,T,d,causal", CASES)
def test_matches_jax_kernel(B, H, KV, S, T, d, causal, dt):
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, KV, S, T, d), dt)
    want = jflash(jq, jk, jv, causal=causal, bq=32, bk=64)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (B, H, S, d)
    tol = 2e-4 if dt == "f32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # and the plain version is the reference's plain version
    np.testing.assert_allclose(
        _np(flash_attention_ref(q, k, v, causal=causal)),
        _np(jref(jq, jk, jv, causal=causal)), rtol=tol, atol=tol)


def test_kv_padding_mask():
    """t_valid makes padded keys invisible, as in the reference kernel."""
    B, H, S, T, d = 1, 2, 16, 64, 32
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, H, S, T, d, seed=1),
                                    "f32")
    o1 = ops.flash_attention(q, k, v, causal=False, t_valid=40)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] = 1e3                    # garbage in padding
    v2[:, :, 40:] = -1e3
    o2 = ops.flash_attention(q, k2, v2, causal=False, t_valid=40)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-6)
    want = jflash(jq, jk, jv, causal=False, t_valid=40, bq=16, bk=16)
    np.testing.assert_allclose(o1.numpy(), _np(want), rtol=2e-4, atol=2e-4)


def test_strided_views_equal_contiguous():
    """The trunk hands the kernel transposed views of (B, S, H, d)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 24, 24, 16))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in
             (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(ops.flash_attention(*views, causal=True),
                               ops.flash_attention(q, k, v, causal=True),
                               rtol=0, atol=0)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 3), st.integers(1, 4), st.integers(1, 64),
       st.integers(1, 64), st.sampled_from([16, 32, 64]), st.booleans())
def test_property_matches_jax(B, H, S, T, d, causal):
    if causal and T < S:
        T = S
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, H, S, T, d, seed=S * T),
                                    "f32")
    want = jflash(jq, jk, jv, causal=causal, bq=16, bk=32)
    got = ops.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("t_valid", [0, -1, 65])
def test_raises_on_t_valid_outside_range(t_valid):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 64, 16))
    with pytest.raises(ValueError, match="t_valid"):
        ops.flash_attention(q, k, v, t_valid=t_valid)


def test_raises_on_requires_grad():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 8, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)


@pytest.mark.parametrize("d", [4, 48, 256])
def test_raises_on_unsupported_head_dim(d):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 8, d))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)


def test_raises_on_heads_not_grouped():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 6, 4, 8, 8, 16))
    with pytest.raises(ValueError, match="KV heads"):
        ops.flash_attention(q, k, v)


def test_raises_on_mixed_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 8, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(q.bfloat16(), k, v)


def test_cpu_tensors_launch_nothing():
    ops.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 16))
    ops.flash_attention(q, k, v, causal=True)
    assert ops.launches == {"f32": 0, "bf16": 0}
