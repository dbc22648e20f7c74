"""The port's ``decode_attention`` against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX ``decode_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
the port's ``ops.decode_attention`` on CPU tensors, which takes the plain
version of ``ref.py``.  Against the JAX kernel the tolerances are those of
the reference's own kernel test: 2e-4 at f32 (f32 sums in another order),
3e-2 at bf16 (one bf16 rounding of the output, and the JAX wrapper's rescale
of q in bf16 when it pads d to 128).  Against the JAX plain version at f32:
1e-5.  The kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.kernels.decode_attention.ops import decode_attention as jdecode
from repro.kernels.decode_attention.ref import decode_attention_ref as jref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}

# the cases of tests/test_kernels.py::test_decode_attention_matches_ref:
# (B, KV, G, T, d, length)
CASES = [
    (2, 2, 4, 256, 64, 100),
    (1, 8, 1, 512, 128, 512),
    (3, 1, 7, 300, 32, 1),
    (1, 8, 8, 1024, 128, 700),     # deepseek-67b-like GQA decode
]


def _inputs(B, KV, G, T, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, KV, G, d)).astype(np.float32),
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
@pytest.mark.parametrize("B,KV,G,T,d,L", CASES)
def test_matches_jax_kernel(B, KV, G, T, d, L, dt):
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, KV, G, T, d), dt)
    want = jdecode(jq, jk, jv, L, bk=128)
    got = ops.decode_attention(q, k, v, L)
    assert got.dtype == q.dtype and got.shape == (B, KV, G, d)
    tol = 2e-4 if dt == "f32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,KV,G,T,d,L", CASES)
def test_plain_version_is_the_reference_plain_version(B, KV, G, T, d, L):
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, KV, G, T, d, seed=1), "f32")
    np.testing.assert_allclose(_np(decode_attention_ref(L, q, k, v)),
                               _np(jref(L, jq, jk, jv)), rtol=1e-5,
                               atol=1e-5)


def test_length_invariance():
    """Cache contents past ``length`` do not change the output (bit for bit
    on the CPU: masked keys get p = 0 exactly)."""
    B, KV, G, T, d, L = 1, 2, 4, 256, 64, 93
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, KV, G, T, d, seed=2), "f32")
    o1 = ops.decode_attention(q, k, v, L)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, L:] = 1e4
    v2[:, :, L:] = -1e4
    torch.testing.assert_close(ops.decode_attention(q, k2, v2, L), o1,
                               rtol=0, atol=0)
    np.testing.assert_allclose(o1.numpy(), _np(jdecode(jq, jk, jv, L, bk=64)),
                               rtol=2e-4, atol=2e-4)


def test_length_as_one_element_tensor():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 3, 40, 16))
    want = ops.decode_attention(q, k, v, 17)
    for length in (torch.tensor([17], dtype=torch.int32),
                   torch.tensor(17, dtype=torch.int64)):
        torch.testing.assert_close(ops.decode_attention(q, k, v, length),
                                   want, rtol=0, atol=0)


def test_strided_views_equal_contiguous():
    """The trunk hands the kernel transposed views of (B, T, KV, d) cache
    slices."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 7, 48, 16, seed=3))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(ops.decode_attention(q, *views, 30),
                               ops.decode_attention(q, k, v, 30),
                               rtol=0, atol=0)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 3), st.integers(1, 3), st.integers(1, 16),
       st.integers(1, 200), st.sampled_from([16, 32, 64]), st.data())
def test_property_matches_jax(B, KV, G, T, d, data):
    L = data.draw(st.integers(1, T))
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, KV, G, T, d, seed=T * G),
                                    "f32")
    want = jdecode(jq, jk, jv, L, bk=128)
    got = ops.decode_attention(q, k, v, L)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("length,bkv,slots", [
    (1, 1, 132), (31, 4, 396), (32768, 256, 396), (32768, 2, 396),
    (524288, 2, 396), (524288, 2, 132), (143, 8, 528), (1000, 1, 1),
    (700, 64, 132), (65537, 3, 264)])
def test_plan_splits_cover_the_prefix(length, bkv, slots):
    """Splits are multiples of 32 keys, cover [0, length) exactly, none is
    empty, each has MIN_CHUNK keys where the prefix has them, and the grid
    aims at WAVES waves of the device's slots."""
    n, chunk = ops.plan_splits(length, bkv, slots)
    assert chunk % ops.KEYS == 0 and n >= 1
    assert (n - 1) * chunk < length <= n * chunk
    assert chunk >= min(length, ops.MIN_CHUNK)
    assert n <= max(1, -(-ops.WAVES * slots // bkv))


@pytest.mark.parametrize("length", [0, 41, -1])
def test_raises_on_length_outside_range(length):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 40, 16))
    with pytest.raises(ValueError, match="length"):
        ops.decode_attention(q, k, v, length)


def test_raises_on_float_length_tensor():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 40, 16))
    with pytest.raises(TypeError, match="length"):
        ops.decode_attention(q, k, v, torch.tensor([3.0]))


def test_raises_on_requires_grad():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q.requires_grad_(), k, v, 8)


@pytest.mark.parametrize("d", [4, 48, 256])
def test_raises_on_unsupported_head_dim(d):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, d))
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q, k, v, 8)


def test_raises_on_group_too_large():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 17, 8, 16))
    with pytest.raises(ValueError, match="query rows"):
        ops.decode_attention(q, k, v, 8)


def test_raises_on_kv_axes_that_differ():
    q, _, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 8, 16))
    _, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 16))
    with pytest.raises(ValueError, match="KV heads"):
        ops.decode_attention(q, k, v, 8)


def test_raises_on_mixed_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 16))
    with pytest.raises(TypeError):
        ops.decode_attention(q.bfloat16(), k, v, 8)


def test_cpu_tensors_launch_nothing():
    ops.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 7, 40, 16))
    ops.decode_attention(q, k, v, 40)
    ops.decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), 3)
    assert ops.launches == {"f32": 0, "bf16": 0}
