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


# ---------------------------------------------------------------------------
# The bf16 kernel's arithmetic and its TMA geometry
# ---------------------------------------------------------------------------

# chip_smoke.py's bf16 gate: |kernel - plain_f32| <= 2**-8 |plain_f32| + 1e-5
HALF_ULP, ABS_SLACK = 2.0 ** -8, 1e-5
# qwen2-0.5b heads at a quarter of the LM path's sequence
SPLIT_CASES = CASES + [(1, 14, 2, 512, 512, 64, True)]


def _excess(got, want32):
    """Largest excess of |got - want32| over half a bf16 ulp of want32."""
    got, want32 = (torch.from_numpy(np.array(_np(x))) for x in (got, want32))
    return float(((got - want32).abs() - HALF_ULP * want32.abs()).max())


def _tensor_core_attention(q, k, v, *, causal, split_p=True):
    """The bf16 kernel's arithmetic on bf16 q, k, v: exact bf16 products of
    q . k summed in f32, 1/sqrt(d) on the f32 scores, p = exp(s - m) in
    f32 with l summed from it, p . v as p_hi . v + p_lo . v (p_hi =
    bf16(p), p_lo = bf16(p - p_hi)) or, with ``split_p`` off, bf16(p) . v,
    f32 sums, one rounding of the output to bf16."""
    S, d = q.shape[2], q.shape[3]
    T, group = k.shape[2], q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * (1.0 / d ** 0.5)
    if causal:
        above = torch.arange(T)[None, :] > torch.arange(S)[:, None]
        s = s.masked_fill(above, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p_hi = p.bfloat16().float()
    if split_p:
        o = p_hi @ vf + (p - p_hi).bfloat16().float() @ vf
    else:
        o = p_hi @ vf
    return (o / l).bfloat16()


@pytest.mark.parametrize("B,H,KV,S,T,d,causal", SPLIT_CASES)
def test_split_p_within_half_ulp(B, H, KV, S, T, d, causal):
    """Split p keeps the bf16 kernel within half a bf16 ulp (+1e-5) of the
    f32 result: the JAX kernel (interpret mode) and the plain version, both
    at f32 on the same bf16 values."""
    (_, _, _), (q, k, v) = _both(_inputs(B, H, KV, S, T, d), "bf16")
    got = _tensor_core_attention(q, k, v, causal=causal)
    q32, k32, v32 = q.float(), k.float(), v.float()
    jax_f32 = jflash(*(jnp.asarray(x.numpy()) for x in (q32, k32, v32)),
                     causal=causal, bq=min(S, 256), bk=256)
    plain_f32 = flash_attention_ref(q32, k32, v32, causal=causal)
    assert _excess(got, jax_f32) <= ABS_SLACK
    assert _excess(got, plain_f32) <= ABS_SLACK


def test_bf16_p_outside_half_ulp():
    """Why p is split: rounding p to bf16 for p . v leaves the gate."""
    B, H, KV, S, T, d, causal = SPLIT_CASES[-1]
    (_, _, _), (q, k, v) = _both(_inputs(B, H, KV, S, T, d), "bf16")
    plain_f32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal)
    excess = _excess(_tensor_core_attention(q, k, v, causal=causal,
                                            split_p=False), plain_f32)
    assert excess > 10 * ABS_SLACK


@pytest.mark.parametrize("layout", ["contiguous", "trunk_view"])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
def test_tensor_map_geometry(d, layout):
    B, H, S = 2, 14, 300
    if layout == "contiguous":
        t = torch.zeros(B, H, S, d, dtype=torch.bfloat16)
        strides = (2 * d, 2 * S * d, 2 * H * S * d)
    else:                                   # the trunk's x.transpose(1, 2)
        t = torch.zeros(B, S, H, d, dtype=torch.bfloat16).transpose(1, 2)
        strides = (2 * H * d, 2 * d, 2 * S * H * d)
    rows = ops.block_keys(d)
    geo = ops.tensor_map_geometry(t, rows)
    assert geo.dims == (d, S, H, B)
    assert geo.strides == strides
    width = {8: 16, 16: 16, 32: 32, 64: 64, 128: 64}[d]   # columns per box
    assert geo.box == (width, rows, 1, 1)
    assert geo.swizzle == 2 * width
    assert rows == (64 if d == 128 else 128)
    assert len(geo.flat()) == 12


def test_tensor_map_geometry_raises_on_misaligned_base():
    flat = torch.zeros(1 + 2 * 2 * 8 * 16, dtype=torch.bfloat16)
    t = flat[1:].view(2, 2, 8, 16)          # starts 2 bytes past 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.tensor_map_geometry(t, ops.BLOCK_Q)


def test_tensor_map_geometry_raises_on_stride():
    t = torch.zeros(1, 2, 8, 12, dtype=torch.bfloat16)[..., :8]  # 24 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ops.tensor_map_geometry(t, ops.BLOCK_Q)
