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


@pytest.mark.parametrize("length,bkv,slots,keys", [
    (1, 1, 132, 64), (31, 4, 132, 64), (32768, 256, 132, 64),
    (32768, 2, 132, 64), (524288, 2, 132, 64), (524288, 2, 132, 32),
    (143, 8, 132, 64), (1000, 1, 1, 32), (700, 64, 132, 32),
    (65537, 3, 264, 64), (4999, 2, 132, 64), (32768, 64, 132, 32)])
def test_plan_splits_cover_the_prefix(length, bkv, slots, keys):
    """Every key of [0, length) lies in exactly one non-empty split; splits
    are whole tiles of ``keys`` (the last may be shorter), at least
    MIN_CHUNK keys where the prefix has them, and the grid fits WAVES waves
    of the device's slots (or one split per (b, h) beyond them)."""
    n, chunk = ops.plan_splits(length, bkv, slots, keys)
    assert chunk % keys == 0 and n >= 1
    owner = np.zeros(length, np.int64)
    for s in range(n):
        lo, hi = s * chunk, min((s + 1) * chunk, length)
        assert lo < hi                                   # non-empty
        owner[lo:hi] += 1
    assert (owner == 1).all()
    assert chunk >= min(length, ops.MIN_CHUNK)
    assert bkv * n <= max(bkv, ops.WAVES * slots)


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


# ---------------------------------------------------------------------------
# The kernel's arithmetic, its split plan and its TMA geometry
# ---------------------------------------------------------------------------

# chip_smoke.py's bf16 gate: |kernel - plain_f32| <= 2**-8 |plain_f32| + 1e-5
HALF_ULP, ABS_SLACK = 2.0 ** -8, 1e-5
LOG2E = 1.4426950408889634
#: consumer warps of a bf16 block, which take the tiles of a split in turn
CONSUMERS = 4
# (B, KV, G, T, d, length, slots): the reference's cases at a card's worth
# of slots, and qwen2-0.5b / qwen2-72b heads with few slots, so that the
# prefix is cut into several splits and pass 2 merges them
EMU_CASES = [c + (132,) for c in CASES] + [
    (1, 2, 7, 4096, 64, 4000, 8),
    (2, 2, 8, 2048, 128, 1999, 16),
    (1, 1, 16, 1500, 16, 1500, 3),
]


def _excess(got, want32):
    """Largest excess of |got - want32| over half a bf16 ulp of want32."""
    got, want32 = (torch.from_numpy(np.array(_np(x))) for x in (got, want32))
    return float(((got - want32).abs() - HALF_ULP * want32.abs()).max())


def _merge(parts):
    """(m, l, acc) partials in log2 units, merged in their order."""
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L, A = torch.zeros_like(M), None
    for m, l, acc in parts:
        w = torch.exp2(m - M)              # 0 for a warp without a tile
        L = L + l * w
        A = acc * w if A is None else A + acc * w
    return M, L, A


def _emulate_kernel(q, k, v, length, slots, *, split_p=True):
    """The bf16 kernel on bf16 q (B, KV, G, d), k, v (B, KV, T, d): the
    split plan of the wrapper; per split, tile i of BK keys to consumer warp
    i % 4, each with its own online softmax in log2 units (exact bf16
    products of q . k summed in f32, times 1/sqrt(d) log2 e in f32,
    p = 2^(s - m)), p . v as p_hi . v + p_lo . v (p_hi = bf16(p),
    p_lo = bf16(p - p_hi)) or, with ``split_p`` off, bf16(p) . v; the warps
    merged in order, then the splits in order; one rounding to bf16."""
    B, KV, G, d = q.shape
    keys = ops.block_keys("bf16", d)
    n, chunk = ops.plan_splits(length, B * KV, slots, keys)
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = (torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    splits = []
    for s in range(n):
        start, end = s * chunk, min((s + 1) * chunk, length)
        n_tiles = -(-(end - start) // keys)
        warps = []
        for w in range(CONSUMERS):
            m = torch.full((B, KV, G, 1), float("-inf"))
            l, acc = torch.zeros((B, KV, G, 1)), torch.zeros((B, KV, G, d))
            for i in range(w, n_tiles, CONSUMERS):
                t0 = start + i * keys
                t1 = min(t0 + keys, end)
                sc = torch.einsum("bhgd,bhtd->bhgt", qf,
                                  kf[:, :, t0:t1]) * scale_log2
                m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                corr, p = torch.exp2(m - m_new), torch.exp2(sc - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                p_hi = p.bfloat16().float()
                pv = p_hi @ vf[:, :, t0:t1]
                if split_p:
                    pv = pv + (p - p_hi).bfloat16().float() @ vf[:, :, t0:t1]
                acc, m = acc * corr + pv, m_new
            warps.append((m, l, acc))
        splits.append(_merge(warps))
    _, L, A = _merge(splits) if n > 1 else splits[0]
    return (A / L).bfloat16()


@pytest.mark.parametrize("B,KV,G,T,d,L,slots", EMU_CASES)
def test_tensor_core_arithmetic_within_half_ulp(B, KV, G, T, d, L, slots):
    """The bf16 kernel's arithmetic stays within half a bf16 ulp (+1e-5) of
    the f32 result: the JAX kernel (interpret mode) and the plain version,
    both at f32 on the same bf16 values."""
    (_, _, _), (q, k, v) = _both(_inputs(B, KV, G, T, d, seed=5), "bf16")
    got = _emulate_kernel(q, k, v, L, slots)
    q32, k32, v32 = q.float(), k.float(), v.float()
    jax_f32 = jdecode(*(jnp.asarray(x.numpy()) for x in (q32, k32, v32)), L,
                      bk=128)
    plain_f32 = decode_attention_ref(L, q32, k32, v32)
    assert _excess(got, jax_f32) <= ABS_SLACK
    assert _excess(got, plain_f32) <= ABS_SLACK


def test_bf16_p_outside_half_ulp():
    """Why p is split: rounding p to bf16 for p . v leaves the gate."""
    B, KV, G, T, d, L, slots = EMU_CASES[-3]
    (_, _, _), (q, k, v) = _both(_inputs(B, KV, G, T, d, seed=5), "bf16")
    plain_f32 = decode_attention_ref(L, q.float(), k.float(), v.float())
    excess = _excess(_emulate_kernel(q, k, v, L, slots, split_p=False),
                     plain_f32)
    assert excess > 10 * ABS_SLACK


def test_emulation_splits_the_prefix():
    """The emulated cases exercise what the card runs: several splits and a
    pass-2 merge, and warps left without a tile."""
    plans = [ops.plan_splits(L, B * KV, slots, ops.block_keys("bf16", d))
             for (B, KV, G, T, d, L, slots) in EMU_CASES]
    assert plans[4][0] > 1 and plans[5][0] > 1
    n, chunk = plans[2]                      # (3, 1, 7, 300, 32, 1)
    assert n == 1 and -(-1 // ops.block_keys("bf16", 32)) < CONSUMERS


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
def test_tensor_map_geometry_of_the_cache_views(d, dt):
    """K and V as the trunk passes them, (B, T, KV, d) transposed: one map
    per tensor, boxes of the kernel's tile of keys, rows padded to 16
    columns and swizzled by their width up to 128 bytes."""
    B, T, KV = 2, 300, 3
    t = torch.zeros(B, T, KV, d, dtype=_TORCH_DT[dt]).transpose(1, 2)
    es = t.element_size()
    rows = ops.block_keys(dt, d)
    assert rows == (64 if dt == "bf16" and d <= 64 else 32)
    geo = ops._geometry(t, t, rows)
    width = min(max(d, 16) * es, 128)
    one = (d, T, KV, B, KV * d * es, d * es, T * KV * d * es,
           width // es, rows, 1, 1, width)
    assert tuple(geo) == one + one
    assert ops._geometry(t, t, rows) is geo        # kept, not recomputed


def test_geometry_raises_on_what_tma_refuses():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 16))
    flat = torch.zeros(1 + 2 * 8 * 16)
    misaligned = flat[1:].view(1, 2, 8, 16)        # 4 bytes past 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._geometry(misaligned, v, 32)
    narrow = torch.zeros(1, 2, 8, 18)[..., :16]    # rows 72 bytes apart
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ops._geometry(k, narrow, 32)
