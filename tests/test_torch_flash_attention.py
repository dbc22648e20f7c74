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

import importlib.util
import os

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
# The bf16 kernel's arithmetic
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


# ---------------------------------------------------------------------------
# The f32 kernel's arithmetic: split-TF32 ("3xTF32") products
# ---------------------------------------------------------------------------

# chip_smoke.py's f32 gate: |kernel - plain| <= 1e-4
F32_GATE = 1e-4
# (B, H, KV, S, T, d, causal, t_valid): the reference's cases, qwen2-0.5b
# heads at a quarter of the LM path's sequence, and a d=128 case whose
# t_valid cuts a 32-key tile
TF32_CASES = [c + (None,) for c in SPLIT_CASES] + [
    (1, 4, 1, 192, 320, 128, False, 250)]
LOG2E = 1.4426950408889634


def _tf32_rna(x):
    """x (f32) rounded to TF32, 10 mantissa bits, to nearest with ties away
    from zero, as the kernel's ``cvt.rna.tf32.f32`` rounds: integer
    operations on the f32 bits (add half of the 13 dropped bits' unit to
    the magnitude, clear them).  A NaN stays a NaN, as cvt.rna keeps it
    (its payload is not modelled): the addition's carry would turn it into
    a zero or an infinity, so it is made quiet instead."""
    x = np.ascontiguousarray(_np(x))
    bits = x.view(np.uint32)
    out = np.where(np.isnan(x), bits | np.uint32(0x400000),
                   bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(out.astype(np.uint32).view(np.float32))


def _tf32_split(x):
    """(x_hi, x_lo) = (tf32(x), tf32(x - x_hi)), as the kernel splits."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tf32_product(a, b, split):
    """a @ b as the kernel's tensor cores take it: a_hi b_hi + a_hi b_lo +
    a_lo b_hi (or one TF32 product, split off), f32 sums."""
    if not split:
        return _tf32_rna(a) @ _tf32_rna(b)
    a_hi, a_lo = _tf32_split(a)
    b_hi, b_lo = _tf32_split(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def _tf32x3_attention(q, k, v, *, causal, t_valid=None, split=True):
    """The f32 kernel's arithmetic on f32 q, k, v, tile by tile: K / V tiles
    of ``ops.block_keys("f32", d)`` keys (zero past T, as TMA fills them);
    S = q . k^T as split-TF32 products; keys at kpos >= t_valid and (causal)
    kpos > qpos masked; 1/sqrt(d) log2 e applied to the f32 scores; online
    softmax in the log2 domain with m, l and the accumulator in f32 (exp2
    exact where the kernel's ex2.approx is within 2 ulp); p . v as
    split-TF32 products with keys permuted inside each 8-key group as the
    kernel's V^T holds them (key 2t at column t, key 2t + 1 at t + 4); one
    division by l.  ``split`` off takes one TF32 product per product."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    group = H // KV
    t_valid = T if t_valid is None else t_valid
    bk = ops.block_keys("f32", d)
    pad = -T % bk
    kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
              .repeat_interleave(group, dim=1) for x in (k, v))
    scale_log2 = np.float32(np.float32(1.0 / d ** 0.5) * np.float32(LOG2E))
    j = np.arange(bk)
    perm = torch.from_numpy((j & ~7) | (j & 7) >> 1 | (j & 1) << 2)
    order = torch.argsort(perm)           # order[col] = key at that column
    qpos = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), float("-inf"))
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, d))
    for k0 in range(0, T + pad, bk):
        kpos = k0 + torch.arange(bk)[None, :]
        s = _tf32_product(q.float(), kf[:, :, k0:k0 + bk].transpose(2, 3),
                          split)
        masked = kpos >= t_valid
        if causal:
            masked = masked | (kpos > qpos)
        s = s.masked_fill(masked, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp2(m - base)
        # fmaf(s, scale_log2, -base): one rounding, as in f64 then f32
        p = torch.exp2((s.double() * float(scale_log2) - base.double())
                       .float())
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _tf32_product(
            p[..., order], vf[:, :, k0:k0 + bk][:, :, order], split)
        m = m_new
    return acc / torch.where(l > 0, l, 1.0)


def _tf32_inputs(B, H, KV, S, T, d):
    return [torch.from_numpy(a) for a in _inputs(B, H, KV, S, T, d)]


@pytest.mark.parametrize("B,H,KV,S,T,d,causal,t_valid", TF32_CASES)
def test_tf32x3_matches_jax(B, H, KV, S, T, d, causal, t_valid):
    """Split-TF32 products keep the f32 kernel within the card's f32 gate
    (1e-4) of the JAX kernel (interpret mode) and of the plain version."""
    q, k, v = _tf32_inputs(B, H, KV, S, T, d)
    got = _tf32x3_attention(q, k, v, causal=causal, t_valid=t_valid)
    want = jflash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                  causal=causal, t_valid=t_valid, bq=min(S, 256), bk=256)
    plain = flash_attention_ref(q, k, v, causal=causal, t_valid=t_valid)
    err_jax = float(np.abs(got.numpy() - _np(want)).max())
    err_plain = float((got - plain).abs().max())
    assert err_jax <= F32_GATE, f"worst |emulation - JAX kernel| {err_jax:.3g}"
    assert err_plain <= F32_GATE, f"worst |emulation - plain| {err_plain:.3g}"


def test_single_tf32_outside_gate():
    """Why operands are split: one TF32 product per product leaves the f32
    gate (each operand rounded by up to 2**-11 relative)."""
    B, H, KV, S, T, d, causal, t_valid = TF32_CASES[len(SPLIT_CASES) - 1]
    q, k, v = _tf32_inputs(B, H, KV, S, T, d)
    plain = flash_attention_ref(q, k, v, causal=causal)
    err = float((_tf32x3_attention(q, k, v, causal=causal, split=False)
                 - plain).abs().max())
    assert err > 5 * F32_GATE, f"single TF32 worst |delta| {err:.3g}"


# the card's own NaN (all mantissa bits set), as the f32 bits of q or v
CARD_NAN = 0x7FFFFFFF


@pytest.mark.parametrize("where", ["q", "v"])
def test_tf32x3_propagates_nan(where):
    """A NaN in a query row or in V at key 0 (which every causal row
    attends) comes out where the plain version's does, and nowhere else:
    the split must not turn it into a finite number."""
    q, k, v = _tf32_inputs(1, 2, 1, 48, 48, 16)
    if where == "q":
        q.view(torch.int32)[0, 1, 5, 3] = CARD_NAN
    else:
        v.view(torch.int32)[0, 0, 0, 7] = CARD_NAN
    got = _tf32x3_attention(q, k, v, causal=True)
    plain = flash_attention_ref(q, k, v, causal=True)
    assert torch.isnan(plain).any()
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    fin = ~torch.isnan(plain)
    assert float((got[fin] - plain[fin]).abs().max()) <= F32_GATE


@pytest.mark.parametrize("inputs", ["normal", "wide_exponent"])
def test_tf32_split_exact(inputs):
    """x_hi + x_lo is x to 2**-22 relative; both have their low 13 bits
    zero; ties round away from zero."""
    rng = np.random.default_rng(5)
    if inputs == "normal":
        x = rng.standard_normal(1 << 16).astype(np.float32)
    else:
        x = (rng.choice([-1.0, 1.0], 1 << 16) * (1 + rng.random(1 << 16))
             * 2.0 ** rng.integers(-60, 61, 1 << 16)).astype(np.float32)
    hi, lo = _tf32_split(torch.from_numpy(x))
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    gap = np.abs(x.astype(np.float64) - hi.numpy().astype(np.float64)
                 - lo.numpy().astype(np.float64))
    assert (gap <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11],
                        dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32_rna(ties).numpy(),
        np.float32([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10]))
    # NaNs stay NaNs: 0x7fffffff is the card's own NaN, where adding half
    # a unit carries into the sign; 0x7f800001 has only low bits set
    nans = np.uint32([0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0xFFFFF000,
                      0x7F800001]).view(np.float32)
    for part in _tf32_split(torch.from_numpy(nans)):
        assert np.isnan(part.numpy()).all(), part.numpy().view(np.uint32)
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("layout", ["contiguous", "trunk_view"])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_tensor_map_geometry(d, layout, dt):
    B, H, S = 2, 14, 300
    es = {"bf16": 2, "f32": 4}[dt]
    if layout == "contiguous":
        t = torch.zeros(B, H, S, d, dtype=_TORCH_DT[dt])
        strides = (es * d, es * S * d, es * H * S * d)
    else:                                   # the trunk's x.transpose(1, 2)
        t = torch.zeros(B, S, H, d, dtype=_TORCH_DT[dt]).transpose(1, 2)
        strides = (es * H * d, es * d, es * S * H * d)
    rows = ops.block_keys(dt, d)
    geo = ops.tensor_map_geometry(t, rows)
    assert geo.dims == (d, S, H, B)
    assert geo.strides == strides
    # columns per box: d padded to 16, at most 128 bytes
    width = {8: 16, 16: 16, 32: 32, 64: 64, 128: 64}[d] if dt == "bf16" \
        else {8: 16, 16: 16, 32: 32, 64: 32, 128: 32}[d]
    assert geo.box == (width, rows, 1, 1)
    assert geo.swizzle == es * width
    if dt == "bf16":
        assert rows == (64 if d == 128 else 128)
    else:
        assert rows == (32 if d == 128 else 64)
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


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("built_in_loop", [False, True])
def test_carried_a_fragments(built_in_loop):
    """chip_smoke.py's SASS check: a register A fragment loaded once before
    a loop, read by an HGMMA in it and overwritten later in the loop (ptxas
    reuses its registers) is counted; one built in the loop is not."""
    loads = ["LDS R40, [R2+0x8000]", "LDS R41, [R3+0x8000]",
             "LDS.64 R42, [R4+0x8000]"]
    loop = ["WARPGROUP.ARRIVE",
            "HGMMA.64x64x8.F32.TF32 R0, R40, gdesc[UR16], R0, gsb0",
            "WARPGROUP.DEPBAR.LE gsb0, 0x0", "MUFU.EX2 R41, R9",
            "FADD R8, R8, R41", "@!P0 BRA 0x{start:x}", "EXIT"]
    pre = ["S2R R2, SR_TID.X"] + ([] if built_in_loop else loads)
    start = 0x10 * len(pre)               # the loop's first instruction
    body = pre + (loads if built_in_loop else []) + [
        t.format(start=start) for t in loop]
    sass = [f"        /*{0x10 * i:04x}*/   {t} ;   /* 0x0 */"
            for i, t in enumerate(body)]
    assert _chip_smoke().carried_a_fragments(sass) == (
        0 if built_in_loop else 1)

