"""The port's topk_mips wrapper against the JAX package's, on the CPU.

Both sides get the same numpy inputs (seeded).  The JAX side runs its Pallas
kernel in interpret mode, as its own tests do; the port's wrapper runs its
plain version because the tensors are on the CPU.

Tolerances: f32 and bf16 scores within 1e-5 (the two sides sum in different
orders) with equal top-k rank sets; int8 images and raw int32 scores equal,
dequantized scores within rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_mips import ops as jops
from repro_torch.kernels.topk_mips import ops, ref

SHAPES = [(4, 300, 17, 10), (128, 2048, 128, 100), (7, 50, 64, 60),
          (1, 4096, 256, 1), (33, 1000, 96, 128)]
NARROW_SHAPES = [(4, 300, 17, 10), (16, 1024, 128, 50), (7, 50, 64, 60)]


def _inputs(Q, N, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


def _assert_same_topk(js, ji, ts, ti, rtol):
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = ts.numpy(), ti.numpy()
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=rtol)
    for r in range(js.shape[0]):
        assert set(ti[r]) == set(ji[r])


@pytest.mark.parametrize("score_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Q,N,D,k", SHAPES)
def test_topk_mips_matches_jax(Q, N, D, k, score_dtype):
    q, c = _inputs(Q, N, D)
    js, ji = jops.topk_mips(jnp.asarray(q), jnp.asarray(c), k=k,
                            score_dtype=score_dtype)
    ts, ti = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=k,
                           score_dtype=score_dtype)
    _assert_same_topk(js, ji, ts, ti, 1e-5)


@pytest.mark.parametrize("Q,N,D,k", NARROW_SHAPES)
def test_topk_mips_int8_matches_jax(Q, N, D, k):
    q, c = _inputs(Q, N, D, seed=1)
    jqv, jqs = (np.asarray(a) for a in jops.quantize_int8(jnp.asarray(q)))
    jcv, jcs = (np.asarray(a) for a in jops.quantize_int8(jnp.asarray(c)))
    tqv, tqs = ops.quantize_int8(torch.from_numpy(q))
    tcv, tcs = ops.quantize_int8(torch.from_numpy(c))
    np.testing.assert_array_equal(tqv.numpy(), jqv)       # int8 images
    np.testing.assert_array_equal(tcv.numpy(), jcv)
    np.testing.assert_array_equal(tqs.numpy(), jqs)
    raw_j = jqv.astype(np.int32) @ jcv.astype(np.int32).T
    raw_t = (tqv.double() @ tcv.double().T).numpy()
    np.testing.assert_array_equal(raw_t.astype(np.int32), raw_j)
    js, ji = jops.topk_mips(jnp.asarray(q), jnp.asarray(c), k=k,
                            score_dtype="int8")
    ts, ti = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=k,
                           score_dtype="int8")
    _assert_same_topk(js, ji, ts, ti, 1e-6)


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_topk_mips_chunk_carry_matches_jax(score_dtype):
    """Fold a corpus chunk by chunk into the (Q, k) carry, ragged tail
    included, on both sides."""
    Q, D, k, chunk = 9, 48, 20, 64
    q, c = _inputs(Q, 200, D, seed=2)
    jrun = (jnp.full((Q, k), -jnp.inf, jnp.float32),
            jnp.zeros((Q, k), jnp.int32))
    trun = (torch.full((Q, k), float("-inf")),
            torch.zeros((Q, k), dtype=torch.int32))
    for base in range(0, 200, chunk):
        part = np.zeros((chunk, D), np.float32)
        n_valid = min(chunk, 200 - base)
        part[:n_valid] = c[base:base + n_valid]
        part[n_valid:] = 1e3                    # padding rows must not win
        jrun = jops.topk_mips_chunk(jnp.asarray(q), jnp.asarray(part),
                                    *jrun, base=base, n_valid=n_valid,
                                    score_dtype=score_dtype)
        trun = ops.topk_mips_chunk(torch.from_numpy(q),
                                   torch.from_numpy(part), *trun, base=base,
                                   n_valid=n_valid, score_dtype=score_dtype)
    _assert_same_topk(*jrun, *trun, 1e-5 if score_dtype != "int8" else 1e-6)
    assert trun[1].max() < 200


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_topk_mips_duplicate_rows_tie_order(score_dtype):
    """Every corpus row appears 4 times with integer values, so scores tie
    exactly: the lower index must win, as lax.top_k orders them."""
    rng = np.random.default_rng(3)
    q = rng.integers(-3, 4, size=(6, 32)).astype(np.float32)
    c = np.tile(rng.integers(-3, 4, size=(25, 32)).astype(np.float32),
                (4, 1))
    js, ji = jops.topk_mips(jnp.asarray(q), jnp.asarray(c), k=30,
                            score_dtype=score_dtype)
    ts, ti = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=30,
                           score_dtype=score_dtype)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_topk_mips_n_valid_and_k_clipping():
    q, c = _inputs(5, 40, 16, seed=4)
    s, i = ops.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=60,
                         n_valid=30)
    assert s.shape == (5, 30) and int(i.max()) < 30


def test_wrapper_dispatch_is_by_device():
    """CPU tensors take the plain version; other devices and oversized k
    raise rather than fall back."""
    q = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.topk_mips(q, q, k=1)
    with pytest.raises(ValueError, match="maximum"):
        ops.topk_mips(torch.zeros(2, 8), torch.zeros(3, 8), k=ops.MAX_K + 1)
    before = dict(ops.launches)
    ops.topk_mips(torch.zeros(2, 8), torch.zeros(3, 8), k=2)
    assert ops.launches == before           # the plain version launches none


def test_plain_select_is_stable():
    s = torch.tensor([[1.0, 2.0, 2.0, 1.0, 2.0]])
    i = torch.arange(5, dtype=torch.int32)[None]
    top_s, top_i = ref.select_topk(s, i, 4)
    assert top_i.tolist() == [[1, 2, 4, 0]]


@pytest.mark.parametrize("k,n_valid,carry", [(5, 500, False), (30, 437, True),
                                             (64, 64, False), (3, 1, True),
                                             (40, 333, True),
                                             (17, 500, False)])
def test_window_plan_folds_to_the_whole_corpus_top_k(k, n_valid, carry):
    """The CUDA wrapper's window plan, replayed with the plain version at a
    tiny geometry (8-row tiles, 64 candidates): folding window by window
    into the carry gives the top k of carry + whole corpus, and no launch
    holds more keys than pass 2's candidate budget (the carry and one slot
    per row of each tile)."""
    cols, max_cand, base = 8, 64, 1000
    q, c = (torch.from_numpy(a) for a in _inputs(3, 500, 12, seed=5))
    init = (torch.randn(3, k).sort(dim=1, descending=True).values,
            torch.arange(k, dtype=torch.int32).expand(3, -1))
    run = init if carry else None
    plan = ops._windows(n_valid, k, k if carry else 0, cols, max_cand)
    assert plan[0][0] == 0 and sum(w[1] for w in plan) == n_valid
    full = ref.scores_ref(q, c)
    for w0, width, kc, k_out in plan:
        assert kc + -(-width // cols) * cols <= max_cand
        s = full[:, w0:w0 + width]
        i = (torch.arange(width, dtype=torch.int32) + base + w0).expand(3,
                                                                       -1)
        run = ref.select_topk(s, i, k_out) if run is None else \
            ref.select_topk(torch.cat([run[0], s], 1),
                            torch.cat([run[1], i], 1), k_out)
    s = full[:, :n_valid]
    i = (torch.arange(n_valid, dtype=torch.int32) + base).expand(3, -1)
    if carry:
        want = ref.select_topk(torch.cat([init[0], s], 1),
                               torch.cat([init[1], i], 1), k)
    else:
        want = ref.select_topk(s, i, min(k, n_valid))
    assert torch.equal(run[0], want[0]) and torch.equal(run[1], want[1])


def test_window_plan_raises_without_room():
    with pytest.raises(ValueError, match="no room"):
        ops._windows(100, 60, 60, 8, 64)


@pytest.mark.parametrize("D,score_dtype,want", [
    (768, "f32", 768), (768, "bf16", 768), (768, "int8", 768),
    (17, "f32", 20), (17, "bf16", 24), (17, "int8", 32),
    (96, "int8", 96), (100, "bf16", 104)])
def test_padded_dim_is_a_16_byte_row(D, score_dtype, want):
    assert ops.padded_dim(D, score_dtype) == want
    assert want * ops.ELEM_BYTES[score_dtype] % 16 == 0


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_pad_features_keeps_every_score(score_dtype):
    """Zero columns change no product: the padded operands give the same
    scores (int8: the same images and raw sums), and a row that is already
    a 16-byte multiple is passed through without a copy."""
    q, c = (torch.from_numpy(a) for a in _inputs(5, 40, 17, seed=6))
    qk, ck, qs, cs = ops._kernel_inputs(q, c, score_dtype)
    width = ops.padded_dim(17, score_dtype)
    qp, cp = ops.pad_features(qk, width), ops.pad_features(ck, width)
    assert qp.shape == (5, width) and cp.shape == (40, width)
    assert torch.equal(qp[:, :17], qk) and not qp[:, 17:].any()
    if score_dtype == "int8":
        want = ref.int8_scores_ref(qk, ck, qs, cs)
        got = ref.int8_scores_ref(qp, cp, qs, cs)
    else:
        want = qk.float() @ ck.float().T
        got = qp.float() @ cp.float().T
    assert torch.equal(got, want)
    assert ops.pad_features(qp, width) is qp


# ---------------------------------------------------------------------------
# The kernels' selection, emulated on the CPU
# ---------------------------------------------------------------------------

BN = 32          # corpus rows per pass-1 tile, as in csrc/topk_mips.cu


def _keys(s, rank):
    """The kernel's 64-bit keys: the score's bits flipped to unsigned order
    (-0 as +0), then the complement of the rank."""
    u = np.ascontiguousarray(s, np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    flip = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (flip.astype(np.uint64) << np.uint64(32)) | \
        (np.uint64(0xFFFFFFFF) - rank.astype(np.uint64))


def _key_score(key):
    u = (key >> np.uint64(32)).astype(np.uint32)
    bits = np.where(u & np.uint32(0x80000000), u & np.uint32(0x7FFFFFFF), ~u)
    return bits.astype(np.uint32).view(np.float32)


def _larger(desc, keys):
    """How many keys of the descending array ``desc`` exceed each of
    ``keys`` (the kernel's binary search)."""
    return len(desc) - np.searchsorted(desc[::-1], keys, side="right")


def _emulate_launch(scores, carry_s, carry_i, base, k_out):
    """One library call.  Pass 1: tiles of 32 rows, the strict filter at
    the carry's k_out-th score, survivors compacted per segment.  Pass 2:
    when more survive than the sort takes (max(next_pow2(k_out), 256)), the
    radix select of the k_out-th survivor key (8-bit digits, stopping when
    the boundary digit holds exactly the keys still needed); the survivors
    kept, sorted; each entry placed at its place in its own list plus the
    number of larger keys in the other."""
    Q, N = scores.shape
    kc = 0 if carry_s is None else carry_s.shape[1]
    kc_used = min(kc, k_out)
    n_tiles = -(-N // BN)
    seg_s = np.zeros((Q, n_tiles, BN), np.float32)
    seg_c = np.zeros((Q, n_tiles, BN), np.int64)
    cnt = np.zeros((Q, n_tiles), np.int64)
    for t in range(n_tiles):
        cols = np.arange(t * BN, min(N, (t + 1) * BN))
        for r in range(Q):
            s = scores[r, cols]
            keep = s > carry_s[r, k_out - 1] if kc >= k_out else \
                np.ones(len(cols), bool)
            cnt[r, t] = keep.sum()
            seg_s[r, t, :cnt[r, t]] = s[keep]
            seg_c[r, t, :cnt[r, t]] = cols[keep]
    out_s = np.full((Q, k_out), np.nan, np.float32)
    out_i = np.full((Q, k_out), -1, np.int64)
    for r in range(Q):
        carry = _keys(carry_s[r, :kc_used] if kc else np.zeros(0, np.float32),
                      np.arange(kc_used))
        assert np.all(carry[:-1] > carry[1:])        # the carry descends
        surv = _keys(np.concatenate([seg_s[r, t, :cnt[r, t]]
                                     for t in range(n_tiles)]),
                     kc + np.concatenate([seg_c[r, t, :cnt[r, t]]
                                          for t in range(n_tiles)]))
        prefix, mask, need = np.uint64(0), np.uint64(0), k_out
        sort_n = max(1 << (k_out - 1).bit_length(), 256)
        for shift in range(56, -1, -8):
            if len(surv) <= sort_n:
                break
            sel = surv[(surv & mask) == prefix]
            hist = np.bincount(((sel >> np.uint64(shift)) & np.uint64(0xFF))
                               .astype(np.int64), minlength=256)
            incl = np.cumsum(hist[::-1])
            t = int(np.argmax(incl >= need))
            b, excl = 255 - t, int(incl[t] - hist[255 - t])
            need -= excl
            prefix |= np.uint64(b) << np.uint64(shift)
            mask |= np.uint64(0xFF) << np.uint64(shift)
            if hist[b] == need:
                break
        best = np.sort(surv[(surv & mask) >= prefix])[::-1]
        assert len(best) == (k_out if len(surv) > sort_n else len(surv))
        at_b = np.arange(len(best)) + _larger(carry, best)
        at_c = np.arange(kc_used) + _larger(best, carry)
        for at, key, idx in ((at_b, best, None), (at_c, carry, carry_i)):
            keep = at < k_out
            out_s[r, at[keep]] = _key_score(key[keep])
            rank = (np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF))
                    ).astype(np.int64)[keep]
            out_i[r, at[keep]] = base + rank - kc if idx is None else \
                idx[r][rank]
        assert (out_i[r] >= 0).all()                 # every place filled
    return out_s, out_i.astype(np.int32)


def _emulate(score_dtype, q, c, *, k_target, n_valid, carry=None, base=0,
             max_cand=16384):
    """``ops._topk_cuda`` with every library call emulated: the same
    windows, each scored with the plain version's arithmetic."""
    qk, ck, _, _ = ops._kernel_inputs(q, c, score_dtype)
    run_s, run_i = (None, None) if carry is None else \
        (carry[0].numpy(), carry[1].numpy())
    for w0, width, kc, k_out in ops._windows(
            n_valid, k_target, 0 if run_s is None else run_s.shape[1], BN,
            max_cand):
        scores = ref.scores_ref(q, c[w0:w0 + width], score_dtype).numpy()
        run_s, run_i = _emulate_launch(scores, run_s, run_i, base + w0,
                                       k_out)
    return torch.from_numpy(run_s), torch.from_numpy(run_i)


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("Q,N,D,k,max_cand", [
    (4, 300, 17, 10, 16384), (7, 50, 64, 60, 16384),
    (16, 1024, 128, 50, 16384), (3, 700, 32, 40, 256),
    (5, 900, 48, 20, 16384), (4, 600, 32, 70, 320)])
def test_emulated_selection_matches_jax(Q, N, D, k, max_cand, score_dtype):
    """The kernels' selection (filter, radix select when more than k
    survive, sort, merge with the carry) over the plain version's scores
    equals the JAX kernel's top-k, windows included."""
    q, c = _inputs(Q, N, D, seed=7)
    js, ji = jops.topk_mips(jnp.asarray(q), jnp.asarray(c), k=k,
                            score_dtype=score_dtype)
    ts, ti = _emulate(score_dtype, torch.from_numpy(q), torch.from_numpy(c),
                      k_target=min(k, N), n_valid=N, max_cand=max_cand)
    _assert_same_topk(js, ji, ts, ti, 1e-5 if score_dtype != "int8" else 1e-6)


def _integer_rows(rng, n, D=32):
    return rng.integers(-3, 4, size=(n, D)).astype(np.float32)


@pytest.mark.parametrize("chunk", [64, 300])
@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_emulated_selection_duplicate_rows_and_ragged_chunks(score_dtype,
                                                            chunk):
    """Integer rows, every one four times, folded chunk by chunk from a -inf
    carry with a ragged last chunk: exact ties everywhere, equal to the JAX
    kernel bit for bit.  Chunks of 300 survive past the sort's 256 keys, so
    their ties go through the radix select."""
    rng = np.random.default_rng(8)
    q, c = _integer_rows(rng, 6), np.tile(_integer_rows(rng, 45), (8, 1))
    k = 40
    jrun = (jnp.full((6, k), -jnp.inf, jnp.float32), jnp.zeros((6, k),
                                                                jnp.int32))
    trun = (torch.full((6, k), float("-inf")),
            torch.zeros((6, k), dtype=torch.int32))
    for base in range(0, 360, chunk):
        n_valid = min(chunk, 360 - base)
        part = c[base:base + chunk]
        jrun = jops.topk_mips_chunk(jnp.asarray(q), jnp.asarray(part), *jrun,
                                    base=base, n_valid=n_valid,
                                    score_dtype=score_dtype)
        trun = _emulate(score_dtype, torch.from_numpy(q),
                        torch.from_numpy(part), k_target=k, n_valid=n_valid,
                        carry=trun, base=base)
    np.testing.assert_array_equal(trun[0].numpy(), np.asarray(jrun[0]))
    np.testing.assert_array_equal(trun[1].numpy(), np.asarray(jrun[1]))


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_emulated_selection_ties_at_the_threshold_lose(score_dtype):
    """A full carry from one integer chunk, then a chunk that holds each of
    its rows again: every row's k-th carry score recurs exactly and must
    lose to the carry, as in the JAX kernel."""
    rng = np.random.default_rng(9)
    q, c1 = _integer_rows(rng, 8), _integer_rows(rng, 120)
    c2 = np.concatenate([c1[rng.permutation(120)], _integer_rows(rng, 50)])
    k = 30
    jrun = (jnp.full((8, k), -jnp.inf, jnp.float32), jnp.zeros((8, k),
                                                                jnp.int32))
    jrun = jops.topk_mips_chunk(jnp.asarray(q), jnp.asarray(c1), *jrun,
                                base=0, score_dtype=score_dtype)
    carry = (torch.from_numpy(np.array(jrun[0])),
             torch.from_numpy(np.array(jrun[1])))
    tau = carry[0][:, k - 1:k]
    assert bool((ref.scores_ref(torch.from_numpy(q), torch.from_numpy(c2),
                                score_dtype) == tau).any(1).all())
    jrun = jops.topk_mips_chunk(jnp.asarray(q), jnp.asarray(c2), *jrun,
                                base=120, score_dtype=score_dtype)
    ts, ti = _emulate(score_dtype, torch.from_numpy(q), torch.from_numpy(c2),
                      k_target=k, n_valid=170, carry=carry, base=120)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jrun[0]))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jrun[1]))


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_emulated_selection_short_chunk_into_minus_inf_carry(score_dtype):
    """Fewer real rows than k into a -inf carry: the chunk's rows come
    first, then the carry's -inf entries in their own order."""
    q, c = _inputs(5, 64, 24, seed=10)
    k, n_valid = 20, 7
    jrun = jops.topk_mips_chunk(
        jnp.asarray(q), jnp.asarray(c), jnp.full((5, k), -jnp.inf,
                                                 jnp.float32),
        jnp.arange(k, dtype=jnp.int32)[None].repeat(5, 0), base=500,
        n_valid=n_valid, score_dtype=score_dtype)
    carry = (torch.full((5, k), float("-inf")),
             torch.arange(k, dtype=torch.int32).expand(5, -1).contiguous())
    ts, ti = _emulate(score_dtype, torch.from_numpy(q), torch.from_numpy(c),
                      k_target=k, n_valid=n_valid, carry=carry, base=500)
    _assert_same_topk(jrun[0], jrun[1], ts, ti,
                      1e-5 if score_dtype != "int8" else 1e-6)
    np.testing.assert_array_equal(ti.numpy()[:, n_valid:],
                                  np.arange(k - n_valid)[None].repeat(5, 0))


def test_keys_order_scores_then_ranks():
    """Unsigned key order is the output order: larger score first, then
    the lower rank; -0 ties +0; the score comes back from the key."""
    s = np.array([1.5, -2.0, 0.0, -0.0, 1.5, -np.inf, 3.25], np.float32)
    rank = np.arange(len(s))
    keys = _keys(s, rank)
    order = np.argsort(keys)[::-1]
    assert order.tolist() == [6, 0, 4, 2, 3, 1, 5]
    np.testing.assert_array_equal(_key_score(keys), s + np.float32(0))
