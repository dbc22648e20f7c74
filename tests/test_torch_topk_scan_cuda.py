"""The scan of the topk_mips kernels on the card; every test skips without
a CUDA device.  Run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/*_cuda.py

The scan takes an f32 ``topk_mips`` call of at most 16 query rows over a
corpus longer than one window of the tiled pass.  It is held against the
plain version (the same top-k ids, scores of unit rows within 1e-5, as
``chip_smoke.py`` holds the kernels) and against the tiled pass over the
same rows, reached through the chunk-carry entry point from a -inf carry,
which never takes the scan: there the scores and rows are bit-identical,
ties included.  This file imports no JAX: the card has none.
"""

import pytest
import torch

from repro_torch.kernels.topk_mips import ops, ref

pytestmark = pytest.mark.cuda

#: rows of each tiled fold: one window of the tiled pass beside a carry
#: of k <= 32 (16,384 candidates, in 32-row tiles)
CHUNK = 16_384 - 32


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel runs only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(device, Q, N, D, seed, integer=False):
    g = torch.Generator(device=device).manual_seed(seed)
    if integer:       # exact sums, ties everywhere
        q = torch.randint(-1, 2, (Q, D), generator=g, device=device).float()
        c = torch.randint(-1, 2, (N, D), generator=g, device=device).float()
    else:             # unit rows, as a served index holds
        q = torch.randn((Q, D), generator=g, device=device)
        c = torch.randn((N, D), generator=g, device=device)
        q = q / q.norm(dim=1, keepdim=True)
        c = c / c.norm(dim=1, keepdim=True)
    c[N // 2:N // 2 + 50] = c[100:150]            # duplicate rows
    return q, c


@pytest.mark.parametrize("Q", [1, 8, 16])
def test_scan_matches_plain_version(device, Q):
    """N spans five windows of the tiled pass; one library call."""
    q, c = _inputs(device, Q, 70_001, 768, seed=Q)
    ops.reset_launches()
    s, i = ops.topk_mips(q, c, k=10)
    torch.cuda.synchronize()
    assert ops.scan_calls == 1 and ops.launches["f32"] == 1
    rs, ri = ref.topk_mips_ref(q, c, k=10)
    assert torch.equal(torch.sort(i, 1).values,
                       torch.sort(ri.to(i.dtype), 1).values)
    assert float((s - rs).abs().max()) <= 1e-5


@pytest.mark.parametrize("Q,N,D,k,n_valid,integer", [
    (1, 70_001, 768, 10, 70_001, False),
    (8, 70_001, 768, 10, 66_000, False),
    (16, 70_001, 768, 32, 70_001, False),
    (8, 50_000, 768, 32, 50_000, True),
    (3, 20_000, 20, 7, 20_000, False),      # D not a multiple of 32
    (4, 50_000, 896, 10, 49_999, False)])
def test_scan_bit_equal_to_tiled_fold(device, Q, N, D, k, n_valid, integer):
    """The same rows folded through ``topk_mips_chunk`` from a -inf carry,
    a window a call, at the same Q: identical scores and rows."""
    q, c = _inputs(device, Q, N, D, seed=N + Q, integer=integer)
    ops.reset_launches()
    s, i = ops.topk_mips(q, c, k=k, n_valid=n_valid)
    assert ops.scan_calls == 1
    run = (torch.full((Q, k), float("-inf"), device=device),
           torch.zeros((Q, k), dtype=torch.int32, device=device))
    for base in range(0, n_valid, CHUNK):
        run = ops.topk_mips_chunk(q, c[base:base + CHUNK], *run, base=base,
                                  n_valid=min(CHUNK, n_valid - base))
    torch.cuda.synchronize()
    assert ops.scan_calls == 1
    assert torch.equal(s, run[0]) and torch.equal(i, run[1])
    assert int(i.max()) < n_valid


def test_scan_calls_count_each_scan(device):
    """``scan_calls`` advances once per scanned call; calls the rule leaves
    to the tiled pass (100 query rows, a carry fold, bf16) do not move it,
    and every call counts once in ``launches``."""
    q, c = _inputs(device, 100, 40_000, 64, seed=5)
    ops.reset_launches()
    for n in range(1, 4):
        ops.topk_mips(q[:8], c, k=10)
        assert ops.scan_calls == n and ops.launches["f32"] == n
    ops.topk_mips(q, c, k=10)
    run = (torch.full((8, 10), float("-inf"), device=device),
           torch.zeros((8, 10), dtype=torch.int32, device=device))
    ops.topk_mips_chunk(q[:8], c[:CHUNK], *run, base=0)
    ops.topk_mips(q[:8], c, k=10, score_dtype="bf16")
    torch.cuda.synchronize()
    assert ops.scan_calls == 3
    assert ops.launches["f32"] == 3 + 3 + 1 and ops.launches["bf16"] == 3
