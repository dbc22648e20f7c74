"""The port's watcher policies × retries, and the adaptive BudgetPolicy.

Mirrors tests/test_watcher_policies.py on the port's watcher and validator
(the port's checkpoints, the port's validator over a pipeline double).  The
control plane is not ported yet, so the two quality-GC cases rank the
port's ledger rows with the reference's ``CheckpointSelector``, which
deletes through the reference's ``gc_checkpoints`` on the same directory
format.  Beyond the mirror: seeded pending lists and latency / cadence
feeds drive the port's and the reference's policies to the same
selections, and ``--policy budget`` runs on the port's CLI.
"""

import numpy as np
import pytest

from repro.core import watcher as jwatcher
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.watcher import BudgetPolicy, CheckpointWatcher, Policy


def _save(root, step):
    ckpt.save(root, step, {"x": np.zeros(1, np.float32)})


# ---------------------------------------------------------------------------
# Stride policy
# ---------------------------------------------------------------------------

def test_stride_select_single_modulus_condition():
    p = Policy(kind="stride", stride=10)
    assert p.select([10, 15, 20, 25, 30]) == [10, 20, 30]
    assert p.select([15]) == []
    assert Policy(kind="stride", stride=0).select([3, 4]) == [3, 4]


def test_stride_nonselected_steps_marked_seen_no_regrow(tmp_path):
    root = str(tmp_path / "ck")
    for s in (10, 15, 20, 25):
        _save(root, s)
    w = CheckpointWatcher(root, policy=Policy(kind="stride", stride=10))
    assert w.poll() == [10, 20]
    assert w._seen == {10, 15, 20, 25}
    assert w.poll() == []
    assert w.skipped == {15, 25}


def test_latest_first_skipped_tracked(tmp_path):
    root = str(tmp_path / "ck")
    for s in (1, 2, 3):
        _save(root, s)
    w = CheckpointWatcher(root, policy=Policy(kind="latest_first"))
    assert w.poll() == [3]
    assert w.skipped == {1, 2}


# ---------------------------------------------------------------------------
# Requeue (failed validation) × each policy
# ---------------------------------------------------------------------------

def test_requeue_under_stride_retries_on_stride_step(tmp_path):
    root = str(tmp_path / "ck")
    for s in (10, 15, 20):
        _save(root, s)
    w = CheckpointWatcher(root, policy=Policy(kind="stride", stride=10))
    assert w.poll() == [10, 20]
    w.requeue(20)
    assert w.poll() == [20]
    assert w.poll() == []


def test_requeue_under_latest_first_loses_to_newer(tmp_path):
    root = str(tmp_path / "ck")
    _save(root, 1)
    w = CheckpointWatcher(root, policy=Policy(kind="latest_first"))
    assert w.poll() == [1]
    w.requeue(1)
    assert w.poll() == [1]
    w.requeue(1)
    _save(root, 2)
    assert w.poll() == [2]
    assert 1 in w.skipped
    assert w.poll() == []


def test_requeue_under_budget_always_retries_newest(tmp_path):
    root = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        _save(root, s)
    w = CheckpointWatcher(root, policy=BudgetPolicy(target_depth=1))
    first = w.poll()
    assert first and first[-1] == 4
    w.requeue(4)
    assert 4 in w.poll()


def test_requeue_unskips_an_explicitly_requeued_step(tmp_path):
    root = str(tmp_path / "ck")
    for s in (10, 15):
        _save(root, s)
    w = CheckpointWatcher(root, policy=Policy(kind="stride", stride=10))
    w.poll()
    assert w.skipped == {15}
    w.requeue(15)
    assert w.skipped == set()
    assert w.poll() == []
    assert w.skipped == {15}


# ---------------------------------------------------------------------------
# BudgetPolicy adaptation
# ---------------------------------------------------------------------------

def test_budget_policy_widens_under_backlog_and_recovers():
    p = BudgetPolicy(target_depth=1, max_stride=8)
    sel = p.select(list(range(1, 9)))
    assert p.effective_stride == 2
    assert sel[-1] == 8
    p.select(list(range(9, 17)))
    assert p.effective_stride == 4
    p.select([17])
    p.select([18])
    assert p.effective_stride == 1


def test_budget_policy_latency_cadence_floor():
    p = BudgetPolicy(target_depth=4, smooth=0.0)
    p.observe_latency(10.0)
    p.observe_cadence(2.0)
    sel = p.select([1, 2, 3])
    assert p.effective_stride == 5
    assert sel[-1] == 3


def test_budget_policy_newest_always_selected_bounds_staleness():
    p = BudgetPolicy(max_stride=64)
    for lo in range(0, 640, 64):
        assert (lo + 63) in p.select(list(range(lo, lo + 64)))


def test_budget_policy_select_empty():
    assert BudgetPolicy().select([]) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policies_match_reference_on_seeded_feeds(seed):
    """Seeded pending lists, latencies and cadences through the port's and
    the reference's policies: the same selections, strides and EMAs."""
    rng = np.random.default_rng(seed)
    pairs = [(BudgetPolicy(target_depth=2, max_stride=16, smooth=0.3),
              jwatcher.BudgetPolicy(target_depth=2, max_stride=16,
                                    smooth=0.3))]
    pairs += [(Policy(kind=k, stride=3), jwatcher.Policy(kind=k, stride=3))
              for k in ("fifo", "latest_first", "stride")]
    step = 0
    for _ in range(40):
        n = int(rng.integers(0, 9))
        pending = list(range(step + 1, step + 1 + n))
        rng.shuffle(pending)
        step += n
        lat, cad = float(rng.exponential(3.0)), float(rng.exponential(1.0))
        for port, ref in pairs:
            port.observe_latency(lat)
            ref.observe_latency(lat)
            port.observe_cadence(cad)
            ref.observe_cadence(cad)
            assert port.select(list(pending)) == ref.select(list(pending))
    port, ref = pairs[0]
    assert port.effective_stride == ref.effective_stride
    assert port._latency.value == ref._latency.value
    assert port._cadence.value == ref._cadence.value


# ---------------------------------------------------------------------------
# protect_set() × quality-aware GC
# ---------------------------------------------------------------------------

def _toy_validator(root, policy=None, **kw):
    """The port's AsyncValidator over a pipeline double."""
    from repro_torch.core.pipeline import ValidationResult
    from repro_torch.core.validator import AsyncValidator

    class PipeDouble:
        def validate_params(self, params, step=0, engine=None):
            return ValidationResult(step=step, metrics={"m": step / 100.0},
                                    timings={"total_s": 0.001},
                                    subset_size=1)

    kw.setdefault("params_extractor", lambda s: s)
    return AsyncValidator(root, PipeDouble(), policy=policy,
                          template={"x": (1,)}, **kw)


def test_protect_set_excludes_policy_skipped_but_keeps_failed(tmp_path):
    root = str(tmp_path / "ck")
    for s in (10, 15, 20):
        _save(root, s)
    v = _toy_validator(root, policy=Policy(kind="stride", stride=10),
                       max_retries=0)
    v.validate_pending()
    assert v.ledger.validated_steps == [10, 20]
    assert v.protect_set() == set()
    _save(root, 30)
    assert v.protect_set() == {30}


def test_failed_step_stays_protected_through_quality_gc(tmp_path):
    from repro.control import CheckpointSelector, SelectionConfig
    root = str(tmp_path / "ck")
    for s in (1, 2, 3):
        _save(root, s)
    calls = {"n": 0}

    def flaky(state):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("transient")
        return state

    v = _toy_validator(root, params_extractor=flaky, max_retries=3)
    v.validate_pending()
    assert v.ledger.validated_steps == [1, 3]
    assert v.protect_set() == {2}
    sel = CheckpointSelector(SelectionConfig(metric="m", top_k=1))
    for row in v.ledger.rows():
        sel.observe(row["step"], row["metrics"])
    assert sel.gc(root, protect=v.protect_set()) == [1]
    assert ckpt.list_steps(root) == [2, 3]
    v.validate_pending()
    assert v.protect_set() == set()
    sel.observe(2, v.ledger.rows()[-1]["metrics"])
    assert sel.gc(root, protect=v.protect_set()) == [2]
    assert ckpt.list_steps(root) == [3]


def test_skipping_policy_storage_does_not_leak_under_quality_gc(tmp_path):
    from repro.control import CheckpointSelector, SelectionConfig
    root = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        _save(root, s)
    v = _toy_validator(root, policy=Policy(kind="latest_first"))
    v.validate_pending()
    assert v.ledger.validated_steps == [5]
    assert v.protect_set() == set()
    sel = CheckpointSelector(SelectionConfig(metric="m", top_k=1))
    for row in v.ledger.rows():
        sel.observe(row["step"], row["metrics"])
    sel.gc(root, protect=v.protect_set())
    assert ckpt.list_steps(root) == [5]


def test_budget_policy_feeds_on_validator_latency(tmp_path):
    """The validator feeds each verdict's ``total_s`` to the policy: under
    a latency far above the cadence the budget policy widens its stride
    and still takes the newest checkpoint."""
    root = str(tmp_path / "ck")
    pol = BudgetPolicy(target_depth=8, smooth=0.0)
    v = _toy_validator(root, policy=pol)
    _save(root, 1)
    v.validate_pending()
    assert pol._latency.value == pytest.approx(0.001)
    pol.observe_latency(40.0)
    pol.observe_cadence(1.0)
    for s in range(2, 8):
        _save(root, s)
    v.validate_pending()
    assert pol.effective_stride >= 6
    assert 7 in v.ledger.validated_steps
    assert set(v.watcher.skipped) == set(range(2, 8)) - \
        set(v.ledger.validated_steps)


def test_cli_policy_budget_validates_newest(tmp_path):
    """``--policy budget`` on the port's CLI: one-shot over three
    checkpoints the queue is deeper than the target, so the stride widens,
    and the newest checkpoint is validated."""
    import json

    from repro_torch.core import cli
    from repro_torch.data import corpus as synthetic_ds
    from tests.test_torch_obs import _toy_init
    ds = synthetic_ds.synthetic_retrieval_dataset(3, n_passages=30,
                                                  n_queries=6, vocab=97)
    (tmp_path / "corpus").mkdir()
    synthetic_ds.write_jsonl(str(tmp_path / "corpus" / "c.jsonl"), ds.corpus)
    synthetic_ds.write_jsonl(str(tmp_path / "q.jsonl"), ds.queries)
    with open(tmp_path / "qrels.txt", "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    for step in (1, 2, 3):
        ckpt.save(str(tmp_path / "ckpts"), step, {"params": _toy_init(step)})
    assert cli.main([
        "--query_file", str(tmp_path / "q.jsonl"),
        "--candidate_dir", str(tmp_path / "corpus"),
        "--ckpts_dir", str(tmp_path / "ckpts"),
        "--qrel_file", str(tmp_path / "qrels.txt"),
        "--q_max_len", "8", "--p_max_len", "12", "--batch_size", "8",
        "--encoder", "tests.test_torch_obs:cli_encoder", "--device", "cpu",
        "--policy", "budget", "--output_dir", str(tmp_path / "out")]) == 0
    with open(tmp_path / "out" / "asyncval_ledger.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    want = jwatcher.BudgetPolicy().select([1, 2, 3])
    assert steps == want and steps[-1] == 3 and len(steps) < 3


def test_validate_step_bypasses_policy_and_cap(tmp_path):
    """``validate_step`` scores a step the stride policy skips, past the
    ``max_num_valid`` cap, once; the step is then neither pending nor
    skipped."""
    root = str(tmp_path / "ck")
    for s in (10, 15):
        _save(root, s)
    v = _toy_validator(root, policy=Policy(kind="stride", stride=10),
                       max_num_valid=1)
    assert v.validate_pending() == 1 and v.watcher.skipped == {15}
    assert v.validate_step(15) == 1
    assert v.ledger.validated_steps == [10, 15]
    assert v.watcher.skipped == set() and v.protect_set() == set()
    assert v.validate_step(15) == 0                # ledger-idempotent
