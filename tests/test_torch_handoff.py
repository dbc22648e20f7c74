"""The port's lazy snapshot hand-off (``repro_torch.handoff``) on the CPU.

Mirrors tests/test_handoff.py (its two fleet cases wait for the fleet slice
of the port): bit-parity of snapshot-scored and durable verdicts across
retrieval / rerank × streaming / materialized × f32 / int8; exactly-once
validation when a step arrives by both routes; a trainer SIGKILLed
mid-spill leaving a snapshot no reader claims; quality GC deferred until
the step is durable while early stopping acts on provisional rows; ledger
rows without the hand-off byte-identical to the old schema.  Across
packages: a port snapshot's treedef is JAX's bytes, and a spool written by
either package is read by the other with bit-equal leaves, bf16 included.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.handoff import ParamSnapshot as JSnapshot
from repro.handoff import SnapshotSpool as JSpool
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control import ControlConfig, ControlPlane, flatten_rows
from repro_torch.core.samplers import RerankTopK
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import (AsyncValidator, ValidationLedger,
                                        ValidatorWorker)
from repro_torch.data import corpus as synthetic_ds
from repro_torch.handoff import ParamSnapshot, SnapshotChannel, SnapshotSpool
from repro_torch.models.biencoder import EncoderSpec

DIM = 16
VOCAB = 211


def _toy_encode(params, tokens, mask):
    emb = params["table"][tokens.long()]
    m = mask.to(emb.dtype)[..., None]
    v = (emb * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-6)


def _toy_init(seed):
    rng = np.random.default_rng(seed)
    return {"table": rng.standard_normal((VOCAB, DIM)).astype(np.float32)}


def toy_spec():
    return EncoderSpec(name="toy", dim=DIM, encode_query=_toy_encode,
                       encode_passage=_toy_encode, init=_toy_init,
                       param_shapes={"table": (VOCAB, DIM)},
                       device=torch.device("cpu"), q_max_len=10,
                       p_max_len=26)


@pytest.fixture(scope="module")
def ds():
    return synthetic_ds.synthetic_retrieval_dataset(7, n_passages=90,
                                                    n_queries=10,
                                                    vocab=VOCAB)


@pytest.fixture(scope="module")
def baseline_run(ds):
    return synthetic_ds.lexical_baseline_run(ds, k=20)


def toy_params(seed=0):
    return {k: torch.from_numpy(v) for k, v in _toy_init(seed).items()}


def make_suite(ds, baseline_run, *, mode="retrieval", engine="streaming",
               score_dtype="f32"):
    sampler = RerankTopK(depth=10) if mode == "rerank" else None
    return ValidationSuite(toy_spec(), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels,
                       sampler=sampler, baseline_run=baseline_run),
    ], ValidationConfig(metrics=("MRR@10",), mode=mode, k=10,
                        batch_size=16, engine=engine,
                        score_dtype=score_dtype))


# ---------------------------------------------------------------------------
# ParamSnapshot / SnapshotSpool primitives
# ---------------------------------------------------------------------------

def test_param_snapshot_roundtrip_mixed_dtypes():
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.full((5,), 1.5, dtype=torch.bfloat16),
            "n": [torch.zeros((), dtype=torch.int32), (None,)],
            "e": {}}
    snap = ParamSnapshot.from_tree(3, tree, extra={"tag": "x"})
    state = snap.state()
    assert set(state) == {"w", "b", "n", "e"} and state["e"] == {}
    assert isinstance(state["n"], list) and state["n"][1] == (None,)
    assert torch.equal(state["w"], tree["w"])
    assert state["b"].dtype == torch.bfloat16
    assert torch.equal(state["b"], tree["b"])
    assert state["n"][0].shape == () and state["n"][0].dtype == torch.int32
    assert snap.extra == {"tag": "x"}
    assert snap.nbytes == 12 * 4 + 5 * 2 + 4
    assert snap.dtypes == ["bfloat16", "int32", "float32"]   # leaf order
    on_cpu = snap.state(device="cpu")
    assert torch.equal(on_cpu["w"], tree["w"])


def test_param_snapshot_treedef_and_leaves_equal_reference():
    """A port snapshot of a tree and the reference's snapshot of the same
    tree in JAX: the same treedef bytes and bit-equal leaves, and each
    package's ``state()`` rebuilds the other's snapshot."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 6)).astype(np.float32)
    h = rng.normal(size=(3,)).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(a),
                        "h": jnp.asarray(h, jnp.bfloat16)},
             "opt_state": {"mu": [jnp.asarray(a)], "step": jnp.int32(4)}}
    ttree = {"params": {"w": torch.from_numpy(a),
                        "h": torch.from_numpy(h).bfloat16()},
             "opt_state": {"mu": [torch.from_numpy(a)],
                           "step": torch.tensor(4, dtype=torch.int32)}}
    jsnap = JSnapshot.from_tree(5, jtree)
    tsnap = ParamSnapshot.from_tree(5, ttree)
    assert tsnap.treedef_hex == jsnap.treedef_hex
    for t, j in zip(tsnap.leaves, jsnap.leaves):
        assert t.shape == j.shape and t.tobytes() == np.asarray(j).tobytes()
    # the reference's snapshot rebuilt by the port (bf16 named by dtype)
    cross = ParamSnapshot(step=5, leaves=[np.asarray(x).view(np.uint16)
                                          if x.dtype == ml_dtypes.bfloat16
                                          else np.asarray(x)
                                          for x in jsnap.leaves],
                          treedef_hex=jsnap.treedef_hex,
                          dtypes=[str(np.asarray(x).dtype)
                                  for x in jsnap.leaves])
    got = cross.state()
    assert torch.equal(got["params"]["h"], ttree["params"]["h"])
    assert torch.equal(got["opt_state"]["mu"][0], ttree["opt_state"]["mu"][0])


def test_cpu_snapshot_does_not_alias_live_tensors():
    """On the CPU the async saver hands the trainer's own tree to its hooks;
    the snapshot copies it, so a later in-place write to a live tensor
    leaves the snapshot as it was."""
    live = {"w": torch.ones(4)}
    snap = ParamSnapshot.from_tree(1, live)
    live["w"].add_(1.0)
    assert torch.equal(snap.state()["w"], torch.ones(4))


def test_spool_roundtrip_and_mmap(tmp_path):
    spool = SnapshotSpool(str(tmp_path / "sp"))
    tree = {"w": torch.ones((4, 4)), "h": torch.zeros((2,),
                                                      dtype=torch.bfloat16)}
    snap = ParamSnapshot.from_tree(10, tree)
    spool.publish(10, snap.leaves, snap.treedef_hex, extra=snap.extra,
                  dtypes=snap.dtypes)
    assert spool.has(10) and spool.steps() == [10]
    got = spool.get(10)
    assert isinstance(got.leaves[0], np.memmap)
    state = got.state()
    assert torch.equal(state["w"], tree["w"])
    assert state["h"].dtype == torch.bfloat16
    assert torch.equal(state["h"], tree["h"])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_spool_cross_package_roundtrip(tmp_path, writer):
    """A spool written by one package is read by the other: every leaf bit
    for bit, bf16 included, the tree's structure intact."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    ttree = {"params": {"a": torch.from_numpy(a),
                        "b": torch.from_numpy(b).bfloat16()},
             "opt_state": {}}
    jtree = {"params": {"a": jnp.asarray(a), "b": jnp.asarray(b,
                                                              jnp.bfloat16)},
             "opt_state": {}}
    root = str(tmp_path / "sp")
    if writer == "port":
        snap = ParamSnapshot.from_tree(3, ttree)
        SnapshotSpool(root).publish(3, snap.leaves, snap.treedef_hex,
                                    dtypes=snap.dtypes)
        got = JSpool(root).get(3).state()
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(jtree)
        assert np.asarray(got["params"]["b"]).dtype == ml_dtypes.bfloat16
        for key in ("a", "b"):
            want = jnp.asarray(jtree["params"][key])
            assert np.asarray(got["params"][key]).tobytes() == \
                np.asarray(want).tobytes()
    else:
        snap = JSnapshot.from_tree(3, jtree)
        JSpool(root).publish(3, snap.leaves, snap.treedef_hex)
        reader = SnapshotSpool(root)
        assert reader.pending() == [3]
        got = reader.claim(3).state()
        assert set(got) == {"params", "opt_state"} and got["opt_state"] == {}
        assert got["params"]["b"].dtype == torch.bfloat16
        for key in ("a", "b"):
            want = ttree["params"][key]
            assert torch.equal(got["params"][key].view(torch.int16)
                               if key == "b" else got["params"][key],
                               want.view(torch.int16) if key == "b"
                               else want)


def test_spool_torn_spill_is_invisible(tmp_path):
    """A snapshot dir without COMMIT (a crash mid-spill) is never claimed."""
    from repro_torch.core.jsonl import append_jsonl_atomic
    root = str(tmp_path / "sp")
    spool = SnapshotSpool(root)
    torn = os.path.join(root, "snap_0000000007")
    os.makedirs(os.path.join(torn, "arrays"))
    np.save(os.path.join(torn, "arrays", "00000.npy"), np.ones(3))
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        json.dump({"step": 7, "treedef": "", "leaves": []}, f)
    append_jsonl_atomic(spool.announce_path,
                        [{"kind": "snapshot", "step": 7}])
    assert not spool.has(7)
    assert spool.steps() == []
    assert spool.poll() == []
    assert spool.load(7) is None
    assert spool.get(7) is None
    assert spool.pending() == []


def test_spool_consumer_surface(tmp_path):
    spool = SnapshotSpool(str(tmp_path / "sp"))
    snap = ParamSnapshot.from_tree(4, {"w": torch.ones(2)})
    spool.publish(4, snap.leaves, snap.treedef_hex)
    reader = SnapshotSpool(spool.root)
    assert reader.pending() == [4]
    assert reader.pending() == [4]      # unclaimed: stays pending
    got = reader.claim(4)
    assert got is not None and got.step == 4
    assert reader.pending() == []
    spool.retire(4)
    assert reader.claim(4) is None


# ---------------------------------------------------------------------------
# SnapshotChannel semantics
# ---------------------------------------------------------------------------

def _snap(step, val=1.0):
    return ParamSnapshot.from_tree(step, {"w": torch.full((2,), val)})


def test_channel_backpressure_drops_oldest_unclaimed():
    ch = SnapshotChannel(capacity=2)
    for s in (1, 2, 3):
        ch.publish(_snap(s))
    assert ch.dropped == [1]
    assert ch.pending() == [2, 3]
    assert ch.get(1) is None
    assert ch.nbytes() == 2 * 8


def test_channel_eviction_spares_claimed_then_falls_back():
    ch = SnapshotChannel(capacity=2)
    ch.publish(_snap(1))
    ch.publish(_snap(2))
    held = ch.claim(1)
    assert held is not None
    ch.publish(_snap(3))                # evicts 2 (oldest UNCLAIMED)
    assert ch.dropped == [2]
    assert ch.get(1) is not None
    tight = SnapshotChannel(capacity=1)
    tight.publish(_snap(1))
    held = tight.claim(1)
    tight.publish(_snap(2))
    assert tight.dropped == [1]
    assert tight.get(1) is None
    assert held.step == 1


def test_channel_durability_and_retirement(tmp_path):
    spool = SnapshotSpool(str(tmp_path / "sp"))
    ch = SnapshotChannel(capacity=4, spool=spool)
    ch.publish(_snap(5))
    assert ch.durability(5) == "pending"
    assert ch.durability(999) == "durable"
    assert spool.has(5)
    ch.claim(5)
    ch.mark_validated(5)
    assert spool.has(5)                 # validated but not durable: kept
    assert ch.nbytes() == 8
    ch.mark_durable(5)
    assert ch.durability(5) == "durable" and ch.is_durable(5)
    assert not spool.has(5)             # validated + durable: retired
    assert ch.nbytes() == 0             # the ring let go of its host copy
    ch.publish(_snap(6))
    ch.mark_failed(6, error=RuntimeError("disk full"))
    assert ch.durability(6) == "failed"
    assert ch.get(6) is None and not spool.has(6)


def test_channel_subscriber_wakes_on_publish():
    ch = SnapshotChannel()
    woke = []
    ch.subscribe(woke.append)
    ch.publish(_snap(9))
    assert woke == [9]


# ---------------------------------------------------------------------------
# The async saver never blocks the training thread
# ---------------------------------------------------------------------------

class _SlowLeaf:
    """A leaf whose host materialization is slow (the transfer wait)."""

    def __init__(self, value, record, delay=0.25):
        self._value = np.asarray(value)
        self._record = record
        self._delay = delay

    def __array__(self, dtype=None, copy=None):
        self._record.append(("materialize", threading.get_ident()))
        time.sleep(self._delay)
        return self._value if dtype is None else self._value.astype(dtype)


def test_async_saver_training_thread_never_waits_on_transfer(tmp_path):
    record = []
    tree = {"a": _SlowLeaf(np.ones(3), record),
            "b": _SlowLeaf(np.zeros(2), record)}
    saver = ckpt.AsyncSaver()
    copied = []
    t0 = time.monotonic()
    saver.save(str(tmp_path / "ck"), 1, tree,
               on_host_copy=lambda step, host: copied.append(step))
    issue_time = time.monotonic() - t0
    assert issue_time < 0.2, f"save() blocked the caller for {issue_time}s"
    caller = threading.get_ident()
    saver.wait()
    mats = [r for r in record if r[0] == "materialize"]
    assert len(mats) == 2 and all(tid != caller for _, tid in mats)
    assert copied == [1]
    assert ckpt.list_steps(str(tmp_path / "ck")) == [1]


def test_async_saver_host_copy_failure_spares_durable_save(tmp_path):
    saver = ckpt.AsyncSaver()

    def boom(step, host):
        raise RuntimeError("publish failed")

    saver.save(str(tmp_path / "ck"), 2, {"w": torch.ones(2)},
               on_host_copy=boom)
    with pytest.raises(RuntimeError, match="publish failed"):
        saver.wait()
    assert ckpt.list_steps(str(tmp_path / "ck")) == [2]


def test_async_saver_failure_hook_fires_on_save_error(tmp_path):
    saver = ckpt.AsyncSaver()
    failed = []
    path = tmp_path / "blocked"
    path.write_text("not a directory")
    saver.save(str(path), 3, {"w": torch.ones(2)},
               on_failure=lambda step, e: failed.append(step),
               on_durable=lambda step: failed.append(("durable", step)))
    with pytest.raises(Exception):
        saver.wait()
    assert failed == [3]


# ---------------------------------------------------------------------------
# Snapshot-vs-durable bit parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["retrieval", "rerank"])
@pytest.mark.parametrize("engine", ["streaming", "materialized"])
@pytest.mark.parametrize("score_dtype", ["f32", "int8"])
def test_snapshot_parity_matrix(tmp_path, ds, baseline_run, mode, engine,
                                score_dtype):
    """Scoring from a pre-durable snapshot is bit for bit the durable-restore
    validation across modes, engines and scoring precisions."""
    root = str(tmp_path / "ck")
    state = {"params": toy_params()}
    ckpt.save(root, 1, state)

    def result_rows(snapshots):
        suite = make_suite(ds, baseline_run, mode=mode, engine=engine,
                           score_dtype=score_dtype)
        ledger = ValidationLedger(None, expected_tasks=suite.task_names)
        worker = ValidatorWorker(root, suite, ledger=ledger,
                                 snapshots=snapshots)
        res = worker.run_step(1)
        return res, ledger.rows(), worker.last_handoff

    ch = SnapshotChannel()
    ch.publish(ParamSnapshot.from_tree(1, state))
    res_snap, rows_snap, hand_snap = result_rows(ch)
    res_dur, rows_dur, hand_dur = result_rows(None)

    assert hand_snap == "snapshot" and hand_dur == ""
    assert res_snap.metrics == res_dur.metrics
    for name in res_dur.tasks:
        assert res_snap.tasks[name].metrics == res_dur.tasks[name].metrics
    for row in rows_snap:
        assert row["handoff"] == "snapshot"
    for row in rows_dur:
        assert "handoff" not in row

    def strip(r):
        return {k: v for k, v in r.items() if k not in ("handoff", "timings")}

    assert [strip(r) for r in rows_snap] == [strip(r) for r in rows_dur]


def test_snapshot_parity_through_spool(tmp_path, ds, baseline_run):
    """The cross-process route: mmap'd spool leaves score bit-identically."""
    root = str(tmp_path / "ck")
    state = {"params": toy_params()}
    ckpt.save(root, 2, state)
    spool = SnapshotSpool(str(tmp_path / "sp"))
    snap = ParamSnapshot.from_tree(2, state)
    spool.publish(2, snap.leaves, snap.treedef_hex, dtypes=snap.dtypes)

    def run(snapshots):
        suite = make_suite(ds, baseline_run)
        worker = ValidatorWorker(
            root, suite,
            ledger=ValidationLedger(None, expected_tasks=suite.task_names),
            snapshots=snapshots)
        return worker.run_step(2)

    res_spool = run(SnapshotSpool(spool.root))
    res_dur = run(None)
    assert res_spool.metrics == res_dur.metrics
    assert res_spool.handoff == "snapshot" and res_dur.handoff == "durable"


# ---------------------------------------------------------------------------
# Exactly once when both routes surface a step
# ---------------------------------------------------------------------------

def test_no_double_validation_snapshot_then_watcher(tmp_path, ds,
                                                    baseline_run):
    root = str(tmp_path / "ck")
    state = {"params": toy_params()}
    ch = SnapshotChannel()
    v = AsyncValidator(root, make_suite(ds, baseline_run), snapshots=ch,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    ch.publish(ParamSnapshot.from_tree(1, state))
    assert v.validate_pending() == 1
    ckpt.save(root, 1, state)
    assert v.validate_pending() == 0
    keys = [(r["step"], r["task"]) for r in v.ledger.rows()]
    assert keys == [(1, "default")]
    assert v.ledger.rows()[0]["handoff"] == "snapshot"


def test_no_double_validation_watcher_then_snapshot(tmp_path, ds,
                                                    baseline_run):
    root = str(tmp_path / "ck")
    state = {"params": toy_params()}
    ch = SnapshotChannel()
    v = AsyncValidator(root, make_suite(ds, baseline_run), snapshots=ch,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    ckpt.save(root, 1, state)
    assert v.validate_pending() == 1
    ch.publish(ParamSnapshot.from_tree(1, state))
    assert v.validate_pending() == 0
    assert [(r["step"], r["task"]) for r in v.ledger.rows()] \
        == [(1, "default")]
    assert "handoff" not in v.ledger.rows()[0]
    assert ch.pending() == []


def test_snapshot_failure_falls_back_to_watcher(tmp_path, ds, baseline_run):
    """A poisoned snapshot is discarded; the durable path still scores."""
    root = str(tmp_path / "ck")
    state = {"params": toy_params()}
    ch = SnapshotChannel()
    v = AsyncValidator(root, make_suite(ds, baseline_run), snapshots=ch,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    ch.publish(ParamSnapshot.from_tree(1, {"not_params": torch.ones(2)}))
    assert v.validate_pending() == 0
    assert len(v.errors) == 1
    assert ch.get(1) is None
    ckpt.save(root, 1, state)
    assert v.validate_pending() == 1
    assert "handoff" not in v.ledger.rows()[0]


# ---------------------------------------------------------------------------
# SIGKILL the trainer mid-spill
# ---------------------------------------------------------------------------

_CRASHER = r"""
import os, sys, signal
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.handoff.spool import SnapshotSpool, _snap_dir
from repro_torch.core.jsonl import append_jsonl_atomic

root = {root!r}
spool = SnapshotSpool(root)
# one COMPLETE snapshot (step 1) ...
spool.publish(1, [np.ones(4, np.float32)], {treedef!r})
# ... then die mid-spill of step 2: arrays written, no COMMIT, announce
# already appended (the worst interleaving for a reader)
torn = _snap_dir(root, 2) + ".tmp"
os.makedirs(os.path.join(torn, "arrays"))
np.save(os.path.join(torn, "arrays", "00000.npy"), np.ones(4, np.float32))
os.rename(torn, _snap_dir(root, 2))
append_jsonl_atomic(os.path.join(root, "announce.jsonl"),
                    [{{"kind": "snapshot", "step": 2}}])
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_sigkilled_trainer_torn_spill_never_claimed(tmp_path, ds,
                                                    baseline_run):
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    spool_root = str(tmp_path / "sp")
    treedef = ckpt.treedef_proto({"params": {"table": 0}}).hex()
    code = _CRASHER.format(src=os.path.abspath(src), root=spool_root,
                           treedef=treedef)
    proc = subprocess.run([sys.executable, "-c", code])
    assert proc.returncode == -signal.SIGKILL
    reader = SnapshotSpool(spool_root)
    assert reader.steps() == [1]
    assert reader.pending() == [1]
    assert reader.get(2) is None
    assert reader.claim(1).step == 1    # drain the pre-crash snapshot
    root = str(tmp_path / "ck")
    state = {"params": toy_params()}
    ckpt.save(root, 2, state)
    v = AsyncValidator(root, make_suite(ds, baseline_run), snapshots=reader,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    assert v.validate_pending() == 1
    rows = v.ledger.rows()
    assert [(r["step"], r["task"]) for r in rows] == [(2, "default")]
    assert "handoff" not in rows[0]     # scored from the durable restore


# ---------------------------------------------------------------------------
# Durability gate: GC deferred, early stop provisional
# ---------------------------------------------------------------------------

def test_gc_waits_for_durable_commit(tmp_path, ds, baseline_run):
    root = str(tmp_path / "ck")
    ch = SnapshotChannel(capacity=8)
    control = ControlPlane(root, ControlConfig(metric="MRR@10",
                                               keep_top_k=1),
                           durability=ch.durability)
    v = AsyncValidator(root, make_suite(ds, baseline_run), snapshots=ch,
                       controller=control,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    state = {"params": toy_params()}
    for step in (1, 2):
        ckpt.save(root, step, state)
        ch.publish(ParamSnapshot.from_tree(step, state))
        ch.mark_durable(step)
    v.validate_pending()
    n_after_durable = len(ckpt.list_steps(root))
    ch.publish(ParamSnapshot.from_tree(3, {"params": toy_params(1)}))
    v.validate_pending()
    assert 3 in [r["step"] for r in v.ledger.rows()]
    assert len(ckpt.list_steps(root)) == n_after_durable    # held
    assert not control.maybe_gc(v)
    assert control.selector.best_step is not None
    ckpt.save(root, 3, {"params": toy_params(1)})
    ch.mark_durable(3)
    assert control.maybe_gc(v)
    assert not v.errors


def test_gc_hold_releases_on_failed_save(tmp_path, ds, baseline_run):
    root = str(tmp_path / "ck")
    ch = SnapshotChannel(capacity=8)
    control = ControlPlane(root, ControlConfig(metric="MRR@10",
                                               keep_top_k=1),
                           durability=ch.durability)
    v = AsyncValidator(root, make_suite(ds, baseline_run), snapshots=ch,
                       controller=control,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    ch.publish(ParamSnapshot.from_tree(1, {"params": toy_params()}))
    v.validate_pending()
    assert not control.maybe_gc(v)      # pending: held
    ch.mark_failed(1, error=RuntimeError("disk died"))
    assert control.maybe_gc(v)          # failed releases the hold


def test_early_stop_acts_on_provisional_rows(tmp_path, ds, baseline_run):
    root = str(tmp_path / "ck")
    stop_path = str(tmp_path / "STOP")
    ch = SnapshotChannel(capacity=16)
    control = ControlPlane(root, ControlConfig(metric="MRR@10",
                                               early_stop=True,
                                               patience=2),
                           stop_path=stop_path, durability=ch.durability)
    v = AsyncValidator(root, make_suite(ds, baseline_run), snapshots=ch,
                       controller=control,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    state = {"params": toy_params()}
    for step in (1, 2, 3, 4):
        ch.publish(ParamSnapshot.from_tree(step, state))   # never durable
        v.validate_pending()
        if control.stopped:
            break
    assert control.stopped
    assert os.path.exists(stop_path)
    assert all(ch.durability(r["step"]) == "pending"
               for r in v.ledger.rows())


# ---------------------------------------------------------------------------
# Ledger byte-identity + provenance
# ---------------------------------------------------------------------------

def test_durable_rows_stay_byte_identical(tmp_path, ds, baseline_run):
    root = str(tmp_path / "ck")
    ckpt.save(root, 1, {"params": toy_params()})
    path = str(tmp_path / "ledger.jsonl")
    v = AsyncValidator(root, make_suite(ds, baseline_run), ledger_path=path)
    v.validate_pending()
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            assert "handoff" not in rec
            assert set(rec) == {"step", "task", "metrics", "timings",
                                "subset_size", "engine", "score_dtype"}


def test_flatten_rows_exposes_handoff_context():
    rows = [
        {"step": 1, "task": "default", "metrics": {"MRR@10": 0.5},
         "engine": "streaming", "score_dtype": "f32"},
        {"step": 2, "task": "default", "metrics": {"MRR@10": 0.6},
         "engine": "streaming", "score_dtype": "f32",
         "handoff": "snapshot"},
    ]
    out = flatten_rows(rows, ("default",), with_context=True)
    ctx = dict((step, c) for step, _, c in out)
    assert "handoff" not in ctx[1]
    assert ctx[2]["handoff"] == "snapshot"


# ---------------------------------------------------------------------------
# End to end: the trainer publishes, the validator scores pre-durable
# ---------------------------------------------------------------------------

def test_trainer_handoff_end_to_end(tmp_path):
    """``Trainer._save`` publishes the params' host copy the moment it
    lands; the hooks mark each step durable, and the snapshots rebuild the
    committed params exactly."""
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    ch = SnapshotChannel(capacity=8)
    root = str(tmp_path / "ck")
    tcfg = TrainerConfig(total_steps=4, ckpt_every=2, ckpt_dir=root,
                         log_every=2, async_save=True, snapshots=ch)
    target = torch.tensor([3.0, -2.0])

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        loss = torch.mean(torch.square(pred - batch["y"]))
        return loss, {"mse": loss}

    def batch_for(step, n=8):
        rng = np.random.default_rng(step)
        x = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
        return {"x": x, "y": x @ target}

    trainer = Trainer(tcfg, loss_fn, optim.adamw(5e-2),
                      {"w": torch.zeros(2)}, batch_for)
    trainer.run()
    assert ch.durability(2) == "durable"
    assert ch.durability(4) == "durable"
    assert ch.pending() == [2, 4]
    for step in (2, 4):
        snap = ch.get(step)
        assert set(snap.state()) == {"params"}  # only the params travel
        state, _ = ckpt.restore(root, step, template={"params": {"w": (2,)}})
        assert torch.equal(snap.state()["params"]["w"], state["params"]["w"])
    assert not torch.equal(ch.get(2).state()["params"]["w"],
                           trainer.params["w"])
