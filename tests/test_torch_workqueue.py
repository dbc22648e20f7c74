"""The port's ledger work queue (``repro_torch.core.workqueue``) against the
reference's.

Mirrors the queue half of tests/test_fleet.py: ``WorkUnit``, ``meets``,
``parse_capabilities``, idempotent publish, one winner per claim race,
lease expiry by ledger sequence, renew, the abandon budget, the capability
filter, ``replay`` equal to the online decisions, and appends from several
processes that never tear.  Across the packages: one scripted record
sequence appended through the reference's ``WorkQueue`` and through the
port's gives byte-identical ledger files, and each package's ``replay`` of
the other's file gives the same unit states and decision trace.
"""

import dataclasses
import os
import subprocess
import sys

import pytest

import repro.core.jsonl as jjsonl
import repro.core.workqueue as jwq
import repro_torch.core.workqueue as twq
from repro_torch.core.jsonl import append_jsonl_atomic, read_jsonl_tolerant
from repro_torch.core.validator import ValidationLedger
from repro_torch.core.workqueue import (WorkQueue, WorkUnit, meets,
                                        parse_capabilities, replay)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


# ---------------------------------------------------------------------------
# WorkUnit / capabilities
# ---------------------------------------------------------------------------

def test_workunit_make_and_requires():
    u = WorkUnit.make(7, "deep", {"mesh_size": 2, "max_depth": 100})
    assert u.key == (7, "deep")
    assert u.requires_dict == {"max_depth": 100, "mesh_size": 2}
    assert {u: 1}[WorkUnit.make(7, "deep",
                                {"max_depth": 100, "mesh_size": 2})] == 1
    ref = jwq.WorkUnit.make(7, "deep", {"mesh_size": 2, "max_depth": 100})
    assert dataclasses.astuple(u) == dataclasses.astuple(ref)


@pytest.mark.parametrize("caps,requires", [
    ({"mesh_size": 8}, {"mesh_size": 2}),
    ({"mesh_size": 1}, {"mesh_size": 2}),
    ({"kind": "tpu"}, {"kind": "tpu"}),
    ({"kind": "cpu"}, {"kind": "tpu"}),
    ({}, {"mesh_size": 1}),
    ({}, {}),
    ({"f": 0.5}, {"f": 0.25}),
])
def test_meets_matches_reference(caps, requires):
    assert meets(caps, requires) == jwq.meets(caps, requires)


def test_meets_numeric_minima_and_equality():
    assert meets({"mesh_size": 8}, {"mesh_size": 2})
    assert not meets({"mesh_size": 1}, {"mesh_size": 2})
    assert meets({"kind": "gpu"}, {"kind": "gpu"})
    assert not meets({"kind": "cpu"}, {"kind": "gpu"})
    assert not meets({}, {"mesh_size": 1})
    assert meets({}, {})


@pytest.mark.parametrize("spec", ["mesh_size=8,max_depth=100",
                                  "f=0.5, name=gpu", "", "a=1,,b=x"])
def test_parse_capabilities_matches_reference(spec):
    assert parse_capabilities(spec) == jwq.parse_capabilities(spec)


def test_parse_capabilities():
    assert parse_capabilities("mesh_size=8,max_depth=100") == {
        "mesh_size": 8, "max_depth": 100}
    assert parse_capabilities("f=0.5, name=gpu") == {"f": 0.5, "name": "gpu"}
    assert parse_capabilities("") == {}
    with pytest.raises(ValueError):
        parse_capabilities("oops")


# ---------------------------------------------------------------------------
# Claim protocol over the shared ledger file
# ---------------------------------------------------------------------------

def _queue(path, wid, **kw):
    kw.setdefault("lease_ttl", 4)
    return WorkQueue(str(path), wid, **kw)


def test_publish_is_idempotent(tmp_path):
    q = _queue(tmp_path / "led.jsonl", "w0")
    units = [WorkUnit.make(1, "a"), WorkUnit.make(1, "b")]
    assert q.publish(units) == units
    assert q.publish(units) == []
    assert sorted(q.state.units) == [(1, "a"), (1, "b")]


def test_claim_conflict_has_single_winner(tmp_path):
    path = tmp_path / "led.jsonl"
    a, b = _queue(path, "A"), _queue(path, "B")
    a.publish([WorkUnit.make(1)])
    unit = a.state.units[(1, "default")].unit
    assert a.try_claim(unit)
    assert not b.try_claim(unit)
    assert a.refresh().holder(1) == "A"
    assert b.refresh().holder(1) == "A"
    assert any(e["event"] == "claim_lost" for e in b.state.events)


def test_lease_expires_by_sequence_and_is_reclaimed(tmp_path):
    path = tmp_path / "led.jsonl"
    a, b = _queue(path, "A"), _queue(path, "B")
    a.publish([WorkUnit.make(5)])
    unit = a.state.units[(5, "default")].unit
    assert a.try_claim(unit)
    # A dies; B's ticks advance the sequence clock past the ttl of 4
    for _ in range(5):
        assert b.refresh().claimable({}) == []
        b.tick()
    assert b.refresh().claimable({}) == [unit]
    assert b.try_claim(unit)
    assert b.state.holder(5) == "B"
    reclaims = [e for e in b.state.events if e["event"] == "reclaim"]
    assert reclaims and reclaims[0]["from"] == "A"


def test_renew_keeps_lease_alive(tmp_path):
    path = tmp_path / "led.jsonl"
    a, b = _queue(path, "A"), _queue(path, "B")
    a.publish([WorkUnit.make(5)])
    unit = a.state.units[(5, "default")].unit
    assert a.try_claim(unit)
    for _ in range(10):
        b.tick()
        a.renew(unit)
    assert b.refresh().claimable({}) == []
    assert b.state.holder(5) == "A"


def test_abandon_reopens_then_fails_past_budget(tmp_path):
    q = _queue(tmp_path / "led.jsonl", "A", max_abandons=1)
    q.publish([WorkUnit.make(2)])
    unit = q.state.units[(2, "default")].unit
    assert q.try_claim(unit)
    q.abandon(unit, error="boom")
    assert q.state.units[(2, "default")].status == "open"
    assert q.try_claim(unit)
    q.abandon(unit, error="boom again")
    assert q.state.units[(2, "default")].status == "failed"
    assert q.refresh().claimable({}) == []


def test_result_row_completes_unit_and_capability_filter(tmp_path):
    path = tmp_path / "led.jsonl"
    q = _queue(path, "A", capabilities={"mesh_size": 1})
    q.publish([WorkUnit.make(1, "small"),
               WorkUnit.make(1, "big", {"mesh_size": 8})])
    assert [u.task for u in q.claimable()] == ["small"]
    # a bare result row (a solo validator sharing the ledger) completes it
    append_jsonl_atomic(str(path), [{"step": 1, "task": "small",
                                     "metrics": {"MRR@10": 0.5}}])
    assert q.refresh().units[(1, "small")].status == "done"
    assert q.claimable() == []


def test_replay_rederives_online_decisions(tmp_path):
    path = tmp_path / "led.jsonl"
    a, b = _queue(path, "A"), _queue(path, "B")
    a.publish([WorkUnit.make(1), WorkUnit.make(2)])
    u1 = a.state.units[(1, "default")].unit
    u2 = a.state.units[(2, "default")].unit
    assert a.try_claim(u1) and b.try_claim(u2)
    b.complete(u2)
    for _ in range(6):
        b.tick()
    assert b.try_claim(u1)
    b.complete(u1)
    offline = replay(str(path), lease_ttl=4)
    assert offline.events == b.refresh().events
    assert offline.completed_units() == [(1, "default"), (2, "default")]


def test_refresh_skips_a_torn_tail_until_it_is_whole(tmp_path):
    """A fragment at the end (an append in flight) is not consumed; the
    next refresh reads it whole."""
    path = str(tmp_path / "led.jsonl")
    q = _queue(path, "A")
    q.publish([WorkUnit.make(1)])
    with open(path, "a") as f:
        f.write('{"kind": "unit", "step": 2, "task": "default", "req')
    assert sorted(q.refresh().units) == [(1, "default")]
    with open(path, "a") as f:
        f.write('uires": {}}\n')
    assert sorted(q.refresh().units) == [(1, "default"), (2, "default")]


# ---------------------------------------------------------------------------
# Across the packages: byte-identical records, cross replay
# ---------------------------------------------------------------------------

def _script(mod, append, path):
    """One scripted fleet session through module ``mod``'s WorkQueue (and
    ``append``, its package's atomic appender, for a result row):
    publish (with requirements and a snapshot source), a race, a renew, an
    abandon, a crash and a reclaim by sequence, completions and a result
    row."""
    a = mod.WorkQueue(path, "A", lease_ttl=3, max_abandons=1,
                      capabilities={"mesh_size": 2})
    b = mod.WorkQueue(path, "B", lease_ttl=3, max_abandons=1,
                      capabilities={"mesh_size": 1})
    a.publish([mod.WorkUnit.make(1, "default"),
               mod.WorkUnit.make(1, "deep", {"mesh_size": 2})])
    a.publish([mod.WorkUnit.make(2, "default")], source="snapshot")
    a.publish([mod.WorkUnit.make(1, "default")])          # no-op
    u1, d1, u2 = (mod.WorkUnit.make(1, "default"),
                  mod.WorkUnit.make(1, "deep", {"mesh_size": 2}),
                  mod.WorkUnit.make(2, "default"))
    assert a.try_claim(d1)
    assert not b.try_claim(d1)                           # live lease
    a.renew(d1)
    assert b.try_claim(u1)
    b.abandon(u1, error="RuntimeError('wedged')")
    assert b.try_claim(u1)
    append_row = {"step": 1, "task": "default", "metrics": {"MRR@10": 0.25},
                  "timings": {"total_s": 0.5}, "subset_size": 3,
                  "engine": "streaming", "score_dtype": "f32",
                  "worker_id": "B"}
    append(path, [append_row])
    b.complete(u1)
    assert b.try_claim(u2)
    # B dies holding step 2; A ticks its lease out and reclaims it
    for _ in range(4):
        a.tick()
    assert a.try_claim(u2)
    a.complete(u2)
    a.complete(d1)
    return a.refresh()


def _state_view(state):
    return {key: (st.status, st.holder, st.touch_seq, st.claim_seq,
                  st.abandons, st.completed_by, st.source,
                  st.unit.requires)
            for key, st in state.units.items()}


def test_claim_records_are_byte_identical_to_the_reference(tmp_path):
    ref_path = str(tmp_path / "ref.jsonl")
    port_path = str(tmp_path / "port.jsonl")
    ref_state = _script(jwq, jjsonl.append_jsonl_atomic, ref_path)
    port_state = _script(twq, append_jsonl_atomic, port_path)
    with open(ref_path, "rb") as f:
        ref_bytes = f.read()
    with open(port_path, "rb") as f:
        port_bytes = f.read()
    assert port_bytes == ref_bytes
    assert _state_view(port_state) == _state_view(ref_state)
    assert port_state.events == ref_state.events
    kinds = {r.get("kind") for r in read_jsonl_tolerant(port_path)[0]}
    assert kinds == {"unit", "claim", "renew", "abandon", "complete",
                     "tick", None}


def test_each_package_replays_the_others_ledger(tmp_path):
    ref_path = str(tmp_path / "ref.jsonl")
    port_path = str(tmp_path / "port.jsonl")
    _script(jwq, jjsonl.append_jsonl_atomic, ref_path)
    _script(twq, append_jsonl_atomic, port_path)
    for path in (ref_path, port_path):
        by_ref = jwq.replay(path, lease_ttl=3, max_abandons=1)
        by_port = replay(path, lease_ttl=3, max_abandons=1)
        assert _state_view(by_port) == _state_view(by_ref)
        assert by_port.events == by_ref.events
        assert by_port.completed_units() == by_ref.completed_units() == [
            (1, "deep"), (1, "default"), (2, "default")]
        assert [r["step"] for r in by_port.result_rows] == [1]
    # the port's result-row loader reads the fleet ledger: kind records
    # skipped, the worker stamp kept
    rows = ValidationLedger(ref_path).rows()
    assert [(r["step"], r["task"], r["worker_id"]) for r in rows] == [
        (1, "default", "B")]


# ---------------------------------------------------------------------------
# Atomic multi-process appends
# ---------------------------------------------------------------------------

_APPENDER = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core.jsonl import append_jsonl_atomic
path, wid = sys.argv[1], sys.argv[2]
for i in range(150):
    append_jsonl_atomic(path, [{{"kind": "tick", "worker": wid, "i": i}}])
"""


def test_multiprocess_appends_never_tear(tmp_path):
    path = str(tmp_path / "led.jsonl")
    script = str(tmp_path / "appender.py")
    with open(script, "w") as f:
        f.write(_APPENDER.format(src=SRC))
    procs = [subprocess.Popen([sys.executable, script, path, wid])
             for wid in ("A", "B")]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    rows, torn = read_jsonl_tolerant(path)
    assert torn is None
    assert len(rows) == 300
    for wid in ("A", "B"):
        assert [r["i"] for r in rows if r["worker"] == wid] == \
            list(range(150))


def test_ledger_and_claims_interleave_multiprocess(tmp_path):
    """Claim records and result rows of two processes (one per package)
    land in one ledger that both packages load and replay alike."""
    path = str(tmp_path / "led.jsonl")
    script = str(tmp_path / "mixed.py")
    with open(script, "w") as f:
        f.write("""
import sys
sys.path.insert(0, {src!r})
pkg, path, wid, base = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
if pkg == "port":
    from repro_torch.core.workqueue import WorkQueue, WorkUnit
    from repro_torch.core.jsonl import append_jsonl_atomic
else:
    from repro.core.workqueue import WorkQueue, WorkUnit
    from repro.core.jsonl import append_jsonl_atomic
q = WorkQueue(path, wid)
for i in range(25):
    step = base + i
    u = WorkUnit.make(step)
    q.publish([u])
    if q.try_claim(u):
        append_jsonl_atomic(path, [{{"step": step, "task": "default",
                                     "metrics": {{"MRR@10": 0.1}},
                                     "timings": {{}}, "subset_size": 1,
                                     "worker_id": wid}}])
        q.complete(u)
""".format(src=SRC))
    procs = [subprocess.Popen([sys.executable, script, pkg, path, wid, base])
             for pkg, wid, base in (("port", "A", "0"),
                                    ("ref", "B", "1000"))]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert len(ValidationLedger(path).validated_steps) == 50
    assert len(replay(path).completed_units()) == 50
    assert replay(path).events == jwq.replay(path).events
