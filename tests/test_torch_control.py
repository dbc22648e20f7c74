"""The port's control plane (``repro_torch.control``) against the reference's.

Mirrors tests/test_control.py: the event log, checkpoint selection and its
EMA, quality-aware GC with the validator's protection, early stopping
(plateau, overfit, the STOP marker), checkpoint soups, the plane and its
offline replay, and the ledger / CSV hardening the control consumers rely
on.  Each case feeds the same inputs (seeded numpy values, the same
observation sequence) to ``repro.control`` and ``repro_torch.control`` and
holds the port's outputs equal to the reference's: event JSON byte for byte,
the same GC deletions, STOP markers with the same verdict, and soups bit
for bit at f32 and bf16.  The one divergence by design: the port's soups
take the key-path template of ``ckpt.restore``.
"""

import csv
import json
import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.control as jc
from repro.ckpt import checkpoint as jckpt
from repro.control.earlystop import _slope as jslope
from repro.core.pipeline import ValidationResult as JResult
from repro.core.reporting import CSVLogger as JCSVLogger
from repro.core.validator import ValidationLedger as JLedger
import repro_torch.control as tc
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.earlystop import _slope
from repro_torch.core.pipeline import ValidationResult
from repro_torch.core.reporting import CSVLogger
from repro_torch.core.validator import ValidationLedger
from repro_torch.core.watcher import CheckpointWatcher, Policy

SIDES = (("ref", jc), ("port", tc))


def _res(step, value, metric="m"):
    return ValidationResult(step=step, metrics={metric: value},
                            timings={"total_s": 0.01}, subset_size=1)


def _jres(step, value, metric="m"):
    return JResult(step=step, metrics={metric: value},
                   timings={"total_s": 0.01}, subset_size=1)


def _json(events):
    return [e.to_json() for e in events]


def _both_decisions(build, feed):
    """Run ``feed(obj)`` on the object ``build(pkg)`` of each package and
    return both event logs as JSON lines."""
    out = {}
    for name, pkg in SIDES:
        obj = build(pkg)
        feed(obj)
        out[name] = _json(obj.events)
    return out


# ---------------------------------------------------------------------------
# Event log
# ---------------------------------------------------------------------------

def _emit_three(log):
    log.emit("select", 10, value=0.5, top_steps=[10], best_step=10)
    log.emit("gc", 10, deleted=[1, 2], kept=[10])
    log.emit("stop", 20, reason="plateau", best_value=None)


def test_event_log_appends_persists_and_reloads(tmp_path):
    files = {}
    for name, pkg in SIDES:
        path = str(tmp_path / f"{name}.jsonl")
        log = pkg.ControlEventLog(path)
        _emit_three(log)
        log2 = pkg.ControlEventLog(path)     # restart: continues the seq
        assert len(log2) == 3
        log2.emit("select", 30, value=0.6)
        assert log2.events()[-1].seq == 3
        with open(path, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["ref"]
    # each package's log loads the other's file and appends alike
    for name, pkg in SIDES:
        other = "ref" if name == "port" else "port"
        log = pkg.ControlEventLog(str(tmp_path / f"{other}.jsonl"))
        assert [e.seq for e in log.events()] == [0, 1, 2, 3]


def test_event_log_decisions_renumbered_without_actuations():
    got = {}
    for name, pkg in SIDES:
        log = pkg.ControlEventLog()
        log.emit("select", 1, value=0.1)
        log.emit("gc", 1, deleted=[])
        log.emit("select", 2, value=0.2)
        log.emit("stop", 2, reason="plateau")
        dec = log.decisions()
        assert [e.kind for e in dec] == ["select", "select", "stop"]
        assert [e.seq for e in dec] == [0, 1, 2]
        got[name] = _json(dec)
    assert got["port"] == got["ref"]
    assert tc.DECISION_KINDS == jc.DECISION_KINDS
    assert tc.ACTUATION_KINDS == jc.ACTUATION_KINDS


def test_event_log_torn_tail_repaired_on_next_emit(tmp_path):
    """A torn final line is dropped on load and cut by the next emit."""
    files = {}
    for name, pkg in SIDES:
        path = str(tmp_path / f"{name}.jsonl")
        _emit_three(pkg.ControlEventLog(path))
        with open(path, "a") as f:
            f.write('{"seq": 3, "kind": "sel')        # emit died mid-write
        log = pkg.ControlEventLog(path)
        assert len(log) == 3
        log.emit("select", 40, value=0.7)
        with open(path, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["ref"]
    assert b"sel\n" not in files["port"] and files["port"].endswith(b"}\n")


@pytest.mark.parametrize("bad", [np.int64(3), np.float32(0.5),
                                 torch.tensor(1.0), [1, np.int32(2)]],
                         ids=["np_int64", "np_float32", "tensor", "list"])
def test_event_log_refuses_non_plain_payload(bad):
    log = tc.ControlEventLog()
    with pytest.raises(TypeError, match="plain Python"):
        log.emit("select", 1, value=bad)
    assert len(log) == 0


# ---------------------------------------------------------------------------
# MetricSpec, flatten_rows, metric_mode
# ---------------------------------------------------------------------------

SPECS = ["MRR@10", "dev:MRR@10", "0.5*dev:MRR@10 + 0.5*heldout:MRR@10",
         "AverageRank", "-1*AverageRank + 2*MRR@10", "dev:AverageRank"]


@pytest.mark.parametrize("spec", SPECS)
def test_metric_spec_parse_value_and_mode(spec):
    flat = {"MRR@10": 0.25, "dev:MRR@10": 0.25, "heldout:MRR@10": 0.75,
            "AverageRank": 3.5, "dev:AverageRank": 3.5}
    p, r = tc.MetricSpec.parse(spec), jc.MetricSpec.parse(spec)
    assert p.terms == r.terms and p.composite == r.composite
    assert p.keys() == r.keys()
    assert p.value(flat) == r.value(flat)
    assert tc.metric_mode(spec) == jc.metric_mode(spec)


@pytest.mark.parametrize("spec", ["", "a +", "x*MRR@10", "2*"])
def test_metric_spec_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        jc.MetricSpec.parse(spec)
    with pytest.raises(ValueError):
        tc.MetricSpec.parse(spec)


def _mixed_rows():
    """A ledger of v1 rows, two-task v2 rows, a fleet claim record, a
    partial step and snapshot-scored rows."""
    rows = [{"step": 1, "metrics": {"MRR@10": 0.1}},
            {"step": 2, "task": "default", "metrics": {"MRR@10": 0.2},
             "engine": "streaming", "score_dtype": "f32"},
            {"step": 2, "task": "heldout", "metrics": {"MRR@10": 0.3},
             "engine": "materialized", "score_dtype": "bf16"},
            {"kind": "claim", "step": 3, "task": "default"},
            {"step": 3, "task": "default", "metrics": {"MRR@10": 0.4},
             "engine": "streaming", "score_dtype": "f32",
             "handoff": "snapshot"},
            {"step": 3, "task": "heldout", "metrics": {"MRR@10": 0.5},
             "engine": "streaming", "score_dtype": "f32"},
            {"step": 4, "task": "default", "metrics": {"MRR@10": 0.6}},
            {"step": 5, "task": "heldout", "metrics": {"MRR@10": 0.7},
             "worker_id": "w1"},
            {"step": 5, "task": "default", "metrics": {"MRR@10": 0.8},
             "worker_id": "w0"}]
    return rows


@pytest.mark.parametrize("group,expected", [
    ("consecutive", None), ("consecutive", ("default", "heldout")),
    ("completion", ("default", "heldout"))])
def test_flatten_rows_equal_reference(group, expected):
    for ctx in (False, True):
        got = tc.flatten_rows(_mixed_rows(), expected, with_context=ctx,
                              group=group)
        want = jc.flatten_rows(_mixed_rows(), expected, with_context=ctx,
                               group=group)
        assert got == want


# ---------------------------------------------------------------------------
# CheckpointSelector
# ---------------------------------------------------------------------------

def test_selector_best_topk_and_tiebreak():
    def feed(sel):
        for s, v in [(10, 0.1), (20, 0.5), (30, 0.4), (40, 0.5)]:
            sel.observe(s, {"m": v})
        assert sel.best_step == 40             # tie -> later (fresher) step
        assert sel.top_steps() == [40, 20]
        assert sel.ranking()[0] == (40, 0.5)

    out = _both_decisions(lambda pkg: pkg.CheckpointSelector(
        pkg.SelectionConfig(metric="m", top_k=2)), feed)
    assert out["port"] == out["ref"]


def test_selector_min_mode():
    def feed(sel):
        for s, v in [(1, 9.0), (2, 3.0), (3, 5.0)]:
            sel.observe(s, {"rank": v})
        assert sel.best_step == 2 and sel.top_steps() == [2, 3]

    out = _both_decisions(lambda pkg: pkg.CheckpointSelector(
        pkg.SelectionConfig(metric="rank", mode="min", top_k=2)), feed)
    assert out["port"] == out["ref"]


def test_selector_ema_smoothing_denoises_spike():
    noisy = [(1, 0.50), (2, 0.52), (3, 0.90), (4, 0.60), (5, 0.62)]
    for ema, best_is_spike in ((0.0, True), (0.8, False)):
        def feed(sel):
            for s, v in noisy:
                sel.observe(s, {"m": v})
            assert (sel.best_step == 3) == best_is_spike

        out = _both_decisions(lambda pkg: pkg.CheckpointSelector(
            pkg.SelectionConfig(metric="m", top_k=1, ema=ema)), feed)
        assert out["port"] == out["ref"]


def test_selector_new_best_decisions():
    got = {}
    for name, pkg in SIDES:
        sel = pkg.CheckpointSelector(pkg.SelectionConfig(metric="m",
                                                         top_k=3))
        ds = [sel.observe(s, {"m": v},
                          context={"engine": "streaming",
                                   "score_dtype": "int8"})
              for s, v in [(1, 0.3), (2, 0.2), (3, 0.4)]]
        assert ds[0]["new_best"] and not ds[1]["new_best"] \
            and ds[2]["new_best"]
        assert ds[1]["best_step"] == 1 and ds[2]["best_step"] == 3
        got[name] = (ds, _json(sel.events))
    assert got["port"] == got["ref"]


def test_selector_observe_rows_skips_partial_steps():
    out = _both_decisions(
        lambda pkg: pkg.CheckpointSelector(pkg.SelectionConfig(
            metric="heldout:MRR@10", top_k=2)),
        lambda sel: sel.observe_rows(_mixed_rows()))
    assert out["port"] == out["ref"] and out["port"]


def _toy_tree(seed):
    return {"params": {"w": np.random.default_rng(seed).normal(size=(4,))
                       .astype(np.float32)}, "opt_state": {}}


def _save_both(tmp_path, steps):
    """The same trees saved by each package into its own root."""
    roots = {}
    for name, mod in (("ref", jckpt), ("port", ckpt)):
        root = str(tmp_path / name)
        for s in steps:
            tree = _toy_tree(s)
            mod.save(root, s, tree if name == "ref" else {
                "params": {"w": torch.from_numpy(tree["params"]["w"])},
                "opt_state": {}})
        roots[name] = root
    return roots


def test_selector_quality_aware_gc_keeps_topk_union_protect(tmp_path):
    roots = _save_both(tmp_path, (1, 2, 3, 4, 5))
    got = {}
    for name, pkg in SIDES:
        sel = pkg.CheckpointSelector(pkg.SelectionConfig(metric="m",
                                                         top_k=2))
        for s, v in [(1, 0.9), (2, 0.1), (3, 0.8), (4, 0.2)]:
            sel.observe(s, {"m": v})
        deleted = sel.gc(roots[name], protect={5})
        assert sorted(deleted) == [2, 4]
        got[name] = (ckpt.list_steps(roots[name]), _json(sel.events))
    assert got["port"] == got["ref"]
    assert got["port"][0] == [1, 3, 5]


def test_gc_checkpoints_keep_set_and_keep_last_modes(tmp_path):
    roots = _save_both(tmp_path, (1, 2, 3, 4))
    got = {}
    for name, mod in (("ref", jckpt), ("port", ckpt)):
        root = roots[name]
        d1 = mod.gc_checkpoints(root, keep={1, 4}, protect={2})
        left = mod.list_steps(root)
        d2 = mod.gc_checkpoints(root, keep_last=1)
        got[name] = (d1, left, d2)
    assert got["port"] == got["ref"] == ([3], [1, 2, 4], [1, 2])


def test_gc_keep_mode_spares_steps_newer_than_decision(tmp_path):
    roots = _save_both(tmp_path, (1, 2, 3))
    got = {}
    for name, mod in (("ref", jckpt), ("port", ckpt)):
        root = roots[name]
        keep, protect = {3}, {2}                # decision snapshot: 1..3
        mod.save(root, 4, _toy_tree(4) if name == "ref" else {
            "params": {"w": torch.zeros(4)}, "opt_state": {}})
        got[name] = (mod.gc_checkpoints(root, keep=keep, protect=protect),
                     mod.list_steps(root),
                     mod.gc_checkpoints(root, keep=set()))
    assert got["port"] == got["ref"] == ([1], [2, 3, 4], [])


# ---------------------------------------------------------------------------
# EarlyStopController and the STOP marker
# ---------------------------------------------------------------------------

def test_earlystop_patience_and_min_delta(tmp_path):
    markers = {}
    for name, pkg in SIDES:
        stop = str(tmp_path / name / "STOP")
        es = pkg.EarlyStopController(pkg.EarlyStopConfig(
            metric="m", patience=2, min_delta=0.05), stop_path=stop)
        es.observe(1, {"m": 0.50})
        es.observe(2, {"m": 0.52})             # +0.02 < min_delta
        assert not es.stopped
        es.observe(3, {"m": 0.53})
        assert es.stopped and es.reason == "plateau"
        verdict = pkg.stop_requested(stop)
        assert verdict["reason"] == "plateau" and verdict["best_step"] == 1
        assert verdict["step"] == 3
        with open(stop, "rb") as f:
            markers[name] = (f.read(), _json(es.events))
    assert markers["port"][0] == markers["ref"][0]
    # the events name the marker's path, which differs: compare the rest
    strip = [json.loads(e) for e in markers["port"][1]]
    want = [json.loads(e) for e in markers["ref"][1]]
    for a, b in zip(strip, want):
        a.pop("path", None), b.pop("path", None)
    assert strip == want


def test_earlystop_improvement_resets_patience():
    def feed(es):
        for s, v in [(1, 0.1), (2, 0.1), (3, 0.2), (4, 0.2)]:
            es.observe(s, {"m": v})
        assert not es.stopped
        es.observe(5, {"m": 0.2})
        assert es.stopped

    out = _both_decisions(lambda pkg: pkg.EarlyStopController(
        pkg.EarlyStopConfig(metric="m", patience=2)), feed)
    assert out["port"] == out["ref"]


def test_earlystop_min_mode():
    def feed(es):
        for s, v in [(1, 1.0), (2, 0.5), (3, 0.6), (4, 0.7)]:
            stop = es.observe(s, {"loss": v})
        assert stop and es.best == 0.5 and es.best_step == 2

    out = _both_decisions(lambda pkg: pkg.EarlyStopController(
        pkg.EarlyStopConfig(metric="loss", mode="min", patience=2)), feed)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("series,stops", [
    ([(1, 0.50, 1.0), (2, 0.49, 0.9), (3, 0.48, 0.8)], True),
    ([(1, 0.50, None), (2, 0.49, None), (3, 0.48, None)], False),
    ([(1, 0.50, 0.8), (2, 0.49, 0.9), (3, 0.48, 1.0)], False)],
    ids=["overfit", "no_train_feed", "divergence"])
def test_earlystop_overfit_detector_needs_train_feed(series, stops):
    def feed(es):
        for s, v, t in series:
            es.observe(s, {"m": v}, train_loss=t)
        assert es.stopped == stops
        assert (es.reason == "overfit") == stops

    out = _both_decisions(lambda pkg: pkg.EarlyStopController(
        pkg.EarlyStopConfig(metric="m", patience=10, overfit_window=3)),
        feed)
    assert out["port"] == out["ref"]


def test_earlystop_latched_after_stop():
    def feed(es):
        es.observe(1, {"m": 0.5})
        es.observe(2, {"m": 0.4})
        assert es.stopped
        assert es.observe(3, {"m": 0.9}) is True
        assert len([e for e in es.events if e.kind == "stop"]) == 1

    out = _both_decisions(lambda pkg: pkg.EarlyStopController(
        pkg.EarlyStopConfig(metric="m", patience=1)), feed)
    assert out["port"] == out["ref"]


def test_slope_least_squares():
    assert _slope([0.0, 1.0, 2.0]) == pytest.approx(1.0)
    assert _slope([5.0, 5.0, 5.0]) == pytest.approx(0.0)
    rng = np.random.default_rng(3)
    for n in (2, 3, 7):
        ys = [float(y) for y in rng.normal(size=n)]
        assert _slope(ys) == jslope(ys)


def test_stop_marker_atomic_write_and_poll(tmp_path):
    path = str(tmp_path / "sub" / "STOP")
    assert tc.stop_requested(path) is None
    tc.write_stop_marker(path, {"reason": "plateau", "step": 7})
    assert not os.path.exists(path + ".tmp")
    assert tc.stop_requested(path)["step"] == 7
    assert jc.stop_requested(path) == tc.stop_requested(path)
    jc.write_stop_marker(path, {"reason": "overfit", "step": 9})
    assert tc.stop_requested(path) == {"reason": "overfit", "step": 9}
    with open(path, "w") as f:
        f.write("{not json")
    assert tc.stop_requested(path) == jc.stop_requested(path) \
        == {"reason": "unreadable_marker"}


def test_trainer_polls_stop_marker_between_steps(tmp_path):
    """Both trainers halt on the marker before the step budget and commit
    their final state at the same step."""
    from repro.train import optim as joptim
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JConfig
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def batches_for(stop):
        def batches(step):
            if step == 7 and not os.path.exists(stop):
                tc.write_stop_marker(stop, {"reason": "test", "step": step})
            return {"x": np.zeros((1,), np.float32)}
        return batches

    got = {}
    for name in ("ref", "port"):
        stop = str(tmp_path / name / "STOP")
        ckdir = str(tmp_path / name / "ck")
        if name == "ref":
            tr = JTrainer(JConfig(total_steps=100, ckpt_every=50,
                                  log_every=50, ckpt_dir=ckdir,
                                  async_save=False, stop_file=stop),
                          lambda p, b: (jnp.mean(p["w"] ** 2), {}),
                          joptim.adamw(1e-2),
                          {"w": jnp.ones((2,), jnp.float32)},
                          batches_for(stop))
        else:
            tr = Trainer(TrainerConfig(total_steps=100, ckpt_every=50,
                                       log_every=50, ckpt_dir=ckdir,
                                       async_save=False, stop_file=stop),
                         lambda p, b: (torch.mean(p["w"] ** 2), {}),
                         optim.adamw(1e-2), {"w": torch.ones(2)},
                         batches_for(stop))
        tr.run()
        got[name] = (tr.stopped_early, tr.step, tr.stop_verdict,
                     ckpt.list_steps(ckdir))
    assert got["port"] == got["ref"] == (True, 8, {"reason": "test",
                                                   "step": 7}, [8])


# ---------------------------------------------------------------------------
# Ensembling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_average_params_bit_equal_to_reference(dt):
    """Weighted means of seeded trees, float64 accumulation, cast back: bit
    for bit the reference's, at f32 and at bf16."""
    rng = np.random.default_rng(0)
    np_dt = np.float32 if dt == "f32" else ml_dtypes.bfloat16
    t_dt = torch.float32 if dt == "f32" else torch.bfloat16
    trees = [{"a": rng.normal(size=(64, 33)).astype(np.float32),
              "b": [rng.normal(size=(7,)).astype(np.float32),
                    rng.normal(size=()).astype(np.float32)]}
             for _ in range(3)]
    ref_trees = [{"a": t["a"].astype(np_dt),
                  "b": [x.astype(np_dt) for x in t["b"]]} for t in trees]
    port_trees = [{"a": torch.from_numpy(t["a"]).to(t_dt),
                   "b": [torch.from_numpy(x).to(t_dt) for x in t["b"]]}
                  for t in trees]
    for weights in (None, [3.0, 1.0, 0.5]):
        want = jc.average_params(ref_trees, weights)
        got = tc.average_params(port_trees, weights)
        for w, g in zip((want["a"], *want["b"]), (got["a"], *got["b"])):
            w = np.asarray(w)
            assert g.dtype == t_dt and tuple(g.shape) == w.shape
            bits = g.view(torch.int16).numpy().view(np.uint16) \
                if dt == "bf16" else g.numpy().view(np.uint32)
            want_bits = w.view(np.uint16 if dt == "bf16" else np.uint32)
            np.testing.assert_array_equal(bits, want_bits)


def test_average_params_weighted_and_dtype():
    t1 = {"w": torch.tensor([1.0, 2.0])}
    t2 = {"w": torch.tensor([3.0, 4.0])}
    avg = tc.average_params([t1, t2])
    np.testing.assert_allclose(avg["w"].numpy(), [2.0, 3.0])
    assert avg["w"].dtype == torch.float32
    w = tc.average_params([t1, t2], weights=[3.0, 1.0])
    np.testing.assert_allclose(w["w"].numpy(), [1.5, 2.5])
    with pytest.raises(ValueError):
        tc.average_params([])
    with pytest.raises(ValueError):
        tc.average_params([t1, t2], weights=[1.0])


W_TEMPLATE = {"params": {"w": (3,)}}


def test_uniform_soup_and_materialize_roundtrip(tmp_path):
    root = str(tmp_path / "ck")
    for s, fill in [(1, 1.0), (2, 3.0)]:
        ckpt.save(root, s, {"params": {"w": torch.full((3,), fill)},
                            "opt_state": {}})
    soup = tc.uniform_soup(root, [1, 2], W_TEMPLATE)
    np.testing.assert_allclose(soup["w"].numpy(), np.full((3,), 2.0))
    vstep = tc.materialize_virtual(root, soup, members=[1, 2])
    assert vstep == 3                          # newest + 1
    state, extra = ckpt.restore(root, vstep, template=W_TEMPLATE)
    assert torch.equal(state["params"]["w"], soup["w"])
    assert extra["ensemble_of"] == [1, 2] and extra["virtual"] is True
    assert vstep in CheckpointWatcher(root).poll()
    # the reference reads the port's virtual checkpoint, opt_state and all
    jstate, jextra = jckpt.restore(root, vstep)
    np.testing.assert_array_equal(np.asarray(jstate["params"]["w"]),
                                  soup["w"].numpy())
    assert jstate["opt_state"] == {} and jextra == extra
    # the same soup through the reference's ensemble: equal bits
    jsoup = jc.uniform_soup(root, [1, 2])
    np.testing.assert_array_equal(np.asarray(jsoup["w"]), soup["w"].numpy())


def test_greedy_soup_never_scores_below_best_single(tmp_path):
    root = str(tmp_path / "ck")
    target = np.asarray([1.0, 1.0, 1.0, 1.0])
    fills = {1: [1.0, 1.0, 1.0, 0.8],          # best
             2: [1.1, 0.9, 1.0, 0.9],          # helpful
             3: [-5.0, 9.0, -4.0, 6.0]}        # poison
    for s, w in fills.items():
        ckpt.save(root, s, {"params": {"w": torch.tensor(w)},
                            "opt_state": {}})

    def score(params):
        return -float(np.sum((np.asarray(params["w"], np.float64)
                              - target) ** 2))

    singles = {s: score({"w": np.asarray(w, np.float32)})
               for s, w in fills.items()}
    ranked = sorted(singles, key=lambda s: -singles[s])
    params, members, sc = tc.greedy_soup(root, ranked, score,
                                         template={"params": {"w": (4,)}})
    assert 3 not in members
    assert sc >= max(singles.values())
    jparams, jmembers, jsc = jc.greedy_soup(root, ranked, score)
    assert members == jmembers and sc == jsc
    np.testing.assert_array_equal(params["w"].numpy(),
                                  np.asarray(jparams["w"]))


def test_trainer_resumes_past_virtual_checkpoint(tmp_path):
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig
    ckdir = str(tmp_path / "ck")

    def loss_fn(params, batch):
        return torch.mean(params["w"] ** 2), {}

    tr = Trainer(TrainerConfig(total_steps=10, ckpt_every=5, log_every=5,
                               ckpt_dir=ckdir, async_save=False),
                 loss_fn, optim.adamw(1e-2), {"w": torch.ones(2)},
                 lambda s: {})
    tr.run()
    soup = tc.uniform_soup(ckdir, [5, 10], {"params": {"w": (2,)}})
    vstep = tc.materialize_virtual(ckdir, soup, members=[5, 10])
    assert vstep == 11
    tr2 = Trainer(TrainerConfig(total_steps=12, ckpt_every=5, log_every=5,
                                ckpt_dir=ckdir, async_save=False),
                  loss_fn, optim.adamw(1e-2), {"w": torch.ones(2)},
                  lambda s: {})
    assert tr2.step == 10                      # resumed past the soup
    tr2.run()
    assert tr2.step == 12


# ---------------------------------------------------------------------------
# ControlPlane + offline replay
# ---------------------------------------------------------------------------

def test_plane_train_loss_lookup():
    for _, pkg in SIDES:
        plane = pkg.ControlPlane(None, pkg.ControlConfig(metric="m"))
        plane.note_train(10, {"loss": 1.0})
        plane.note_train(20, {"loss": 0.5})
        plane.note_train(30, {"acc": 0.5})     # no loss: ignored
        assert [plane.train_loss_for(s) for s in (5, 10, 15, 25, 30)] \
            == [None, 1.0, 1.0, 0.5, 0.5]


def test_plane_replay_reproduces_decisions():
    got = {}
    for name, pkg in SIDES:
        cfg = pkg.ControlConfig(metric="m", early_stop=True, patience=2,
                                min_delta=0.01, keep_top_k=2)
        online = pkg.ControlPlane(None, cfg)
        rows = []
        for s, v in [(10, 0.2), (20, 0.5), (30, 0.5), (40, 0.5),
                     (50, 0.5)]:
            online.observe(s, {"m": v})
            rows.append({"step": s, "metrics": {"m": v}})
        assert online.stopped
        offline = pkg.replay_ledger(rows, cfg)
        assert offline.events.decisions() == online.events.decisions()
        assert offline.stopped and offline.selector.best_step == \
            online.selector.best_step
        got[name] = _json(offline.events.decisions())
    assert got["port"] == got["ref"]


def test_plane_ema_smooths_earlystop_too():
    series = [(1, 0.5), (2, 0.5), (3, 0.9), (4, 0.5), (5, 0.5)]
    for _, pkg in SIDES:
        stopped_at = {}
        for name, ema in (("smooth", 0.95), ("raw", 0.0)):
            plane = pkg.ControlPlane(None, pkg.ControlConfig(
                metric="m", early_stop=True, patience=2, min_delta=0.05,
                ema=ema))
            for s, v in series:
                plane.observe(s, {"m": v})
                if plane.stopped and name not in stopped_at:
                    stopped_at[name] = s
        assert stopped_at == {"smooth": 3, "raw": 5}


def test_plane_on_result_runs_gc_with_protection(tmp_path):
    roots = _save_both(tmp_path, (1, 2, 3))

    class FakeValidator:
        def protect_set(self):
            return {3}                          # 3 not validated yet

    got = {}
    for name, pkg in SIDES:
        plane = pkg.ControlPlane(roots[name],
                                 pkg.ControlConfig(metric="m", keep_top_k=1))
        res = _jres if name == "ref" else _res
        for s, v in [(1, 0.9), (2, 0.1)]:
            plane.on_result(res(s, v), FakeValidator())
        got[name] = (ckpt.list_steps(roots[name]), _json(plane.events))
    assert got["port"] == got["ref"]
    assert got["port"][0] == [1, 3]


def test_plane_ensemble_skips_gc_deleted_members(tmp_path):
    """With ensemble_top_k > keep_top_k the GC-deleted tail is left out of
    the soup."""
    root = str(tmp_path / "ck")
    for s, fill in [(1, 1.0), (2, 2.0), (3, 4.0)]:
        ckpt.save(root, s, {"params": {"w": torch.full((2,), fill)},
                            "opt_state": {}})
    plane = tc.ControlPlane(root, tc.ControlConfig(
        metric="m", keep_top_k=2, ensemble_top_k=3, ensemble_greedy=False))
    validated = set()

    class V:
        def protect_set(self):
            return set(ckpt.list_steps(root)) - validated

    for s, v in [(1, 0.1), (2, 0.5), (3, 0.9)]:
        validated.add(s)
        plane.on_result(_res(s, v), V())
    assert ckpt.list_steps(root) == [2, 3]
    vstep = plane.build_ensemble(lambda p: 0.0,
                                 template={"params": {"w": (2,)}})
    assert vstep == 4
    assert plane.ensemble_members == [3, 2]
    got = ckpt.restore(root, vstep, template={"params": {"w": (2,)}})[0]
    np.testing.assert_allclose(got["params"]["w"].numpy(), np.full((2,),
                                                                   3.0))
    ev = [e for e in plane.events if e.kind == "ensemble"][-1]
    assert ev.payload == {"members": [3, 2], "score": 0.0, "greedy": False}


def test_plane_rehydrate_protects_prior_best_across_restart(tmp_path):
    roots = _save_both(tmp_path, (10, 20))
    got = {}
    for name, pkg in SIDES:
        led_path = str(tmp_path / f"{name}_ledger.jsonl")
        ledger_cls, res = (JLedger, _jres) if name == "ref" \
            else (ValidationLedger, _res)
        led = ledger_cls(led_path)
        for s, v in [(10, 0.9), (20, 0.8)]:
            led.record(res(s, v))
        plane = pkg.ControlPlane(roots[name],
                                 pkg.ControlConfig(metric="m", keep_top_k=2))
        assert plane.rehydrate(ledger_cls(led_path).rows()) == 2
        assert plane.selector.top_steps() == [10, 20]
        (jckpt if name == "ref" else ckpt).save(
            roots[name], 30, _toy_tree(30) if name == "ref"
            else {"params": {"w": torch.zeros(4)}, "opt_state": {}})

        class V:
            def protect_set(self):
                return set()

        plane.on_result(res(30, 0.1), V())
        got[name] = (ckpt.list_steps(roots[name]), _json(plane.events))
    assert got["port"] == got["ref"]
    assert got["port"][0] == [10, 20]


def test_validate_step_bypasses_skipping_policy(tmp_path):
    """A soup's step is rarely on-stride: ``validate_step`` scores it
    anyway, ledgers it, and leaves it out of the policy-skipped set."""
    from test_torch_watcher_policies import _toy_validator
    root = str(tmp_path / "ck")
    for s in (10, 20):
        ckpt.save(root, s, {"x": torch.zeros(1)})
    v = _toy_validator(root, policy=Policy(kind="stride", stride=10))
    v.validate_pending()
    assert v.ledger.validated_steps == [10, 20]
    ckpt.save(root, 21, {"x": torch.zeros(1)})  # an off-stride soup step
    assert v.validate_pending() == 0            # the policy skips 21...
    assert 21 in v.watcher.skipped
    assert v.validate_step(21) == 1             # ...the explicit path not
    assert 21 in v.ledger.validated_steps
    assert 21 not in v.watcher.skipped
    assert v.validate_step(21) == 0             # still ledger-idempotent


def test_plane_ensemble_disabled_paths(tmp_path):
    t = {"params": {"w": (2,)}}
    plane = tc.ControlPlane(str(tmp_path), tc.ControlConfig(metric="m"))
    assert plane.build_ensemble(lambda p: 0.0, template=t) is None
    plane2 = tc.ControlPlane(str(tmp_path),
                             tc.ControlConfig(metric="m", ensemble_top_k=2))
    plane2.observe(1, {"m": 0.5})
    assert plane2.build_ensemble(lambda p: 0.0, template=t) is None


# ---------------------------------------------------------------------------
# The ledger and the CSV logger the control consumers read
# ---------------------------------------------------------------------------

def test_ledger_concurrent_records_and_reads(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    led = ValidationLedger(path)
    n_threads, per_thread = 8, 25
    errors = []

    def writer(base):
        try:
            for i in range(per_thread):
                led.record(_res(base * 1000 + i, 0.5))
        except Exception as e:                  # pragma: no cover
            errors.append(e)

    def reader():
        try:
            for _ in range(50):
                for row in led.rows():
                    assert "step" in row and "metrics" in row
        except Exception as e:                  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)] + \
              [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(led.rows()) == n_threads * per_thread
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert len(lines) == n_threads * per_thread
    assert ValidationLedger(path).validated_steps == led.validated_steps
    assert JLedger(path).validated_steps == led.validated_steps


def test_ledger_rows_preserve_record_order(tmp_path):
    files = {}
    for name, cls, res in (("ref", JLedger, _jres),
                           ("port", ValidationLedger, _res)):
        led = cls(str(tmp_path / f"{name}.jsonl"))
        for s in (30, 10, 20):
            led.record(res(s, 0.1))
        assert [r["step"] for r in led.rows()] == [30, 10, 20]
        assert led.validated_steps == [10, 20, 30]
        with open(tmp_path / f"{name}.jsonl", "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["ref"]


def test_csvlogger_restart_appends_instead_of_truncating(tmp_path):
    files = {}
    for name, cls in (("ref", JCSVLogger), ("port", CSVLogger)):
        path = str(tmp_path / f"{name}.csv")
        lg1 = cls(path)
        lg1.log(1, {"mrr": 0.1})
        lg1.log(2, {"mrr": 0.2})
        cls(path).log(3, {"mrr": 0.3})          # fresh process, same fields
        cls(path).log(4, {"mrr": 0.4, "recall": 0.9})   # a new field
        with open(path) as f:
            rows = list(csv.DictReader(f))
        assert [r["step"] for r in rows] == ["1", "2", "3", "4"]
        assert rows[0]["mrr"] == "0.1" and rows[3]["recall"] == "0.9"
        with open(path, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["ref"]
