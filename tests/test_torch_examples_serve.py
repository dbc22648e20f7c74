"""The torch twins of the serving and scale-out examples, on the CPU at
small sizes: serve_live, fleet_validation, distributed_validation and
recsys_asyncval.

Each twin runs with ``device="cpu"`` and its own asserts hold; then it is
held against the JAX package: the reference's ``replay_swaps`` reads the
twin's swap log to the same timeline; the reference's ``replay`` and
``replay_ledger`` of the fleet twin's ledger give its units and decisions
byte for byte; the sharded top-k ids equal ``topk_exact``'s and the
reference's ``topk_exact``'s on the same numpy inputs; the reference's
suite validates the recommender twin's checkpoints to its metrics within
1e-6.  No time is asserted.
"""

import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import repro.control as jc
import repro.serve as jserve
from repro.configs import registry as jregistry
from repro.core import workqueue as jworkqueue
from repro.core.retrieval import topk_exact as jtopk_exact
from repro.core.suite import ValidationConfig as JConfig
from repro.core.suite import ValidationSuite as JSuite
from repro.core.suite import ValidationTask as JTask
from repro.core.validator import AsyncValidator as JValidator
from repro.models import recsys as jrcs
from repro.models.biencoder import EncoderSpec as JEncoderSpec
from repro_torch.core import workqueue as tworkqueue
from repro_torch.serve import replay_swaps

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_live_twin(tmp_path):
    out = _twin("serve_live_torch").main(
        device="cpu", n_passages=150, n_queries=12, n_ckpts=2,
        steps_per_ckpt=10, workdir=str(tmp_path))
    assert out["drops"] == 0 and out["n_responses"] > 0
    assert set(out["served"]) <= set(out["swaps"])
    assert out["live_step"] == out["swaps"][-1]
    assert sorted(out["metrics"]) == [10, 20]
    swaps = replay_swaps(out["serve_log"])
    assert swaps == jserve.replay_swaps(out["serve_log"])
    assert [s["step"] for s in swaps] == out["swaps"]


def test_fleet_twin_replays_in_reference(tmp_path):
    out = _twin("fleet_validation_torch").main(
        device="cpu", n_passages=150, n_queries=12, steps=30,
        snapshot_every=15, workdir=str(tmp_path))
    assert out["validated_steps"] == [0, 15, 30]
    # the full worker may take "dev" units too; only it takes "deep" ones
    units = out["units_by_worker"]
    assert [u for u in units["full-0"] if u[1] == "deep"] == \
        [(s, "deep") for s in (0, 15, 30)]
    assert all(task == "dev" for _, task in units.get("smoke-0", []))
    path = out["ledger_path"]
    ref_state = jworkqueue.replay(path, lease_ttl=32)
    port_state = tworkqueue.replay(path, lease_ttl=32)
    assert ref_state.completed_units() == port_state.completed_units() == \
        [(s, t) for s in (0, 15, 30) for t in ("deep", "dev")]
    with open(path) as f:
        rows = [r for r in (json.loads(line) for line in f) if "kind" not in r]
    offline = jc.replay_ledger(
        rows, jc.ControlConfig(metric="deep:MRR@10", mode="max",
                               keep_top_k=3),
        expected_tasks=out["task_names"], group="completion")
    assert [e.to_json() for e in offline.events.decisions()] == \
        out["decisions"]
    assert offline.selector.best_step == out["best_step"]


def test_fleet_twin_observes_the_last_completion(tmp_path, monkeypatch):
    """The unit that completes the backlog may land between the drain's
    pump and its check (a fast card hits that window): slow units and a
    slow reap widen it, and every completed step must still be observed
    online before the decisions are replayed."""
    import time

    from repro_torch.core.validator import ValidatorWorker
    from repro_torch.launch.fleet import FleetSupervisor

    def slowed(fn):
        def wrapper(self, *args, **kwargs):
            time.sleep(0.3)
            return fn(self, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(ValidatorWorker, "execute_unit",
                        slowed(ValidatorWorker.execute_unit))
    monkeypatch.setattr(FleetSupervisor, "poll_workers",
                        slowed(FleetSupervisor.poll_workers))
    out = _twin("fleet_validation_torch").main(
        device="cpu", n_passages=150, n_queries=12, steps=30,
        snapshot_every=15, workdir=str(tmp_path))
    assert out["validated_steps"] == [0, 15, 30]
    assert sorted(json.loads(e)["step"] for e in out["decisions"]) == \
        [0, 15, 30]


def test_distributed_twin_sharded_ids_equal_exact():
    kw = dict(Q=8, N=4000, D=32, k=50, seed=3)
    out = _twin("distributed_validation_torch").main(device="cpu", **kw)
    assert out["agree"] == 1.0
    np.testing.assert_array_equal(out["ids_sharded"], out["ids_exact"])
    np.testing.assert_array_equal(out["scores_sharded"],
                                  out["scores_exact"])
    assert out["chunked_items"] == kw["N"]
    rng = np.random.default_rng(kw["seed"])
    q = rng.normal(size=(kw["Q"], kw["D"])).astype(np.float32)
    c = rng.normal(size=(kw["N"], kw["D"])).astype(np.float32)
    s_ref, i_ref = jtopk_exact(jnp.asarray(q), jnp.asarray(c), k=kw["k"])
    np.testing.assert_array_equal(out["ids_exact"], np.asarray(i_ref))
    np.testing.assert_allclose(out["scores_exact"], np.asarray(s_ref),
                               rtol=1e-5, atol=1e-5)


def test_recsys_twin_matches_reference(tmp_path):
    twin = _twin("recsys_asyncval_torch")
    out = twin.main(device="cpu", total_steps=80, ckpt_every=40,
                    n_users=200, workdir=str(tmp_path))
    assert [r["step"] for r in out["results"]] == [40, 80]
    cfg = dataclasses.replace(jregistry.get("sasrec").smoke_config(),
                              item_vocab=twin.N_ITEMS, seq_len=twin.SEQ,
                              n_negatives=64, compute_dtype=jnp.float32)

    def encode_items(params, tokens, mask):
        return jrcs.item_embeddings(params, cfg, tokens[:, 0])

    def encode_users(params, tokens, mask):
        u = jrcs.user_embed(params, cfg, tokens, mask)
        return u / jnp.clip(jnp.linalg.norm(u, axis=-1, keepdims=True),
                            1e-6)

    spec = JEncoderSpec(name="sasrec-dr", dim=cfg.embed_dim,
                        encode_query=encode_users,
                        encode_passage=encode_items,
                        init=lambda rng: jrcs.init(rng, cfg),
                        q_max_len=twin.SEQ, p_max_len=1)
    names = ("MRR@10", "Recall@100")
    suite = JSuite(spec, [JTask("default", out["corpus"], out["queries"],
                                out["qrels"], metrics=names, k=100)],
                   JConfig(metrics=names, k=100, batch_size=64))
    v = JValidator(out["ckpts_dir"], suite)
    v.validate_pending()
    want = {r.step: r for r in v.results}
    for r in out["results"]:
        ref = want[r["step"]]
        assert r["subset_size"] == ref.subset_size == twin.N_ITEMS - 1
        for name in names:
            assert r["metrics"][name] == pytest.approx(ref.metrics[name],
                                                       abs=1e-6), name


@pytest.mark.parametrize("name", ["serve_live_torch",
                                  "fleet_validation_torch",
                                  "distributed_validation_torch",
                                  "recsys_asyncval_torch"])
def test_serve_twins_raise_without_a_card(name, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        _twin(name)._cli([])
