"""The whole slice: the JAX CLI and the port's CLI on one checkpoint dir.

The JAX package writes two checkpoints of the smoke dr-bert; both CLIs
validate them one-shot over the same corpus files, the JAX side with
``--impl xla`` and ``--impl pallas`` (interpret mode), the port with
``--device cpu`` and ``--impl torch`` and ``--impl cuda`` (whose wrapper
takes its plain version for CPU tensors).  Both encoders compute in f32
(the frameworks round bf16 at different places on the CPU; the bf16 default
is held by tests/test_torch_encoder.py).  The ledgers must have the same
steps and keys and metrics within 1e-6 at every score dtype.

The round's first done-criterion: a checkpoint directory that the
reference's ``repro.train.trainer.Trainer`` wrote (params and AdamW state)
is validated by both CLIs with equal metrics, and the reference's control
plane replays the port's ledger to the decisions it replays the JAX CLI's
ledger to.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import dr_bert_base as jcfg_mod
from repro.core.cli import main as jax_main
from repro.data import corpus as jcorpus
from repro.models import nn as jnn
from repro.models import transformer as jtfm
from repro.models.biencoder import biencoder_spec as jax_spec
from repro_torch.configs import dr_bert_base as tcfg_mod
from repro_torch.core.cli import main as torch_main
from repro_torch.models.biencoder import biencoder_spec as torch_spec

STEPS = (10, 20)
TRAIN_STEPS = (1, 2, 3)


def jax_encoder(args):
    """--encoder hook of the JAX CLI: smoke dr-bert computing in f32."""
    cfg = dataclasses.replace(jcfg_mod.smoke_config(),
                              compute_dtype=jnp.float32)
    return jax_spec(cfg, q_max_len=args.q_max_len, p_max_len=args.p_max_len)


def torch_encoder(args):
    """--encoder hook of the port's CLI: the same model on --device."""
    cfg = dataclasses.replace(tcfg_mod.smoke_config(),
                              compute_dtype=torch.float32)
    return torch_spec(cfg, q_max_len=args.q_max_len,
                      p_max_len=args.p_max_len, device=args.device)


@pytest.fixture(scope="module")
def filespace(tmp_path_factory):
    base = tmp_path_factory.mktemp("slice")
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=96, n_queries=12,
                                             vocab=211, p_len=20, q_len=6)
    (base / "corpus").mkdir()
    jcorpus.write_jsonl(str(base / "corpus" / "c.jsonl"), ds.corpus)
    jcorpus.write_jsonl(str(base / "q.jsonl"), ds.queries)
    with open(base / "qrels.txt", "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    cfg = jcfg_mod.smoke_config()
    for i, step in enumerate(STEPS):
        params = jnn.materialize(jtfm.init(jax.random.PRNGKey(i), cfg))
        jckpt.save(str(base / "ckpts"), step, {"params": params})
    return base


def _args(base, out, encoder):
    return ["--query_file", str(base / "q.jsonl"),
            "--candidate_dir", str(base / "corpus"),
            "--ckpts_dir", str(base / "ckpts"),
            "--qrel_file", str(base / "qrels.txt"),
            "--q_max_len", "8", "--p_max_len", "24", "--chunk_size", "32",
            "--retrieve_k", "20", "--metrics", "MRR@10", "Recall@20",
            "nDCG@10", "--output_dir", str(out),
            "--encoder", f"tests.test_torch_slice:{encoder}"]


def _ledger(out):
    with open(os.path.join(out, "asyncval_ledger.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_port_cli_matches_jax_cli(filespace, tmp_path, score_dtype):
    ledgers = {}
    for impl in ("xla", "pallas"):
        out = tmp_path / f"jax_{impl}"
        rc = jax_main(_args(filespace, out, "jax_encoder")
                      + ["--impl", impl, "--score_dtype", score_dtype])
        assert rc == 0
        ledgers[impl] = _ledger(out)
    for impl in ("torch", "cuda"):
        out = tmp_path / f"port_{impl}"
        rc = torch_main(_args(filespace, out, "torch_encoder")
                        + ["--impl", impl, "--score_dtype", score_dtype,
                           "--device", "cpu"])
        assert rc == 0
        ledgers[impl] = _ledger(out)
    ref = ledgers["xla"]
    assert [r["step"] for r in ref] == list(STEPS)
    for impl, rows in ledgers.items():
        assert [r["step"] for r in rows] == list(STEPS), impl
        for got, want in zip(rows, ref):
            assert set(got) == set(want), impl
            assert set(got["timings"]) == set(want["timings"]), impl
            assert got["score_dtype"] == score_dtype
            assert got["engine"] == want["engine"] == "streaming"
            assert got["subset_size"] == want["subset_size"]
            for name, v in want["metrics"].items():
                assert got["metrics"][name] == pytest.approx(v, abs=1e-6), \
                    (impl, name)


def test_scan_window_flag_is_ported(filespace, tmp_path):
    # every flag of the reference's CLI is ported: the control plane's, the
    # hand-off's, serving's and the fleet's (tests/test_torch_control_
    # integration.py, tests/test_torch_serve.py, tests/test_torch_fleet.py)
    # and --scan_window, whose rows equal the default window's
    default = tmp_path / "default"
    assert torch_main(_args(filespace, default, "torch_encoder")
                      + ["--device", "cpu"]) == 0
    base = _args(filespace, tmp_path, "torch_encoder") + ["--device", "cpu"]
    assert torch_main(base + ["--scan_window", "4"]) == 0
    want = _ledger(default)
    got = _ledger(tmp_path)
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        list(STEPS)
    for g, w in zip(got, want):
        assert g["metrics"] == w["metrics"]
        assert g["subset_size"] == w["subset_size"]
    fleet = tmp_path / "fleet"
    assert torch_main(_args(filespace, fleet, "torch_encoder")
                      + ["--device", "cpu", "--worker", "--worker_id", "w0",
                         "--lease_ttl", "4"]) == 0
    rows = [r for r in _ledger(fleet) if "kind" not in r]
    assert sorted(r["step"] for r in rows) == list(STEPS)
    assert {r["worker_id"] for r in rows} == {"w0"}


def test_default_device_is_cuda_and_never_falls_back(filespace, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default then runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main(_args(filespace, tmp_path, "torch_encoder"))
    assert not (tmp_path / "asyncval_ledger.jsonl").exists()


def test_rerun_is_idempotent(filespace, tmp_path):
    args = _args(filespace, tmp_path, "torch_encoder") + ["--device", "cpu"]
    assert torch_main(args) == 0
    assert torch_main(args) == 0
    assert [r["step"] for r in _ledger(tmp_path)] == list(STEPS)


# ---------------------------------------------------------------------------
# Done-criterion: the reference trainer's checkpoint directory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(filespace, tmp_path_factory):
    """Three checkpoints from ``repro.train.trainer.Trainer`` on the smoke
    dr-bert (contrastive loss, AdamW), driven on the CPU as
    tests/test_train.py drives it; then one validation by each CLI."""
    import numpy as np

    from repro.models import biencoder as jbienc
    from repro.train import optim
    from repro.train.trainer import Trainer, TrainerConfig
    base = tmp_path_factory.mktemp("trained")
    cfg = jcfg_mod.smoke_config()
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=96, n_queries=12,
                                             vocab=211, p_len=20, q_len=6)
    qids = list(ds.qrels)

    def batch_for(step, n=8):
        rng = np.random.default_rng(step)
        pick = [qids[i] for i in rng.choice(len(qids), n, replace=False)]
        q_t, q_m = jcorpus.pad_batch([ds.queries[q] for q in pick], 8)
        p_t, p_m = jcorpus.pad_batch(
            [ds.corpus[next(iter(ds.qrels[q]))] for q in pick], 24)
        return {"q_tokens": q_t, "q_mask": q_m,
                "p_tokens": p_t[:, None], "p_mask": p_m[:, None]}

    def loss_fn(params, batch):
        return jbienc.loss_fn(params, cfg, batch)

    params = jnn.materialize(jtfm.init(jax.random.PRNGKey(5), cfg))
    tr = Trainer(TrainerConfig(total_steps=len(TRAIN_STEPS), ckpt_every=1,
                               ckpt_dir=str(base / "ckpts"), log_every=1),
                 loss_fn, optim.adamw(1e-3), params, batch_for)
    tr.run()
    ledgers = {}
    for side, main, encoder, extra in (
            ("jax", jax_main, "jax_encoder", []),
            ("port", torch_main, "torch_encoder", ["--device", "cpu"])):
        out = base / side
        args = _args(filespace, out, encoder) + extra
        args[args.index("--ckpts_dir") + 1] = str(base / "ckpts")
        assert main(args) == 0
        ledgers[side] = _ledger(out)
    return {"ckpts": str(base / "ckpts"), "ledgers": ledgers}


def test_trainer_checkpoints_validate_alike(trained):
    """The trainer saved params and optimizer state; both CLIs read the
    params and agree on every metric within 1e-6."""
    from repro.ckpt import checkpoint as jckpt
    state, _ = jckpt.restore(trained["ckpts"], TRAIN_STEPS[0])
    assert set(state) == {"params", "opt_state"}
    ref, got = trained["ledgers"]["jax"], trained["ledgers"]["port"]
    assert [r["step"] for r in ref] == [r["step"] for r in got] \
        == list(TRAIN_STEPS)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        assert a["engine"] == b["engine"] and a["task"] == b["task"]
        assert a["metrics"].keys() == b["metrics"].keys()
        for name, v in b["metrics"].items():
            assert a["metrics"][name] == pytest.approx(v, abs=1e-6), name


def test_control_plane_replays_port_ledger_alike(trained):
    """``repro.control.replay_ledger`` fed the port's rows gives the
    decisions it gives fed the JAX CLI's rows."""
    from repro.control import ControlConfig
    from repro.control.plane import replay_ledger
    cfg = ControlConfig(metric="MRR@10", keep_top_k=2, early_stop=True,
                        patience=1)
    want = replay_ledger(trained["ledgers"]["jax"], cfg).events.decisions()
    got = replay_ledger(trained["ledgers"]["port"], cfg).events.decisions()
    assert want, "the replay made no decision"
    assert got == want
