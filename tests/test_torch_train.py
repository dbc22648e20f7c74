"""The port's trainer against the JAX package's: optimizers, schedules,
``contrastive_loss`` with its gradients, ``Trainer`` loss sequences,
checkpoint/restart across packages, ``AsyncSaver`` and ``launch.train``.

Mirrors tests/test_train.py (the same 2-parameter quadratic problem, run
through the port) and tests/test_ckpt.py's async-saver test.  The
comparisons feed seeded numpy inputs to both packages: one optimizer update
within 1e-6, the smoke dr-bert's loss and gradients within 1e-5, ten
``Trainer`` steps' losses within 1e-4 (relative), the treedef bytes
exactly.  Everything runs on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import dr_bert_base as jcfg_mod
from repro.models import biencoder as jbienc
from repro.train import optim as joptim
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import dr_bert_base as tcfg_mod
from repro_torch.core import pytree
from repro_torch.data import corpus as tcorpus
from repro_torch.launch import train as tlaunch
from repro_torch.models import biencoder as tbienc
from repro_torch.models import transformer as ttfm
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

# ---------------------------------------------------------------------------
# The 2-parameter quadratic problem of tests/test_train.py, in torch
# ---------------------------------------------------------------------------

TARGET = torch.tensor([3.0, -2.0])


def loss_fn(params, batch):
    pred = batch["x"] @ params["w"]
    loss = torch.mean(torch.square(pred - batch["y"]))
    return loss, {"mse": loss}


def batch_for(step: int, n=16):
    rng = np.random.default_rng(step)
    x = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    return {"x": x, "y": x @ TARGET}


def init_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(2,)).astype(np.float32))}


@pytest.mark.parametrize("make_opt", [
    lambda: optim.adamw(5e-2, weight_decay=0.0),
    lambda: optim.adafactor(5e-1),
    lambda: optim.compressed(optim.adamw(5e-2, weight_decay=0.0)),
], ids=["adamw", "adafactor", "compressed"])
def test_optimizers_converge(make_opt):
    opt = make_opt()
    params = init_params()
    state = opt.init(params)
    step = make_train_step(loss_fn, opt)
    for i in range(300):
        params, state, m = step(params, state, batch_for(i))
    np.testing.assert_allclose(params["w"].numpy(), TARGET.numpy(),
                               atol=0.15)


def test_adamw_matches_reference_update():
    """One AdamW step against a hand-rolled numpy reference."""
    opt = optim.adamw(0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      max_grad_norm=None)
    params = {"w": torch.tensor([1.0, 2.0])}
    state = opt.init(params)
    new_p, new_state = opt.update({"w": torch.tensor([0.5, -1.0])}, state,
                                  params)
    g = np.asarray([0.5, -1.0])
    m = 0.1 * g / (1 - 0.9)
    v = 0.001 * g ** 2 / (1 - 0.999)
    exp = np.asarray([1.0, 2.0]) - 0.1 * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), exp, rtol=1e-5)
    assert new_state["step"].dtype == torch.int32
    assert new_state["step"].shape == () and int(new_state["step"]) == 1
    assert torch.equal(params["w"], torch.tensor([1.0, 2.0]))  # not in place


def test_grad_clipping():
    g = {"a": torch.tensor([300.0, 400.0])}        # norm 500
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(500.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-5)


def test_int8_compression_error_feedback():
    """Quantize -> dequantize error is bounded by half a step; the int8
    images and scale equal the JAX package's."""
    xn = np.random.default_rng(0).normal(size=(100,)).astype(np.float32)
    x = torch.from_numpy(xn)
    q, scale = optim.quantize_int8(x)
    assert q.dtype == torch.int8
    deq = optim.dequantize_int8(q, scale)
    err = (deq - x).abs().numpy()
    assert err.max() <= float(scale) * 0.5 + 1e-6   # round-to-nearest bound
    jq, jscale = joptim.quantize_int8(jnp.asarray(xn))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == pytest.approx(float(jscale), rel=1e-7)


def test_warmup_cosine_schedule():
    sched = optim.warmup_cosine(1.0, 10, 100, final_frac=0.1)
    assert float(sched(0)) == pytest.approx(0.0)
    assert float(sched(10)) == pytest.approx(1.0, abs=0.01)
    assert float(sched(100)) == pytest.approx(0.1, abs=0.01)
    assert float(sched(55)) < 1.0
    jsched = joptim.warmup_cosine(1.0, 10, 100, final_frac=0.1)
    for s in (0, 1, 5, 10, 11, 37, 55, 99, 100, 150):
        assert float(sched(torch.tensor(s, dtype=torch.int32))) \
            == pytest.approx(float(jsched(s)), abs=1e-6), s


def test_trainer_runs_and_checkpoints(tmp_path):
    cfg = TrainerConfig(total_steps=25, ckpt_every=10,
                        ckpt_dir=str(tmp_path / "ck"), log_every=5)
    tr = Trainer(cfg, loss_fn, optim.adamw(5e-2), init_params(), batch_for)
    hist = tr.run()
    assert tr.step == 25
    assert ckpt.list_steps(cfg.ckpt_dir) == [10, 20, 25]
    assert hist[-1][1]["loss"] < hist[0][1]["loss"]


def test_trainer_restart_resumes_exactly(tmp_path):
    """Kill-and-restart gives bit-identical params to an uninterrupted run
    (params, optimizer state and step restored)."""
    ckdir = str(tmp_path / "ck")
    ref = Trainer(TrainerConfig(total_steps=30, ckpt_every=10,
                                ckpt_dir=str(tmp_path / "ref"),
                                async_save=False),
                  loss_fn, optim.adamw(5e-2), init_params(), batch_for)
    ref.run()
    t1 = Trainer(TrainerConfig(total_steps=20, ckpt_every=10, ckpt_dir=ckdir,
                               async_save=False),
                 loss_fn, optim.adamw(5e-2), init_params(), batch_for)
    t1.run()
    t2 = Trainer(TrainerConfig(total_steps=30, ckpt_every=10, ckpt_dir=ckdir,
                               async_save=False),
                 loss_fn, optim.adamw(5e-2), init_params(seed=999),
                 batch_for)                  # wrong init: must be ignored
    assert t2.step == 20
    assert int(t2.opt_state["step"]) == 20
    t2.run()
    assert torch.equal(t2.params["w"], ref.params["w"])


def test_grad_accum_matches_large_batch():
    """grad_accum=4 over a 64-batch == one 64-batch step (linear model)."""
    opt = optim.adamw(1e-2, max_grad_norm=None)
    params = init_params()
    batch = batch_for(0, n=64)
    p1, _, m1 = make_train_step(loss_fn, opt)(params, opt.init(params),
                                              batch)
    p4, _, m4 = make_train_step(loss_fn, opt, grad_accum=4)(
        params, opt.init(params), batch)
    np.testing.assert_allclose(p1["w"].numpy(), p4["w"].numpy(), rtol=1e-5)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    # aux is the last microbatch's, as the reference's lax.scan gives it
    last = {k: v[48:] for k, v in batch.items()}
    assert float(m4["mse"]) == pytest.approx(
        float(loss_fn(params, last)[0]), rel=1e-6)


def test_grad_accum_step_matches_jax():
    """The port's accumulating step against ``repro.train.trainer.
    make_train_step`` on the same params and batch: params within 1e-6,
    the metrics (a loss of ~25, where an f32 ulp is 2e-6) within 1e-6
    relative."""
    opt, jopt = optim.adamw(1e-2), joptim.adamw(1e-2)
    params = init_params(4)
    batch = batch_for(2, n=32)

    def jloss(p, b):
        loss = jnp.mean(jnp.square(b["x"] @ p["w"] - b["y"]))
        return loss, {"mse": loss}

    jp = {"w": jnp.asarray(params["w"].numpy())}
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jp2, _, jm = jax.jit(jmake_train_step(jloss, jopt, grad_accum=4))(
        jp, jopt.init(jp), jb)
    tp2, _, tm = make_train_step(loss_fn, opt, grad_accum=4)(
        params, opt.init(params), batch)
    np.testing.assert_allclose(tp2["w"].numpy(), np.asarray(jp2["w"]),
                               atol=1e-6)
    for key in ("loss", "mse"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)


# ---------------------------------------------------------------------------
# One optimizer update against the JAX package's, within 1e-6
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                      "b": rng.normal(size=(5,)).astype(np.float32)},
            "stack": rng.normal(size=(2, 3, 4)).astype(np.float32)}


_OPTIMIZERS = {
    "adamw": lambda m: m.adamw(3e-2),
    "adamw_schedule_noclip": lambda m: m.adamw(
        m.warmup_cosine(1e-2, 2, 10), weight_decay=0.1, max_grad_norm=None),
    "adafactor": lambda m: m.adafactor(5e-2, weight_decay=0.01),
    "compressed": lambda m: m.compressed(m.adamw(3e-2)),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_update_matches_jax(name):
    """Three updates from the same params and gradients: new params and
    every state leaf within 1e-6 of the JAX package's."""
    params = _tree(0)
    jopt, topt = _OPTIMIZERS[name](joptim), _OPTIMIZERS[name](optim)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = pytree.tree_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        grads = _tree(10 + i)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                             jp)
        tp, ts = topt.update(pytree.tree_map(torch.from_numpy, grads), ts,
                             tp)
    jleaves = jax.tree_util.tree_leaves({"p": jp, "s": js})
    tleaves = pytree.tree_leaves({"p": tp, "s": ts})
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        a = np.asarray(a)
        assert b.shape == a.shape and str(b.dtype)[6:] == str(a.dtype)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)


def test_global_norm_and_clip_match_jax():
    g = _tree(3)
    jclipped, jnorm = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 0.5)
    tclipped, tnorm = optim.clip_by_global_norm(
        pytree.tree_map(torch.from_numpy, g), 0.5)
    assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jclipped),
                    pytree.tree_leaves(tclipped)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7)


# ---------------------------------------------------------------------------
# contrastive_loss and its gradients on the smoke dr-bert, within 1e-5
# ---------------------------------------------------------------------------

BATCH = 6


def _specs():
    jcfg = dataclasses.replace(jcfg_mod.smoke_config(),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tcfg_mod.smoke_config(),
                               compute_dtype=torch.float32)
    jspec = jbienc.biencoder_spec(jcfg, q_max_len=12, p_max_len=28)
    tspec = tbienc.biencoder_spec(tcfg, q_max_len=12, p_max_len=28,
                                  device="cpu")
    return jcfg, tcfg, jspec, tspec


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg, jspec, tspec = _specs()
    ds = tcorpus.synthetic_retrieval_dataset(0, n_passages=80, n_queries=16,
                                             vocab=tcfg.vocab_size)
    tree = ttfm.init_numpy(tcfg, 3)
    return {"jspec": jspec, "tspec": tspec, "ds": ds, "tree": tree}


def test_contrastive_batches_match_reference(smoke):
    from repro.launch.train import _contrastive_batches as jbatches
    jb = jbatches(smoke["ds"], smoke["jspec"], BATCH)
    tb = tlaunch._contrastive_batches(smoke["ds"], smoke["tspec"], BATCH)
    for step in (0, 7):
        a, b = jb(step), tb(step)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]))


def test_contrastive_loss_and_grads_match_jax(smoke):
    from repro.launch.train import _contrastive_batches as jbatches
    batch = jbatches(smoke["ds"], smoke["jspec"], BATCH)(3)
    jp = jax.tree_util.tree_map(jnp.asarray, smoke["tree"])
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jbienc.contrastive_loss(p, smoke["jspec"], batch),
        has_aux=True)(jp)
    leaves, treedef = pytree.tree_flatten(
        ttfm.params_from_numpy(smoke["tree"]))
    xs = [x.requires_grad_(True) for x in leaves]
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss, taux = tbienc.contrastive_loss(treedef.unflatten(xs),
                                          smoke["tspec"], tbatch)
    grads = torch.autograd.grad(tloss, xs, allow_unused=True)
    tloss = tloss.detach()
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    assert float(taux["contrastive_acc"]) == float(jaux["contrastive_acc"])
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        got = np.zeros_like(jg) if g is None else g.numpy()
        np.testing.assert_allclose(got, jg, rtol=0, atol=1e-5)


def _loss_history(trainer):
    return [m["loss"] for _, m in trainer.run()]


def test_trainer_loss_sequence_matches_jax(smoke, tmp_path):
    """Ten steps of each package's ``Trainer`` (AdamW, the reference
    launcher's batches) from the same initial params: losses within 1e-4."""
    from repro.launch.train import _contrastive_batches as jbatches
    jtr = JTrainer(JTrainerConfig(total_steps=10, ckpt_every=100,
                                  log_every=1),
                   lambda p, b: jbienc.contrastive_loss(p, smoke["jspec"], b),
                   joptim.adamw(2e-3),
                   jax.tree_util.tree_map(jnp.asarray, smoke["tree"]),
                   jbatches(smoke["ds"], smoke["jspec"], BATCH))
    ttr = Trainer(TrainerConfig(total_steps=10, ckpt_every=100, log_every=1),
                  lambda p, b: tbienc.contrastive_loss(p, smoke["tspec"], b),
                  optim.adamw(2e-3), ttfm.params_from_numpy(smoke["tree"]),
                  tlaunch._contrastive_batches(smoke["ds"], smoke["tspec"],
                                               BATCH))
    want, got = _loss_history(jtr), _loss_history(ttr)
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# Checkpoints across packages
# ---------------------------------------------------------------------------

_TREES = {
    "trainer": lambda: {"params": {"w": np.ones((2, 3), np.float32),
                                   "b": np.zeros((3,), np.float32)},
                        "opt_state": {"m": {"w": 0, "b": 0}, "step": 0,
                                      "v": {"w": 0, "b": 0}}},
    "empty_dict": lambda: {},
    "nested_list_tuple": lambda: [1, (2, [3, (4,)], ()), []],
    "none_leaves": lambda: {"a": None, "b": [None, 1], "c": (None,)},
    "leaf": lambda: 1.5,
    "shared_keys": lambda: {"a": {"a": {"a": 1}}, "b": {"a": 2}},
    "many_keys": lambda: {f"k{i:03d}": list(range(i % 4)) for i in range(150)},
}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_treedef_bytes_equal_jax(name):
    tree = _TREES[name]()
    want = jax.tree_util.tree_structure(tree).serialize_using_proto()
    assert ckpt.treedef_proto(tree) == want
    # the decoder reads back each leaf's path in tree_flatten order
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert ckpt.treedef_keypaths(ckpt.treedef_proto(tree)) == paths
    assert [p for p, _ in pytree.tree_flatten_with_path(tree)] == paths
    # the port's flatten: jax's leaves in jax's order, and back
    leaves, treedef = pytree.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert treedef.unflatten(leaves) == jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), leaves)
    assert treedef.flatten_up_to(tree) == leaves


def test_treedef_rejects_other_node_kinds():
    import collections
    with pytest.raises(TypeError):
        ckpt.treedef_proto(collections.OrderedDict(a=1))
    with pytest.raises(ValueError, match="strings"):
        ckpt.treedef_proto({1: 2})
    _, treedef = pytree.tree_flatten({"a": [1, 2], "b": 3})
    with pytest.raises(ValueError, match="keys differ"):
        treedef.flatten_up_to({"a": [1, 2], "c": 3})
    with pytest.raises(ValueError, match="lengths differ"):
        treedef.flatten_up_to({"a": [1], "b": 3})
    with pytest.raises(ValueError, match="too few"):
        treedef.unflatten([1, 2])


def test_reference_restore_reads_port_save(tmp_path):
    """``repro.ckpt.restore`` reads a port save: the trainer's tree with the
    AdamW step as a 0-d int32 leaf, a bf16 leaf, a list and a None."""
    opt = optim.adamw(1e-3)
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "e": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    state = {"params": params, "opt_state": opt.init(params),
             "extra": [torch.ones(2, dtype=torch.int64), None]}
    ckpt.save(str(tmp_path), 4, state, extra={"step": 4})
    tree, extra = jckpt.restore(str(tmp_path), 4)
    assert extra == {"step": 4}
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, state))
    step = tree["opt_state"]["step"]
    assert step.shape == () and step.dtype == np.int32 and int(step) == 0
    assert str(tree["params"]["e"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(tree["params"]["e"], np.float32), [1.5, -2.25])
    np.testing.assert_array_equal(tree["params"]["w"], params["w"].numpy())
    assert tree["extra"][1] is None


def _port_trainer(smoke, ckdir, total, async_save=True):
    return Trainer(TrainerConfig(total_steps=total, ckpt_every=3,
                                 ckpt_dir=ckdir, log_every=1,
                                 async_save=async_save),
                   lambda p, b: tbienc.contrastive_loss(p, smoke["tspec"], b),
                   optim.adamw(2e-3), ttfm.params_from_numpy(smoke["tree"]),
                   tlaunch._contrastive_batches(smoke["ds"], smoke["tspec"],
                                                BATCH))


def _jax_trainer(smoke, ckdir, total):
    from repro.launch.train import _contrastive_batches as jbatches
    return JTrainer(JTrainerConfig(total_steps=total, ckpt_every=3,
                                   ckpt_dir=ckdir, log_every=1),
                    lambda p, b: jbienc.contrastive_loss(p, smoke["jspec"],
                                                         b),
                    joptim.adamw(2e-3),
                    jax.tree_util.tree_map(jnp.asarray, smoke["tree"]),
                    jbatches(smoke["ds"], smoke["jspec"], BATCH))


def test_reference_trainer_resumes_from_port_checkpoint(smoke, tmp_path):
    """The port trains 3 steps and saves; the reference ``Trainer`` resumes
    from that checkpoint and its next 3 losses match an uninterrupted port
    run within 1e-4."""
    whole = _loss_history(_port_trainer(smoke, str(tmp_path / "whole"), 6))
    ckdir = str(tmp_path / "ck")
    _loss_history(_port_trainer(smoke, ckdir, 3))
    jtr = _jax_trainer(smoke, ckdir, 6)
    assert jtr.step == 3 and int(jtr.opt_state["step"]) == 3
    np.testing.assert_allclose(_loss_history(jtr), whole[3:], rtol=1e-4)


def test_port_trainer_resumes_from_reference_checkpoint(smoke, tmp_path):
    whole = _loss_history(_jax_trainer(smoke, str(tmp_path / "whole"), 6))
    ckdir = str(tmp_path / "ck")
    _loss_history(_jax_trainer(smoke, ckdir, 3))
    ttr = _port_trainer(smoke, ckdir, 6)
    assert ttr.step == 3
    assert ttr.opt_state["step"].dtype == torch.int32
    assert int(ttr.opt_state["step"]) == 3
    np.testing.assert_allclose(_loss_history(ttr), whole[3:], rtol=1e-4)


def test_trainer_unported_options_raise(tmp_path):
    """``stop_file`` and ``snapshots`` (once not ported) now work: a
    present STOP marker halts the trainer before its first step, and each
    save publishes the params to the snapshot channel and marks the step
    durable."""
    from repro_torch.control import write_stop_marker
    from repro_torch.handoff import SnapshotChannel
    stop = str(tmp_path / "STOP")
    write_stop_marker(stop, {"reason": "test", "step": 0})
    tr = Trainer(TrainerConfig(total_steps=4, stop_file=stop), loss_fn,
                 optim.adamw(1e-2), init_params(), batch_for)
    assert tr.run() == [] and tr.stopped_early and tr.step == 0
    assert tr.stop_verdict == {"reason": "test", "step": 0}
    ch = SnapshotChannel(capacity=4)
    tr = Trainer(TrainerConfig(total_steps=4, ckpt_every=2, log_every=2,
                               ckpt_dir=str(tmp_path / "ck"), snapshots=ch),
                 loss_fn, optim.adamw(1e-2), init_params(), batch_for)
    tr.run()
    assert ch.pending() == [2, 4] and ch.is_durable(2) and ch.is_durable(4)
    assert pytree.tree_map(lambda t: tuple(t.shape),
                           ch.get(4).state()["params"]) == \
        pytree.tree_map(lambda t: tuple(t.shape), tr.params)


# ---------------------------------------------------------------------------
# AsyncSaver (tests/test_ckpt.py::test_async_saver_overlap_and_error_surfacing)
# ---------------------------------------------------------------------------


def _small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "b": {"c": torch.arange(5, dtype=torch.int32)}}


def test_async_saver_overlap_and_error_surfacing(tmp_path):
    root = str(tmp_path / "ck")
    saver = ckpt.AsyncSaver()
    saver.save(root, 1, _small_tree())
    saver.save(root, 2, _small_tree())           # waits for #1 internally
    saver.wait()
    assert ckpt.list_steps(root) == [1, 2]
    # an invalid path's error surfaces on the next wait, not swallowed
    saver.save("/proc/definitely/not/writable", 3, _small_tree())
    with pytest.raises(BaseException):
        saver.wait()
    saver.wait()                                 # reported once


def test_async_saver_hooks_and_reference_restore(tmp_path):
    root = str(tmp_path / "ck")
    seen = []
    saver = ckpt.AsyncSaver()
    tree = _small_tree(1)
    saver.save(root, 7, tree, {"step": 7},
               on_host_copy=lambda s, t: seen.append(("host", s)),
               on_durable=lambda s: seen.append(("durable", s)))
    saver.wait()
    assert seen == [("host", 7), ("durable", 7)]
    got, extra = jckpt.restore(root, 7)
    assert extra == {"step": 7}
    np.testing.assert_array_equal(got["a"], tree["a"].numpy())
    np.testing.assert_array_equal(got["b"]["c"], tree["b"]["c"].numpy())
    failed = []
    saver.save("/proc/definitely/not/writable", 8, tree,
               on_failure=lambda s, e: failed.append(s))
    with pytest.raises(BaseException):
        saver.wait()
    assert failed == [8]


# ---------------------------------------------------------------------------
# launch.train on the CPU: Fig. 1a and Fig. 1b
# ---------------------------------------------------------------------------


def _launch_args(workdir, sync, **kw):
    args = ["--device", "cpu", "--workdir", str(workdir), "--steps", "20",
            "--ckpt-every", "5", "--corpus-size", "120", "--n-queries", "12"]
    if sync:
        args.append("--sync")
    for key, value in kw.items():
        args += [f"--{key.replace('_', '-')}", str(value)]
    return args


def _ledger_rows(workdir):
    with open(os.path.join(workdir, "ledger.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_launch_train_sync_and_async_validate_every_checkpoint(tmp_path):
    """Each mode validates every checkpoint exactly once; the ledgers'
    metrics are equal between the modes (same init, same batches)."""
    out = {}
    for mode in ("sync", "async"):
        res = tlaunch.main(_launch_args(tmp_path / mode, mode == "sync"))
        assert res["mode"] == mode and not res["errors"]
        rows = _ledger_rows(tmp_path / mode)
        assert [r["step"] for r in rows] == [5, 10, 15, 20]
        assert res["validated_steps"] == [5, 10, 15, 20]
        assert ckpt.list_steps(str(tmp_path / mode / "ckpts")) == \
            [5, 10, 15, 20]
        out[mode] = rows
        with open(tmp_path / mode / "summary.json") as f:
            assert json.load(f)["mode"] == mode
    for a, b in zip(out["sync"], out["async"]):
        assert a["metrics"] == b["metrics"]
        assert set(a) == set(b)
    # the reference reads the port trainer's checkpoints
    tree, extra = jckpt.restore(str(tmp_path / "async" / "ckpts"), 20)
    assert set(tree) == {"params", "opt_state"} and extra["step"] == 20


@pytest.mark.parametrize("flag,value", [
    ("early_stop_patience", 2), ("overfit_window", 3), ("keep_top_k", 2),
    ("ensemble_top_k", 2), ("handoff_spool", "x")])
def test_launch_train_unported_flags_raise(tmp_path, flag, value):
    """The control plane's and the hand-off's flags (once not ported) now
    run: every checkpoint is validated, and each flag does what the
    reference's does."""
    # three checkpoints: steps 5, 10, 15
    args = _launch_args(tmp_path, False, steps=15)
    if flag == "handoff_spool":
        args += ["--handoff", "--handoff-spool", str(tmp_path / value)]
    else:
        args += [f"--{flag.replace('_', '-')}", str(value)]
    res = tlaunch.main(args)
    assert not res["errors"]
    steps = [r["step"] for r in _ledger_rows(tmp_path)]
    control = flag in ("early_stop_patience", "keep_top_k", "ensemble_top_k")
    assert os.path.exists(tmp_path / "control.jsonl") == control
    if flag == "early_stop_patience" and res["stopped_early"]:
        assert res["stop_verdict"]["reason"] == "plateau"
    if not res["stopped_early"]:
        assert steps[:3] == [5, 10, 15]
    if flag == "keep_top_k":
        assert len(res["kept_checkpoints"]) == value
    if flag == "ensemble_top_k":
        assert res["ensemble"]["step"] == steps[-1] == 16
    if flag == "handoff_spool":
        # the spool mirrored the ring; validated + durable snapshots retired
        assert os.path.isdir(tmp_path / value)
        assert not [n for n in os.listdir(tmp_path / value)
                    if n.startswith("snap_")]


def test_launch_train_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default then runs there")
    args = _launch_args(tmp_path, False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tlaunch.main(args[2:])
