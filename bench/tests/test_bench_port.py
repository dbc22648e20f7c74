"""A configuration file may cut its trunk's depth, and nothing else:
``bench/port.py`` checks the port's full config against the published
sizes and builds the cut trunk, which the port restores and the
reference runs; every other cut, or a cut out of range, stops the run
before a weight is drawn."""

import dataclasses
import shutil

import pytest

from bench import harness, models, port, weights
from bench.tests.small import run_small, shrink, smoke_port

CELL = "qwen2-0.5b-dr.validate-msmarco"

#: a trunk module for the port's deepseek-v2-lite-16b, as far as the check
#: of its sizes reads it
DSV2 = '''
def port_fields(cfg):
    return {"n_layers": cfg["num_hidden_layers"],
            "d_model": cfg["hidden_size"],
            "first_k_dense": cfg["first_k_dense_replace"],
            "moe_num_experts": cfg["n_routed_experts"], "mla": True}
'''


def _qwen2(**over) -> dict:
    return dict(harness.config("qwen2-0.5b-dr"), **over)


def _dsv2(tmp_path, monkeypatch, cut: int) -> dict:
    """The port's deepseek-v2-lite-16b smoke sizes (3 layers, the first
    dense), cut to ``cut`` layers."""
    (tmp_path / "dsv2stub.py").write_text(DSV2)
    monkeypatch.setattr(models, "DIR", str(tmp_path))
    return {"model_type": "dsv2stub", "num_hidden_layers": cut,
            "hidden_size": 64, "first_k_dense_replace": 1,
            "n_routed_experts": 8, "published": {"num_hidden_layers": 3},
            "retriever": {"port_arch": "deepseek-v2-lite-16b",
                          "compute_dtype": "bfloat16"}}


def _fields(tcfg) -> dict:
    return {f.name: getattr(tcfg, f.name)
            for f in dataclasses.fields(tcfg)}


def test_a_cut_trunk_enters_as_new_files(tmp_path, monkeypatch):
    """A copy of qwen2.py under another type name, with a file that cuts
    2 published layers to 1 at the small size, runs the small validate
    cell correct: the port restores the 1-layer trunk and the reference
    runs it.  No file of bench/ is edited."""
    shutil.copy(models.path("qwen2"), tmp_path / "qwen2cut.py")
    monkeypatch.setattr(models, "DIR", str(tmp_path))
    uncut = shrink(_qwen2(model_type="qwen2cut"))
    cfg = shrink(_qwen2(model_type="qwen2cut", num_hidden_layers=5,
                        published={"num_hidden_layers": 24}))
    assert (cfg["num_hidden_layers"], cfg["published"]) == \
        (1, {"num_hidden_layers": 2})
    with smoke_port():
        assert port.transformer_config(cfg).n_layers == 1
        assert port.transformer_config(uncut).n_layers == 2
    stacked = [shape for p, shape, _ in models.of(cfg).layout(cfg)
               if p.startswith("dense_layers/")]
    assert stacked and all(shape[0] == 1 for shape in stacked)
    assert weights.n_params(cfg) < weights.n_params(uncut)

    from repro_torch.ckpt import checkpoint as ckpt
    restored, ran = [], []
    restore, trunk = ckpt.restore, models.of(cfg).trunk

    def spy_restore(*a, **kw):
        state, extra = restore(*a, **kw)
        restored.append(state["params"]["dense_layers"]["attn"]["wq"]
                        .shape[0])
        return state, extra

    def spy_trunk(c, W, *a, **kw):
        ran.append(W["dense_layers/attn/wq"].shape[0])
        return trunk(c, W, *a, **kw)

    monkeypatch.setattr(ckpt, "restore", spy_restore)
    monkeypatch.setattr(models.of(cfg), "trunk", spy_trunk)
    res = run_small(CELL, seed=9, cfg=cfg)
    assert res["correct"], res["checks"]
    assert restored and set(restored) == {1}
    assert ran and set(ran) == {1}


def test_a_published_depth_the_port_does_not_build_stops():
    cfg = _qwen2(published={"num_hidden_layers": 26})
    with pytest.raises(SystemExit, match=r"'n_layers': \(24, 26\)"):
        port.transformer_config(cfg)


@pytest.mark.parametrize("key,value", [("hidden_size", 1024),
                                       ("vocab_size", 151936)])
def test_a_width_in_published_stops(key, value):
    cfg = _qwen2(published={key: value})
    with pytest.raises(SystemExit, match=f"{key}.*no width is cut"):
        port.transformer_config(cfg)


@pytest.mark.parametrize("cut", [24, 25, 0, -1])
def test_a_cut_out_of_range_stops(cut):
    cfg = _qwen2(num_hidden_layers=cut, published={"num_hidden_layers": 24})
    with pytest.raises(SystemExit,
                       match=rf"num_hidden_layers = {cut} .* 1 <= cut < 24"):
        port.transformer_config(cfg)


def test_a_cut_that_empties_the_moe_layers_stops(tmp_path, monkeypatch):
    with smoke_port():
        with pytest.raises(SystemExit, match="above first_k_dense = 1"):
            port.transformer_config(_dsv2(tmp_path, monkeypatch, 1))
        tcfg = port.transformer_config(_dsv2(tmp_path, monkeypatch, 2))
    assert (tcfg.n_layers, tcfg.first_k_dense) == (2, 1)


def test_a_refusal_comes_before_any_weight(monkeypatch):
    """A small run of a file with a width in published stops in the
    port's check, before set-up draws a weight."""
    def draw(*a, **kw):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(weights, "draw", draw)
    cfg = shrink(_qwen2())
    cfg["published"] = {"hidden_size": cfg["hidden_size"] * 2}
    with pytest.raises(SystemExit, match="hidden_size"):
        run_small(CELL, seed=3, cfg=cfg)


@pytest.mark.parametrize("name", ["dr-bert-base", "qwen2-0.5b-dr"])
def test_an_uncut_file_gets_the_ports_full_config(name, monkeypatch):
    cfg = harness.config(name)
    assert "published" not in cfg
    assert _fields(port.transformer_config(cfg)) == \
        _fields(port.port_config(cfg))
    full = port.port_config(cfg)
    monkeypatch.setattr(port, "port_config", lambda c: full)
    assert port.transformer_config(cfg) is full


def test_shrink_names_a_small_depth_that_leaves_no_cut(tmp_path,
                                                       monkeypatch):
    """A module whose SMALL depth leaves no layer to cut after the
    port's leading dense ones stops in shrink, naming that module."""
    cfg = dict(_dsv2(tmp_path, monkeypatch, 5), model_type="dsv2small")
    (tmp_path / "dsv2small.py").write_text(
        DSV2 + "\nSMALL = dict(num_hidden_layers=2, hidden_size=64)\n")
    with pytest.raises(AssertionError, match=r"dsv2small\.py's SMALL"):
        shrink(cfg)
