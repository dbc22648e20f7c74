"""One module per trunk type (``bench/models/<model_type>.py``): the
layouts, FLOP counts, seeded weights and reference outputs that the
modules give are pinned to the numbers the benchmark gave before they
were split out, and a new trunk enters as a new file alone."""

import hashlib
import shutil

import pytest
import torch

from bench import gen, harness, models, roofline, weights
from bench.reference import encoders
from bench.tests.small import run_small, small_config

SEED = 2 ** 31 + 5

#: n_params, leaves, encoder_flops at 9 / 72 / 128 tokens
PINS = {
    "dr-bert-base": (132_321_792, 20, (1_531_809_792, 12_421_693_440,
                                       22_347_251_712)),
    "qwen2-0.5b-dr": (494_032_768, 14, (6_444_748_800, 51_753_074_688,
                                        92_313_747_456)),
}

#: sha256 at the module's SMALL size: every leaf of weights.draw in
#: layout order, and encoders.encode in f32 and in fp8
DIGESTS = {
    "dr-bert-base": {
        "draw": "bea653636eb92b152e8f4c9558613c46"
                "1aa187be65d0b40c00be7927c11d1bd9",
        "f32": "a5b74a295663ea648e2f2cb859d743de"
               "823a5391016ea081e01d27d8ecba9c6e",
        "fp8": "94f61bf152d0e75d1da29a668e3c9395"
               "a1f0920650256f9370c8b75e60fe9fd1"},
    "qwen2-0.5b-dr": {
        "draw": "26743aabefe1bcf398db015218097b71"
                "497a7ec2adcdd5cee3467c6887358e8b",
        "f32": "3345eb41809cd21fcdb786bbf2560c58"
               "95c4f2e960585933b5642f257b588912",
        "fp8": "df3f8b3a799ecf82aaf3d09d6b7992a2"
               "47240301e9c5ca000e11ed1c5f3502d8"},
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINS))
def test_layout_and_flops_are_pinned(name):
    cfg = harness.config(name)
    n_params, n_leaves, flops = PINS[name]
    assert weights.n_params(cfg) == n_params
    assert len(models.of(cfg).layout(cfg)) == n_leaves
    assert tuple(roofline.encoder_flops(cfg, n) for n in (9, 72, 128)) \
        == flops


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_draw_and_reference_are_bit_identical(name):
    cfg = small_config(name)
    W = weights.draw(cfg, SEED, 1, "cpu")
    assert list(W) == [p for p, _, _ in models.of(cfg).layout(cfg)]
    assert _digest(W.values()) == DIGESTS[name]["draw"]
    texts = gen.token_lists(gen.rng(SEED, 9),
                            [3, 40, 7, 16, 1, 48, 22, 9, 5, 31],
                            cfg["vocab_size"])
    for precision in ("f32", "fp8"):
        e = encoders.encode(cfg, W, texts, 48, precision=precision,
                            batch_tokens=96)
        assert _digest([e]) == DIGESTS[name][precision], precision


@pytest.mark.parametrize("name", sorted(PINS))
def test_a_module_holds_its_type(name):
    mod = models.of(harness.config(name))
    cfg = small_config(name)
    leaves = {p: kind for p, _, kind in mod.layout(cfg)}
    assert set(mod.MATRICES) <= {p for p, k in leaves.items()
                                 if k == "matrix"}
    assert set(mod.port_fields(cfg)) >= {"n_layers", "d_model", "vocab_size"}
    assert mod.flops(cfg, 5) > 0


def test_an_unknown_type_names_the_missing_file():
    cfg = dict(harness.config("qwen2-0.5b-dr"), model_type="no-such-trunk")
    with pytest.raises(SystemExit, match="bench/models/no-such-trunk.py"):
        models.of(cfg)
    with pytest.raises(SystemExit, match="no-such-trunk"):
        harness.run_cell(harness.load_benchmark(),
                         "qwen2-0.5b-dr.validate-msmarco", seed=1,
                         seconds=1.0, trace=False, device="cpu",
                         t_start=0.0, cfg=cfg)


def test_a_new_trunk_enters_as_a_new_file(tmp_path, monkeypatch):
    """A copy of qwen2.py under another type name, in a directory of its
    own, runs the small validate cell with no file of bench/ edited."""
    shutil.copy(models.path("qwen2"), tmp_path / "qwen2copy.py")
    cell = "qwen2-0.5b-dr.validate-msmarco"
    plain = run_small(cell, seed=9)
    cfg = dict(small_config("qwen2-0.5b-dr"), model_type="qwen2copy")
    monkeypatch.setattr(models, "DIR", str(tmp_path))
    res = run_small(cell, seed=9, cfg=cfg)
    assert models.of(cfg).__file__ == str(tmp_path / "qwen2copy.py")
    assert res["correct"], res["checks"]
    assert res["readings"] == plain["readings"]
