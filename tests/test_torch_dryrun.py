"""The port's dry run and roofline analysis against the JAX package's
(``repro_torch.launch.dryrun`` / ``analysis``).

The analysis functions (``_wire_bytes``, ``Measurement.combine`` /
``delta``, ``extrapolate``, ``roofline``) take the same numbers as the
reference's, and the port's :class:`HardwareModel` is given the
reference's own ``PEAK_FLOPS`` / ``HBM_BW`` / ``ICI_BW`` here, read from
``repro.launch.analysis`` (the port holds no TPU number).  The dry run
runs on the meta device with ``--device cpu``: each record is ``ok`` and
its ``meta`` is the reference's ``build_step`` meta (dumped by a
subprocess with 512 forced host devices), and the process's peak RSS
grows by under 1 GB, so nothing full-size was allocated.
"""

import json
import os
import resource
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.launch import analysis as janalysis
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step

CELLS = [("qwen2-0.5b", "decode_32k"), ("deepseek-v2-lite-16b", "train_4k"),
         ("graphcast", "molecule"), ("deepfm", "serve_p99"),
         ("dr-bert-base", "encode_corpus")]
REF_KEYS = ("arch", "shape", "ok", "tag", "knobs", "timings", "meta",
            "memory", "full_raw", "per_device", "roofline",
            "collectives_1layer")

_META = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_step
    mesh = make_production_mesh()
    out = {f"{a}/{s}": build_step(a, s, mesh).meta
           for a, s in json.loads(sys.argv[2])}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def reference_meta(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_ref") / "meta.json"
    subprocess.run([sys.executable, "-c", _META, str(path),
                    json.dumps(CELLS)], check=True, timeout=600,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun_torch"))


def _ref_hw():
    return analysis.HardwareModel(
        name="reference constants", peak_flops=janalysis.PEAK_FLOPS,
        peak_tf32=janalysis.PEAK_FLOPS, peak_f32=janalysis.PEAK_FLOPS,
        hbm_bw=janalysis.HBM_BW, link_bw=janalysis.ICI_BW)


# ---------------------------------------------------------------------------
# analysis functions against the reference's, on the same numbers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "send"])
def test_wire_bytes_matches_reference(kind):
    for g in (0, 1, 2, 16, 256, 512):
        for rb in (0, 4, 1 << 20, 123456789):
            assert analysis._wire_bytes(kind, rb, g) == \
                janalysis._wire_bytes(kind, rb, g)
    op = analysis.CollectiveOp(kind, 64, 4, 48.0)
    assert op.as_dict() == janalysis.CollectiveOp(kind, 64, 4,
                                                   48.0).as_dict()


def _pair(flops, byts, coll, hbm):
    return (analysis.Measurement(flops, byts, coll, [], hbm),
            janalysis.Measurement(flops, byts, coll, [], hbm))


def _same(m, jm):
    for f in ("flops", "bytes_accessed", "coll_wire_bytes", "hbm_bytes_est"):
        assert getattr(m, f) == getattr(jm, f), f


def test_measurement_combine_delta_extrapolate_match_reference():
    a, ja = _pair(3.5e12, 7.25e9, 1.5e8, 2.5e9)
    b, jb = _pair(4.0e12, 7.0e9, 2.5e8, 3.0e9)
    _same(a.combine(b, 2.5), ja.combine(jb, 2.5))
    _same(analysis.Measurement.delta(b, a),
          janalysis.Measurement.delta(jb, ja))
    _same(analysis.Measurement.delta(a, b),         # clipped at 0
          janalysis.Measurement.delta(ja, jb))
    for n in (0, 1, 2, 24, 95):
        _same(analysis.extrapolate(a, b, n), janalysis.extrapolate(ja, jb, n))
        _same(analysis.extrapolate(a, None, n),
              janalysis.extrapolate(ja, None, n))


def test_measurement_without_collectives_stays_none():
    a = analysis.Measurement(2.0, 3.0, None, [], 1.0, compute_typed_s=0.5)
    b = analysis.Measurement(5.0, 4.0, None, [], 2.0, compute_typed_s=1.5)
    e = analysis.extrapolate(a, b, 4)
    assert e.coll_wire_bytes is None
    assert (e.flops, e.bytes_accessed, e.hbm_bytes_est,
            e.compute_typed_s) == (11.0, 6.0, 4.0, 3.5)


@pytest.mark.parametrize("case", [
    (1e15, 1e9, 1e6, 1e9),          # compute-bound
    (1e9, 1e12, 1e6, 1e12),         # memory-bound
    (1e9, 1e9, 1e12, 1e9),          # collective-bound
    (0.0, 0.0, 0.0, 0.0)],          # empty
    ids=["compute", "memory", "collective", "empty"])
def test_roofline_matches_reference(case):
    flops, byts, coll, hbm = case
    m, jm = _pair(flops, byts, coll, hbm)
    mf = 0.4 * flops
    got = analysis.roofline(m, mf, _ref_hw())
    want = janalysis.roofline(jm, mf)
    assert {k: got[k] for k in want} == want


def test_roofline_without_collectives_picks_compute_or_memory():
    hw = analysis.h100_sxm()
    m = analysis.Measurement(1e12, 5e9, None, [], 4e9)
    r = analysis.roofline(m, 5e11, hw)
    assert r["collective_s"] is None and r["bottleneck"] == "memory"
    assert r["step_time_s"] == r["memory_s"] == 4e9 / hw.hbm_bw
    assert r["compute_s"] == 1e12 / hw.peak_flops


def test_h100_model_is_the_data_sheet():
    hw = analysis.h100_sxm()
    assert (hw.peak_flops, hw.peak_tf32, hw.peak_f32, hw.hbm_bw,
            hw.link_bw) == (989.4e12, 494.7e12, 66.9e12, 3.35e12, 450e9)
    assert hw.peak_for(torch.bfloat16) == hw.peak_flops
    assert hw.peak_for(torch.float32) == hw.peak_f32


def test_measure_counts_a_small_step():
    """measure() on a hand-made step: the product's flops (2 M N K), its
    bytes, the boundary bytes of the product and the sum, the ideal split
    over the world, and per-device bytes from the layouts."""
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.steps import StepSpec
    mesh = make_production_mesh()
    a = torch.empty(256, 64, device="meta")
    b = torch.empty(64, 32, device="meta")
    spec = StepSpec(
        cell="toy", kind="serve",
        fn=lambda x, w: ((x @ w).relu().sum(dim=1),),
        abstract_args=(a, b),
        in_shardings=(NamedSharding(mesh, P("data")), NamedSharding(mesh,
                                                                   P())),
        out_shardings=(NamedSharding(mesh, P(("data", "model"))),),
        donate_argnums=(), meta={})
    m = analysis.measure(spec, 256, analysis.h100_sxm())
    assert m.flops == 2 * 256 * 64 * 32 / 256
    mm = (256 * 64 + 64 * 32 + 256 * 32) * 4
    relu = 2 * 256 * 32 * 4
    total = mm + relu + (256 * 32 + 256) * 4
    assert m.bytes_accessed == total / 256
    assert m.hbm_bytes_est == (256 * 32 + 256) * 4 / 256
    assert m.memory["argument_size_in_bytes"] == (16 * 64 + 64 * 32) * 4
    assert m.memory["output_size_in_bytes"] == 1 * 4
    assert m.coll_wire_bytes is None
    assert m.compute_typed_s == 2 * 256 * 64 * 32 / 66.9e12 / 256


# ---------------------------------------------------------------------------
# the dry run on the meta device
# ---------------------------------------------------------------------------


def _peak_rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_dryrun_cpu_cell(arch, shape, reference_meta, out_dir, capsys):
    before = _peak_rss()
    skip = ["--skip-multipod"] if arch == "deepseek-v2-lite-16b" else []
    assert dryrun.main(["--arch", arch, "--shape", shape, "--device", "cpu",
                        "--out", out_dir] + skip) == 0
    assert _peak_rss() - before < 1e9
    with open(os.path.join(out_dir, f"{arch}__{shape}__baseline.json")) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["split"] == "ideal"
    assert all(key in rec for key in REF_KEYS)
    assert rec["hardware"]["device"] == "cpu"
    assert rec["hardware"]["model"] == "NVIDIA H100 SXM5 80GB"
    want = reference_meta[f"{arch}/{shape}"]
    assert rec["meta"].keys() == want.keys()
    for key, w in want.items():
        assert rec["meta"][key] == pytest.approx(w, rel=1e-12)
    r = rec["roofline"]
    assert r["collective_s"] is None and rec["full_raw"]["coll_wire_bytes"] \
        is None
    assert r["bottleneck"] in ("compute", "memory")
    assert rec["per_device"]["flops"] > 0
    assert ("memory_multipod_per_device" in rec) == (not skip)
    assert "OK" in capsys.readouterr().out


def test_extrapolation_equals_the_direct_count():
    """On a dense LM the cost variants' flops extrapolate exactly to the
    direct full-depth count (every layer is counted on meta)."""
    hw = analysis.h100_sxm()
    mesh = make_production_mesh()
    full, q1, q2 = (analysis.measure(build_step("qwen2-0.5b", "decode_32k",
                                                mesh, variant=v,
                                                cost_layers=n), 256, hw)
                    for v, n in (("full", 1), ("cost", 1), ("cost", 2)))
    ext = analysis.extrapolate(q1, q2, 24)
    assert ext.flops == pytest.approx(full.flops, rel=1e-12)
    assert ext.hbm_bytes_est == pytest.approx(full.hbm_bytes_est, rel=1e-12)
    assert ext.bytes_accessed == pytest.approx(full.bytes_accessed,
                                               rel=1e-9)
    assert q2.flops > q1.flops > 0


def test_report_renders_written_records(out_dir, capsys):
    for arch, shape in CELLS:
        if not os.path.exists(os.path.join(
                out_dir, f"{arch}__{shape}__baseline.json")):
            assert dryrun.main(["--arch", arch, "--shape", shape,
                                "--device", "cpu", "--out", out_dir,
                                "--skip-multipod"]) == 0
    capsys.readouterr()
    assert dryrun.main(["--report", "--out", out_dir]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:8] == ["arch", "shape", "tag", "bound",
                                    "comp_ms", "mem_ms", "memraw_ms",
                                    "coll_ms"]
    rows = [line.split() for line in lines[1:]]
    assert sorted((r[0], r[1]) for r in rows) == sorted(CELLS)
    assert all(r[7] == "-" for r in rows)          # coll_ms
    assert dryrun.main(["--report", "--md", "--out", out_dir]) == 0
    md = capsys.readouterr().out.strip().splitlines()
    assert md[0].startswith("| arch | shape |") and len(md) == 2 + len(CELLS)


def test_all_spawns_a_process_per_cell(tmp_path, capsys):
    out = str(tmp_path / "all")
    assert dryrun.main(["--all", "--filter", "serve_p99", "--device", "cpu",
                        "--skip-multipod", "--jobs", "2", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "[dryrun --all] 4/4 OK" in text
    assert sorted(os.listdir(out)) == sorted(
        f"{a}__serve_p99__baseline.json"
        for a in ("bert4rec", "sasrec", "mind", "deepfm"))


def test_device_cuda_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "deepfm", "--shape", "serve_p99",
                     "--device", "cuda", "--out", out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--all", "--device", "cuda", "--out", out])
    assert not os.listdir(out)                     # no fallback record


def test_device_cuda_checks_the_card(monkeypatch):
    import types
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dryrun, "_smi_name_power",
                        lambda: "NVIDIA X, 700.00 W")

    def props(name, mem):
        return lambda i: types.SimpleNamespace(
            name=name, total_memory=mem, multi_processor_count=132,
            major=9, minor=0)

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        props("NVIDIA A100-SXM4-80GB", 85e9))
    with pytest.raises(RuntimeError, match="not the H100 SXM5 80GB"):
        dryrun.hardware("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        props("NVIDIA H100 NVL", 100e9))
    with pytest.raises(RuntimeError, match="not the H100 SXM5 80GB"):
        dryrun.hardware("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        props("NVIDIA H100 80GB HBM3", 85_029_158_912))
    hw, rec = dryrun.hardware("cuda")
    assert hw == analysis.h100_sxm()
    assert rec["source"] == "card" and rec["nvidia_smi"].endswith("700.00 W")
