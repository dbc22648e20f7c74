"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of each cell's files by name."""

import json
import math
import os
import re

import pytest

from bench import gen, harness, models

BM = harness.load_benchmark()
CELLS = [w["name"] for w in BM["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keys_names_and_units():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"] and 1 <= BM["run_seconds"] <= 51
    names = [c["name"] for c in BM["configs"]] + CELLS + \
        [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(names) == len(set(names))
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["name"] for m in BM["end_to_end"]][0] == "setup_s"
    e2e = {m["name"] for m in BM["end_to_end"]}
    for m in BM["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert "workloads" in m
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"]
                                  for x in harness.end_to_end(BM, cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = harness.workload(BM, cell)
    cfg = harness.config(w["config"])
    mix = harness.traffic(w["traffic"])
    assert os.path.isfile(models.path(cfg["model_type"]))
    assert callable(harness.driver(mix["kind"]).run)
    assert callable(harness.driver(mix["kind"]).control)
    lim = harness.limits(cell)
    assert lim and all(v >= 0 for v in lim.values())
    e2e = [m["name"] for m in harness.end_to_end(BM, cell)]
    assert e2e[0] == "setup_s" and len(e2e) >= 2
    layers = harness.per_layer(BM, cell)
    assert layers
    for m in layers:
        assert harness.reader(m["name"])({}) is None


@pytest.mark.parametrize("name", [c["name"] for c in BM["configs"]])
def test_reduced_lists_the_keys_the_file_cuts(name):
    """What a file cuts (its ``published``) is what ``reduced`` lists."""
    entry = next(c for c in BM["configs"] if c["name"] == name)
    cfg = harness.config(name)
    assert sorted(cfg.get("published", {})) == sorted(entry["reduced"])


@pytest.mark.parametrize("breakdown", [None, {"device_ops": [["k", 1.0]],
                                              "idle_gaps": []}])
def test_result_line_has_the_contract_keys(breakdown):
    line = harness.result_line(
        True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 1}, breakdown,
        {"score_err": {"value": 0.001, "limit": 0.01}})
    d = json.loads(line)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if breakdown else []
    assert list(d) == want + ["checks"]


def test_generator_gives_every_seed_the_same_sizes():
    mix = harness.traffic("validate-msmarco")
    mix.update(n_queries=20, depth=30, relevant_per_query={"1": 18,
                                                           "2": 2})
    a, b = (gen.validation_set(mix, s, 1000) for s in (1, 2 ** 31 + 5))
    assert sorted(map(len, a["corpus"].values())) == \
        sorted(map(len, b["corpus"].values()))
    assert sorted(map(len, a["queries"].values())) == \
        sorted(map(len, b["queries"].values()))
    assert a["queries"] != b["queries"]
    assert gen.validation_set(mix, 1, 1000) == a
    assert len(a["corpus"]) == 600
    assert sorted(len(q) for q in a["qrels"].values()) == [1] * 18 + [2] * 2
    smix = harness.traffic("serve-msmarco")
    s1, s2 = (gen.query_stream(smix, s, 1000, 10.0, 96.0) for s in (3, 4))
    assert len(s1["due"]) == len(s2["due"]) == 960
    assert s1["due"] == sorted(s1["due"]) and s1["due"] == s2["due"]
    assert s1["tokens"] != s2["tokens"]
    assert 0.0 == s1["due"][0] and s1["due"][-1] < 10.0
    assert sorted(map(len, s1["tokens"])) == sorted(map(len, s2["tokens"]))


def test_readers_read_a_context():
    read = {m["name"]: harness.reader(m["name"]) for m in BM["per_layer"]}
    v = {"kind": "validate", "verdict_s": 2.0, "flops_per_verdict": 989e12,
         "verdicts": [{"wall_s": 2.5, "timings": {"total_s": 2.0,
                                                  "encode_corpus_s": 1.5}},
                      {"wall_s": 2.1, "timings": {"total_s": 2.0,
                                                  "encode_corpus_s": 1.7}}],
         "trace": {"busy_s": 3.0, "window_s": 4.0}}
    assert math.isclose(read["restore_s.validate"](v), 0.3)
    assert math.isclose(read["encode_corpus_s.validate"](v), 1.6)
    assert math.isclose(read["device_idle.validate"](v), 25.0)
    assert math.isclose(read["mfu.validate"](v), 50.0)
    s = {"kind": "serve", "occupancy": 0.75, "topk_s": 0.04,
         "topk_bound_s": 0.008, "window_s": 10.0, "flops": 989e12,
         "trace": {"busy_s": 2.0, "window_s": 3.0}}
    assert math.isclose(read["batch_occupancy.serve"](s), 75.0)
    assert math.isclose(read["topk_roofline.serve"](s), 20.0)
    assert math.isclose(read["device_idle.serve"](s), 100.0 / 3)
    assert math.isclose(read["mfu.serve"](s), 10.0)
    assert read["mfu.serve"](v) is None and read["mfu.validate"](s) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_small_run_reads_its_per_layer_metrics(cell):
    from bench.tests.small import run_small
    res = run_small(cell, seed=5, trace=True)
    got = set(res["metrics"])
    want = {m["name"] for m in harness.per_layer(BM, cell)}
    # the CPU has no device trace: the device's idle share stays unread
    assert got == {n for n in want if not n.startswith("device_idle")} \
        - {"topk_roofline.serve"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"]
