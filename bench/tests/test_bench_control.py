"""The control: the reference put in the program's place with fp8 weight
products, the precision below the configurations' bf16 trunks.

On the CPU, at a size a test holds, the control reads at least three
times what the program reads on the same inputs.  On the card
(``-m chip``), at each cell's own size, it fails the cell's limits on
three seeds."""

import pytest

from bench import harness, judge
from bench.tests.small import run_small, small_cell

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_well_above_the_program_at_a_small_size(cell):
    cfg, mix = small_cell(cell)
    ctl = harness.driver(mix["kind"]).control(cfg=cfg, mix=mix, seed=21,
                                              device="cpu", seconds=1.0)
    prog = run_small(cell, seed=21)["readings"]
    assert ctl["score_err"] >= 3 * prog["score_err"], (ctl, prog)
    assert ctl["malformed"] == 0


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_at_its_own_size(cell, chip):
    bm = harness.load_benchmark()
    w = harness.workload(bm, cell)
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    for seed in (31, 32, 33):
        readings = harness.driver(mix["kind"]).control(
            cfg=cfg, mix=mix, seed=seed, device=chip,
            seconds=bm["run_seconds"])
        correct, checks = judge.decide(readings, harness.limits(cell))
        assert not correct, (seed, checks)
