"""The benchmark's cells at a size a CPU test holds, through the port's
smoke-size trunks (each trunk module's ``SMALL``), run past the entry
point's look for a chip."""

import copy
import time
from unittest import mock

from bench import harness, models, port


def small_cell(cell: str):
    """(cfg, mix) of ``cell`` at a size a CPU test holds."""
    w = harness.workload(harness.load_benchmark(), cell)
    return small_config(w["config"]), small_mix(w["traffic"])


def small_config(name: str) -> dict:
    return shrink(harness.config(name))


def shrink(cfg: dict) -> dict:
    """A copy of ``cfg`` at its trunk module's ``SMALL`` sizes.  A depth
    cut is carried to that size: published at ``SMALL``'s depth and cut
    to one less, so a cut cell's small runs run a cut trunk."""
    cfg = copy.deepcopy(cfg)
    small = models.of(cfg).SMALL
    cfg.update(small)
    cfg["retriever"].update(q_max_len=16, p_max_len=48)
    if "num_hidden_layers" in cfg.get("published", {}):
        from repro_torch.configs import registry
        dense = registry.get(cfg["retriever"]["port_arch"]) \
            .smoke_config().first_k_dense
        depth = small["num_hidden_layers"]
        assert depth > dense + 1, (
            f"{models.path(cfg['model_type'])}'s SMALL holds "
            f"num_hidden_layers = {depth}: a cut below it keeps no layer "
            f"after the port's {dense} leading dense ones")
        cfg["published"]["num_hidden_layers"] = depth
        cfg["num_hidden_layers"] = depth - 1
    return cfg


def small_mix(name: str) -> dict:
    mix = copy.deepcopy(harness.traffic(name))
    mix["query_tokens"].update(median=6, max=16)
    if mix["kind"] == "validate":
        mix.update(n_queries=12, depth=24, k=24, batch_size=16,
                   chunk_size=16, relevant_per_query={"1": 10, "2": 2})
        mix["passage_tokens"].update(median=20, max=60)
    else:
        mix.update(corpus_rows=6000, row_block=1024, rate_qps=40,
                   check_sample=24)
    return mix


def run_small(cell: str, seed: int = 7, seconds: float = 1.0,
              trace: bool = False, cfg=None) -> dict:
    """One run of ``cell`` at the small size on the CPU, past the entry
    point's look for a chip; ``cfg`` replaces its small configuration."""
    bm = harness.load_benchmark()
    w = harness.workload(bm, cell)
    cfg = small_config(w["config"]) if cfg is None else cfg
    with smoke_port():
        return harness.run_cell(bm, cell, seed=seed, seconds=seconds,
                                trace=trace, device="cpu",
                                t_start=time.perf_counter(), cfg=cfg,
                                mix=small_mix(w["traffic"]))


def smoke_port():
    """The port's smoke config in place of its full one: the small cell's
    sizes are checked against it as a full cell's are against the port's
    full config."""
    from repro_torch.configs import registry
    return mock.patch.object(
        port, "port_config",
        lambda cfg: registry.get(cfg["retriever"]["port_arch"])
        .smoke_config())
