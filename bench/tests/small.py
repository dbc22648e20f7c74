"""The benchmark's cells at a size a CPU test holds, through the port's
smoke-size trunks, run past the entry point's look for a chip."""

import copy
import time
from unittest import mock

from bench import harness, port

#: the port's smoke configs, in the configuration files' keys
SMOKE = {
    "dr-bert-base": dict(num_hidden_layers=2, hidden_size=64,
                         num_attention_heads=4, intermediate_size=128,
                         vocab_size=211, max_position_embeddings=64),
    "qwen2-0.5b-dr": dict(num_hidden_layers=2, hidden_size=56,
                          num_attention_heads=7, num_key_value_heads=1,
                          intermediate_size=96, vocab_size=211,
                          rope_theta=10000.0),
}


def small_cell(cell: str):
    """(cfg, mix) of ``cell`` at a size a CPU test holds."""
    bm = harness.load_benchmark()
    w = harness.workload(bm, cell)
    cfg = copy.deepcopy(harness.config(w["config"]))
    cfg.update(SMOKE[w["config"]])
    cfg["retriever"].update(q_max_len=16, p_max_len=48)
    mix = copy.deepcopy(harness.traffic(w["traffic"]))
    mix["query_tokens"].update(median=6, max=16)
    if mix["kind"] == "validate":
        mix.update(n_queries=12, depth=24, k=24, batch_size=16,
                   chunk_size=16, relevant_per_query={"1": 10, "2": 2})
        mix["passage_tokens"].update(median=20, max=60)
    else:
        mix.update(corpus_rows=6000, row_block=1024, rate_qps=40,
                   check_sample=24)
    return cfg, mix


def run_small(cell: str, seed: int = 7, seconds: float = 1.0,
              trace: bool = False) -> dict:
    """One run of ``cell`` at the small size on the CPU, past the entry
    point's look for a chip."""
    cfg, mix = small_cell(cell)
    with smoke_port():
        return harness.run_cell(harness.load_benchmark(), cell, seed=seed,
                                seconds=seconds, trace=trace, device="cpu",
                                t_start=time.perf_counter(), cfg=cfg,
                                mix=mix)


def smoke_port():
    """The port's smoke config in place of its full one: the small cell's
    sizes are checked against it as a full cell's are against the port's
    full config."""
    from repro_torch.configs import registry
    return mock.patch.object(
        port, "port_config",
        lambda cfg: registry.get(cfg["retriever"]["port_arch"])
        .smoke_config())
