"""The system under test: the port's encoder for a configuration file.

The configuration names the port's architecture (``retriever.port_arch``);
the port's own ``full_config()`` is run, as its CLI runs ``--arch``, after
a check that every size the file states is the one the port builds.  A
file and a port that disagree stop the run before any work.
"""

from __future__ import annotations

import torch

from bench import models, weights


def port_config(cfg: dict):
    """The port's config of the file's architecture, at full size."""
    from repro_torch.configs import registry
    return registry.get(cfg["retriever"]["port_arch"]).full_config()


def transformer_config(cfg: dict):
    tcfg = port_config(cfg)
    want = models.of(cfg).port_fields(cfg)
    want["compute_dtype"] = weights.DTYPES[cfg["retriever"]["compute_dtype"]]
    got = {key: getattr(tcfg, key) for key in want}
    if got != want:
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise SystemExit(f"the port's {tcfg.name} is not the configuration "
                         f"file's: (port, file) = {bad}")
    return tcfg


def encoder_spec(cfg: dict, device):
    from repro_torch.models.biencoder import biencoder_spec
    r = cfg["retriever"]
    return biencoder_spec(transformer_config(cfg), pooling=r["pooling"],
                          q_max_len=r["q_max_len"], p_max_len=r["p_max_len"],
                          device=torch.device(device))
