"""The system under test: the port's encoder for a configuration file.

The configuration names the port's architecture (``retriever.port_arch``);
the port's own ``full_config()`` is run, as its CLI runs ``--arch``, after
a check that every size the file states is the one the port builds.  A
file and a port that disagree stop the run before any work.

A file may cut one size, the depth: it then holds the cut value under
its usual key and the published one in ``published``
(``"num_hidden_layers": 5, "published": {"num_hidden_layers": 27}``).
The port's full config is checked against the published sizes, and the
trunk built is that config with ``n_layers`` cut; no width is ever cut.
"""

from __future__ import annotations

import dataclasses

import torch

from bench import models, weights

#: the keys ``published`` may hold: the port has no layer that holds a
#: share of the heads, the experts or the vocabulary, so only depth is cut
CUTS = ("num_hidden_layers",)


def port_config(cfg: dict):
    """The port's config of the file's architecture, at full size."""
    from repro_torch.configs import registry
    return registry.get(cfg["retriever"]["port_arch"]).full_config()


def _fields(cfg: dict) -> dict:
    """The sizes and options the port's ``TransformerConfig`` has to hold
    for ``cfg``."""
    want = models.of(cfg).port_fields(cfg)
    want["compute_dtype"] = weights.DTYPES[cfg["retriever"]["compute_dtype"]]
    return want


def transformer_config(cfg: dict):
    """The port's ``TransformerConfig`` of the file: its full config where
    nothing is cut, else that config at the file's depth.  Every refusal
    comes before any weight is drawn."""
    published = cfg.get("published", {})
    other = {k: (cfg.get(k), v) for k, v in published.items()
             if k not in CUTS}
    if other:
        raise SystemExit(f"a configuration file cuts only {list(CUTS)}; "
                         f"its published holds {other} as (file, "
                         f"published): no width is cut")
    tcfg = port_config(cfg)
    full = _fields({**cfg, **published})
    got = {key: getattr(tcfg, key) for key in full}
    if got != full:
        bad = {k: (got[k], full[k]) for k in full if got[k] != full[k]}
        raise SystemExit(f"the port's {tcfg.name} is not the configuration "
                         f"file's: (port, file) = {bad}")
    if not published:
        return tcfg
    cut, depth = cfg["num_hidden_layers"], published["num_hidden_layers"]
    dense = tcfg.first_k_dense
    low = dense + 1                 # every layer group keeps a layer
    if type(cut) is not int or not low <= cut < depth:
        raise SystemExit(
            f"num_hidden_layers = {cut!r} cut from the published {depth} "
            f"is out of range: {low} <= cut < {depth}"
            + (f", above first_k_dense = {dense} so that every layer group "
               f"keeps a layer" if dense > 0 else ""))
    want = _fields(cfg)
    moved = sorted(k for k in set(full) | set(want)
                   if full.get(k) != want.get(k))
    if moved != ["n_layers"]:
        raise SystemExit(f"cutting num_hidden_layers moves the port's "
                         f"fields {moved}, not n_layers alone")
    return dataclasses.replace(tcfg, n_layers=cut)


def encoder_spec(cfg: dict, device):
    from repro_torch.models.biencoder import biencoder_spec
    r = cfg["retriever"]
    return biencoder_spec(transformer_config(cfg), pooling=r["pooling"],
                          q_max_len=r["q_max_len"], p_max_len=r["p_max_len"],
                          device=torch.device(device))
