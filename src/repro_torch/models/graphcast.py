"""The GraphCast-style encoder-processor-decoder GNN of
``repro/models/graphcast.py`` [arXiv:2212.12794] in PyTorch.

Message passing is a gather of the endpoints' node latents and a segment
reduction of the edge latents at their destinations over an edge list
(``src``, ``dst``), as the reference's ``jnp.take`` + ``segment_sum``.  The
reductions (:func:`repro_torch.models.nn.segment_sum` / ``segment_max``)
sum each node's incoming messages in edge order, so the result does not
depend on the run, on a card too (a scatter-add there does).  The 16
interaction-network layers are stacked on a leading axis, as the
reference's, and run in a Python loop.  The benchmark shapes are generic
graphs (cora, a reddit minibatch, ogb-products, molecule batches): the
encoder and decoder are GraphCast's node and edge MLP encoders, the
processor its multi-mesh GNN; ``mesh_refinement`` is metadata of the
weather configuration.

Layer update (interaction network, sum aggregator, LayerNorm):
    e' = e + LN(MLP_e([e, v_src, v_dst]))
    v' = v + LN(MLP_v([v, aggregate(e', dst)]))
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import nn


@dataclasses.dataclass
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227          # output variables per node
    d_feat: int = 227          # input features per node (per-shape)
    mesh_refinement: int = 6   # metadata of the weather mesh configuration
    aggregator: str = "sum"    # sum | max | mean
    norm_eps: float = 1e-6
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16


def _mlp_shapes(d_in: int, d_hidden: int, d_out: int, lead=()):
    return {"l1": {"w": (*lead, d_in, d_hidden), "b": (*lead, d_hidden)},
            "l2": {"w": (*lead, d_hidden, d_out), "b": (*lead, d_out)},
            "norm": {"scale": (*lead, d_out), "bias": (*lead, d_out)}}


def param_shapes(cfg: GraphCastConfig) -> Dict[str, Any]:
    """The parameter tree's structure with each leaf's shape (the
    checkpoint template); ``processor`` is stacked on a leading
    ``n_layers`` axis.  Allocates nothing."""
    D, L = cfg.d_hidden, (cfg.n_layers,)
    return {"node_encoder": _mlp_shapes(cfg.d_feat, D, D),
            # edge inputs: [src latent, dst latent] (no geometric features
            # on benchmark graphs)
            "edge_encoder": _mlp_shapes(2 * D, D, D),
            "decoder": _mlp_shapes(D, D, cfg.n_vars),
            "processor": {"edge_mlp": _mlp_shapes(3 * D, D, D, L),
                          "node_mlp": _mlp_shapes(2 * D, D, D, L)}}


def param_axes(cfg: GraphCastConfig) -> Dict[str, Any]:
    """:func:`param_shapes`' tree with each leaf's logical axis names, as
    the reference's ``init`` gives them; the processor's leading
    ``n_layers`` dim is unnamed."""
    mlp = {"l1": {"w": ("gnn_in", "gnn_hidden"), "b": ("gnn_hidden",)},
           "l2": {"w": ("gnn_hidden", "gnn_out"), "b": ("gnn_out",)},
           "norm": {"scale": ("gnn_out",), "bias": ("gnn_out",)}}
    return {"node_encoder": mlp, "edge_encoder": mlp, "decoder": mlp,
            "processor": {"edge_mlp": mlp, "node_mlp": mlp}}


def param_dtypes(cfg: GraphCastConfig) -> Dict[str, Any]:
    """:func:`param_shapes`' tree with ``param_dtype`` at every leaf."""
    def build(node):
        if isinstance(node, dict):
            return {key: build(val) for key, val in node.items()}
        return cfg.param_dtype

    return build(param_shapes(cfg))


def init_std(name: str, shape) -> float:
    """Every weight leaf is N(0, 1/fan_in), as the reference's
    ``linear_init``."""
    return nn.fan_in_std(shape)


def init_numpy(cfg: GraphCastConfig, seed: int) -> Dict[str, Any]:
    """Random parameters (numpy f32) with the reference's scheme: weights
    N(0, 1/fan_in), biases 0, norm scales 1.  The numbers are not the
    reference's."""
    return nn.init_numpy(param_shapes(cfg), seed, init_std)


def _mlp(p, x, cfg: GraphCastConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    h = nn.silu(nn.linear(p["l1"], x, cd))
    h = nn.linear(p["l2"], h, cd)
    return nn.layernorm(p["norm"], h, cfg.norm_eps)


def _aggregate(messages, dst, n_nodes: int, aggregator: str):
    """Messages (E, D) reduced at their destination nodes -> (n_nodes, D):
    sum, max (a node with no incoming edge gets -inf, as the reference's
    ``segment_max``) or mean (sum over the count, at least 1)."""
    dst = dst.long()
    if aggregator == "sum":
        return nn.segment_sum(messages, dst, n_nodes)
    if aggregator == "max":
        return nn.segment_max(messages, dst, n_nodes)
    if aggregator == "mean":
        s = nn.segment_sum(messages, dst, n_nodes)
        # the in-degree as an f32 segment sum of ones (exact below 2**24):
        # a bincount's size depends on the data, which a meta run lacks
        ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
        c = nn.segment_sum(ones, dst, n_nodes).to(s.dtype)
        return s / c[:, None].clamp(min=1)
    raise ValueError(aggregator)


def _processor_layer(p, v, e, src, dst, cfg: GraphCastConfig):
    """One interaction-network step. v (N, D); e (E, D); src, dst (E,)."""
    e = e + _mlp(p["edge_mlp"], torch.cat([e, v[src], v[dst]], dim=-1), cfg)
    agg = _aggregate(e, dst, v.shape[0], cfg.aggregator)
    v = v + _mlp(p["node_mlp"], torch.cat([v, agg], dim=-1), cfg)
    return v, e


def _latents(params, cfg: GraphCastConfig, node_feat, src, dst):
    """Node latents after the encoder and every processor layer."""
    src, dst = src.long(), dst.long()
    v = _mlp(params["node_encoder"], node_feat.to(cfg.compute_dtype), cfg)
    e = _mlp(params["edge_encoder"], torch.cat([v[src], v[dst]], dim=-1),
             cfg)
    proc = params["processor"]
    n = proc["edge_mlp"]["norm"]["scale"].shape[0]
    for layer in nn.unstack(proc, n):
        v, e = _processor_layer(layer, v, e, src, dst, cfg)
    return v


def forward(params, cfg: GraphCastConfig, node_feat, src, dst):
    """node_feat (N, d_feat), src and dst (E,) -> per-node predictions
    (N, n_vars) f32."""
    v = _latents(params, cfg, node_feat, src, dst)
    return _mlp(params["decoder"], v, cfg).float()


def loss_fn(params, cfg: GraphCastConfig, batch):
    """MSE next-state loss (rollout surrogate).

    batch: {"node_feat" (N, d_feat), "src" (E,), "dst" (E,), "target"
    (N, n_vars), optional "node_mask" (N,)}; batched small graphs come
    pre-flattened with disjoint edge indices.  Returns (loss, {})."""
    pred = forward(params, cfg, batch["node_feat"], batch["src"],
                   batch["dst"])
    err = (pred - batch["target"]).square()
    mask = batch.get("node_mask")
    if mask is not None:
        err = err * mask[:, None]
        return err.sum() / (mask.sum() * cfg.n_vars).clamp(min=1), {}
    return err.mean(), {}


def encode_nodes(params, cfg: GraphCastConfig, node_feat, src, dst):
    """L2-normalised f32 node latents before the decoder, for
    retrieval-style validation of GNN checkpoints."""
    v32 = _latents(params, cfg, node_feat, src, dst).float()
    return v32 / v32.norm(dim=-1, keepdim=True).clamp(min=1e-6)
