"""The recommender pool of ``repro/models/recsys.py`` in PyTorch: bert4rec,
sasrec, mind and deepfm.

All four follow the production recommender layout: large embedding tables
-> a feature-interaction op -> a small MLP or scoring head.  The sequential
models (bert4rec, sasrec) run the port's transformer trunk
(:mod:`repro_torch.models.transformer`) with learned positions and tied
item embeddings; mind adds capsule dynamic routing (a fixed number of
iterations in a Python loop); deepfm is an FM plus a deep MLP over 39
sparse fields.  Training over a 10^6-item vocabulary uses sampled softmax
over one negative pool per batch; retrieval-style validation scores a user
vector against the item table (:func:`item_embeddings`,
``repro_torch.core.retrieval.topk_exact``).  No path here reaches an
attention kernel: the trunk always gets a key mask.

Parameters keep the reference's key paths (``trunk``; ``item_embed``,
``w_trans``, ``routing_init``; ``embed``, ``lin``, ``bias``, ``mlp/l{i}``),
so the JAX package's parameter trees load as they are
(:func:`repro_torch.models.nn.to_torch_tree`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import embedding_ops, nn
from repro_torch.models import transformer as tfm

# Criteo-Kaggle categorical cardinalities (DLRM convention) + 13 numeric
# fields bucketized to 64 bins each -> 39 sparse fields, ~33.8M rows total.
CRITEO_CAT_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
CRITEO_NUM_BUCKETS = (64,) * 13


@dataclasses.dataclass
class RecsysConfig:
    name: str = "recsys"
    model_type: str = "sasrec"        # bert4rec | sasrec | mind | deepfm
    embed_dim: int = 64
    item_vocab: int = 1_000_000
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    d_ff: int = 0                     # 0 -> embed_dim (sasrec) / 4x (bert4rec)
    n_interests: int = 4
    capsule_iters: int = 3
    field_vocab_sizes: Tuple[int, ...] = ()
    max_hot: int = 1                  # multi-hot width per sparse field
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    n_negatives: int = 2048
    n_serve_candidates: int = 1000
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    @property
    def n_fields(self) -> int:
        return len(self.field_vocab_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.field_vocab_sizes))


# ---------------------------------------------------------------------------
# Sequential trunks (bert4rec / sasrec run the transformer)
# ---------------------------------------------------------------------------


def _trunk_cfg(cfg: RecsysConfig) -> tfm.TransformerConfig:
    if cfg.model_type == "bert4rec":
        # post-LN, QKV bias, GELU, bidirectional; +pad +[MASK] items
        return tfm.TransformerConfig(
            name=cfg.name + "-trunk", n_layers=cfg.n_blocks,
            d_model=cfg.embed_dim, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_heads, head_dim=cfg.embed_dim // cfg.n_heads,
            d_ff=cfg.d_ff or 4 * cfg.embed_dim,
            vocab_size=cfg.item_vocab + 2, qkv_bias=True, use_rope=False,
            max_position_embeddings=cfg.seq_len, norm_style="post",
            act="gelu", causal=False, tie_embeddings=True,
            q_chunk=min(128, cfg.seq_len), param_dtype=cfg.param_dtype,
            compute_dtype=cfg.compute_dtype)
    # sasrec: pre-norm, unidirectional, learned positions; +pad item
    return tfm.TransformerConfig(
        name=cfg.name + "-trunk", n_layers=cfg.n_blocks,
        d_model=cfg.embed_dim, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
        head_dim=cfg.embed_dim // cfg.n_heads, d_ff=cfg.d_ff or cfg.embed_dim,
        vocab_size=cfg.item_vocab + 1, qkv_bias=False, use_rope=False,
        max_position_embeddings=cfg.seq_len, norm_style="pre", act="gelu",
        causal=True, tie_embeddings=True, q_chunk=min(128, cfg.seq_len),
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype)


def _item_table(params, cfg: RecsysConfig) -> torch.Tensor:
    if cfg.model_type in ("bert4rec", "sasrec"):
        return params["trunk"]["embed"]["table"]
    return params["item_embed"]


def _rows(table: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    """``jnp.take(table.astype(dtype), ids, axis=0)``: the rows cast after
    the gather, which gives the same values without a cast of the table."""
    return table[ids.long()].to(dtype)


def _sampled_softmax(user_vec, pos_emb, neg_emb, mask=None):
    """Cross-entropy over [positive | shared negatives].

    user_vec, pos_emb (..., D); neg_emb (n_neg, D); mask (...,) bool over
    the prediction positions.  Returns (loss, per-position nll)."""
    pos = (user_vec * pos_emb).sum(-1)
    neg = user_vec @ neg_emb.T
    logits = torch.cat([pos[..., None], neg], dim=-1).float()
    nll = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    if mask is None:
        return nll.mean(), nll
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1), nll


# ---------------------------------------------------------------------------
# MIND capsule routing
# ---------------------------------------------------------------------------


def _squash(z, dim: int = -1, eps: float = 1e-9):
    n2 = z.square().sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + eps)


def capsule_routing(h, mask, routing_init, w_trans, iters: int):
    """B2I dynamic routing [arXiv:1904.08030].

    h (B, S, D) behaviour embeddings; mask (B, S) bool; routing_init
    (K, S) routing-logit init; w_trans (D, D).  Runs ``iters`` iterations
    and returns the last one's interest capsules (B, K, D)."""
    hp = h @ w_trans
    B = h.shape[0]
    keep = mask[:, None, :]
    neg = torch.tensor(-1e30, dtype=routing_init.dtype, device=h.device)
    b = torch.where(keep, routing_init[None].expand(B, *routing_init.shape),
                    neg)
    u = None
    for _ in range(iters):
        w = torch.softmax(b, dim=1)                       # over capsules
        z = torch.einsum("bks,bsd->bkd", w * keep.to(w.dtype), hp)
        u = _squash(z)
        db = torch.einsum("bkd,bsd->bks", u, hp)
        b = torch.where(keep, b + db, neg)
    return u


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: RecsysConfig) -> Dict[str, Any]:
    """The parameter tree's structure with each leaf's shape (the
    checkpoint template); allocates nothing."""
    if cfg.model_type in ("bert4rec", "sasrec"):
        return {"trunk": tfm.param_shapes(_trunk_cfg(cfg))}
    D = cfg.embed_dim
    if cfg.model_type == "mind":
        return {"item_embed": (cfg.item_vocab + 1, D), "w_trans": (D, D),
                "routing_init": (cfg.n_interests, cfg.seq_len)}
    if cfg.model_type == "deepfm":
        dims = (cfg.n_fields * D,) + tuple(cfg.mlp_dims) + (1,)
        return {"embed": (cfg.total_rows, D), "lin": (cfg.total_rows, 1),
                "bias": (),
                "mlp": {f"l{i}": {"w": (dims[i], dims[i + 1]),
                                  "b": (dims[i + 1],)}
                        for i in range(len(dims) - 1)}}
    raise ValueError(cfg.model_type)


def param_axes(cfg: RecsysConfig) -> Dict[str, Any]:
    """:func:`param_shapes`' tree with each leaf's logical axis names, as
    the reference's ``init`` gives them: tables ``("table_rows",
    "embed")``, mind's ``("embed", "embed2")`` transform and
    ``("interests", "seq")`` routing logits, deepfm's MLP ``("gnn_in",
    "gnn_hidden")`` and its 0-d bias ``()``."""
    if cfg.model_type in ("bert4rec", "sasrec"):
        return {"trunk": tfm.param_axes(_trunk_cfg(cfg))}
    table = ("table_rows", "embed")
    if cfg.model_type == "mind":
        return {"item_embed": table, "w_trans": ("embed", "embed2"),
                "routing_init": ("interests", "seq")}
    if cfg.model_type == "deepfm":
        return {"embed": table, "lin": table, "bias": (),
                "mlp": {f"l{i}": {"w": ("gnn_in", "gnn_hidden"),
                                  "b": ("gnn_hidden",)}
                        for i in range(len(cfg.mlp_dims) + 1)}}
    raise ValueError(cfg.model_type)


def param_dtypes(cfg: RecsysConfig) -> Dict[str, Any]:
    """:func:`param_shapes`' tree with each leaf's dtype: ``param_dtype``,
    except mind's ``routing_init`` and deepfm's ``bias``, which the
    reference keeps in f32."""
    if cfg.model_type in ("bert4rec", "sasrec"):
        return {"trunk": tfm.param_dtypes(_trunk_cfg(cfg))}

    def build(node, name):
        if isinstance(node, dict):
            return {key: build(val, key) for key, val in node.items()}
        return torch.float32 if name in ("routing_init", "bias") \
            else cfg.param_dtype

    return build(param_shapes(cfg), "")


def init_std(name: str, shape) -> float:
    """The reference's init: embedding tables N(0, 0.02), mind's routing
    logits N(0, 1), product weights N(0, 1/fan_in)."""
    if name in ("table", "router", "item_embed", "embed", "lin"):
        return 0.02
    if name == "routing_init":
        return 1.0
    return nn.fan_in_std(shape)


def init_numpy(cfg: RecsysConfig, seed: int) -> Dict[str, Any]:
    """Random parameters (numpy f32) with the reference's scheme (norm
    scales 1, biases 0, :func:`init_std`); the numbers are not the
    reference's."""
    return nn.init_numpy(param_shapes(cfg), seed, init_std)


# ---------------------------------------------------------------------------
# user encoding / scores / losses per model type
# ---------------------------------------------------------------------------


def user_embed(params, cfg: RecsysConfig, hist, hist_mask=None):
    """Encode user histories -> user vectors: (B, D) for sasrec and
    bert4rec (the last valid position's hidden state), (B, K, D) interests
    for mind."""
    if hist_mask is None:
        hist_mask = hist > 0
    if cfg.model_type in ("bert4rec", "sasrec"):
        hidden, _, _ = tfm.forward(params["trunk"], _trunk_cfg(cfg), hist,
                                   kv_mask=hist_mask)
        last = (hist_mask.sum(-1) - 1).clamp(min=0)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      last]
    if cfg.model_type == "mind":
        h = embedding_ops.embedding_lookup(params["item_embed"], hist,
                                           cfg.compute_dtype)
        return capsule_routing(h.float(), hist_mask, params["routing_init"],
                               params["w_trans"].float(), cfg.capsule_iters)
    raise ValueError(cfg.model_type)


def _label_aware_user(interests, target_emb, power: float = 2.0):
    """MIND label-aware attention over the interest capsules."""
    s = torch.einsum("bkd,bd->bk", interests, target_emb) * power
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


def deepfm_scores(params, cfg: RecsysConfig, ids, valid):
    """DeepFM logits (B,) f32. ids, valid (B, F, max_hot), global row
    ids."""
    cd = cfg.compute_dtype
    emb = embedding_ops.multi_hot_bag(params["embed"], ids, valid,
                                      mode="sum", compute_dtype=cd)
    lin = embedding_ops.multi_hot_bag(params["lin"], ids, valid, mode="sum",
                                      compute_dtype=torch.float32)
    first = lin.sum(dim=(1, 2))
    e32 = emb.float()
    s = e32.sum(dim=1)
    fm2 = 0.5 * (s.square() - e32.square().sum(dim=1)).sum(-1)
    h = emb.reshape(ids.shape[0], -1)
    n_layers = len(cfg.mlp_dims) + 1
    for i in range(n_layers):
        h = nn.linear(params["mlp"][f"l{i}"], h, cd)
        if i < n_layers - 1:
            h = torch.relu(h)
    deep = h[:, 0].float()
    return params["bias"].float() + first + fm2 + deep


def loss_fn(params, cfg: RecsysConfig, batch):
    """The training loss of each model type (sampled softmax for the
    sequential and interest models, logistic loss for deepfm).  Returns
    (loss, metrics)."""
    if cfg.model_type == "sasrec":
        hist, pos = batch["hist"], batch["pos"]
        mask = hist > 0
        hidden, _, _ = tfm.forward(params["trunk"], _trunk_cfg(cfg), hist,
                                   kv_mask=mask)
        table = _item_table(params, cfg)
        loss, _ = _sampled_softmax(hidden, _rows(table, pos, hidden.dtype),
                                   _rows(table, batch["neg_ids"],
                                         hidden.dtype), mask & (pos > 0))
        return loss, {}
    if cfg.model_type == "bert4rec":
        tokens = batch["tokens"]
        hidden, _, _ = tfm.forward(params["trunk"], _trunk_cfg(cfg), tokens,
                                   kv_mask=tokens > 0)
        hsel = hidden.gather(1, batch["mlm_positions"].long()[..., None]
                             .expand(-1, -1, hidden.shape[-1]))
        table = _item_table(params, cfg)
        loss, _ = _sampled_softmax(
            hsel, _rows(table, batch["mlm_labels"], hidden.dtype),
            _rows(table, batch["neg_ids"], hidden.dtype), batch["mlm_mask"])
        return loss, {}
    if cfg.model_type == "mind":
        interests = user_embed(params, cfg, batch["hist"])
        table = _item_table(params, cfg)
        tgt = _rows(table, batch["target"], torch.float32)
        u = _label_aware_user(interests, tgt)
        loss, _ = _sampled_softmax(u, tgt, _rows(table, batch["neg_ids"],
                                                 torch.float32))
        return loss, {}
    if cfg.model_type == "deepfm":
        logit = deepfm_scores(params, cfg, batch["ids"], batch["valid"])
        y = batch["label"].float()
        loss = (logit.clamp(min=0) - logit * y
                + torch.log1p(torch.exp(-logit.abs()))).mean()
        acc = ((torch.sigmoid(logit) > 0.5) == (y > 0.5)).float().mean()
        return loss, {"acc": acc}
    raise ValueError(cfg.model_type)


def serve_fn(params, cfg: RecsysConfig, batch):
    """Online inference: deepfm's logits (B,), or each user's scores of the
    candidate slate ``cand_ids`` (B, C) f32 (mind: the best interest)."""
    if cfg.model_type == "deepfm":
        return deepfm_scores(params, cfg, batch["ids"], batch["valid"])
    u = user_embed(params, cfg, batch["hist"])
    cand = _rows(_item_table(params, cfg), batch["cand_ids"], torch.float32)
    if cfg.model_type == "mind":
        return torch.einsum("bkd,cd->bkc", u, cand).amax(dim=1)
    return u.float() @ cand.T


def item_embeddings(params, cfg: RecsysConfig, ids):
    """L2-normalised f32 embeddings of items ``ids``: the candidate corpus
    for retrieval validation."""
    e = _rows(_item_table(params, cfg), ids, torch.float32)
    return e / e.norm(dim=-1, keepdim=True).clamp(min=1e-6)
