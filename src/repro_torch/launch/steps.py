"""Per-(arch x shape) step construction: abstract inputs and layouts
(``repro/launch/steps.py``).

``build_step(arch_id, shape_name, mesh)`` returns a :class:`StepSpec`:
``fn`` runs one step of the cell, ``abstract_args`` are its arguments as
meta-device tensors (shapes and dtypes, nothing allocated), and
``in_shardings`` / ``out_shardings`` are trees of the port's
:class:`~repro_torch.distributed.sharding.NamedSharding` over ``mesh``.
The dry run (``launch/dryrun.py``) runs ``fn`` on the meta arguments and
counts; ``chip_smoke.py`` materialises the paper's cells' arguments on the
card and runs ``fn`` there.  ``fn`` runs the port's own entry points
(``make_train_step``, ``lm_loss``, ``prefill``, ``decode_step``,
``graphcast.loss_fn``, the recommenders, ``contrastive_loss``, ``encode``,
``topk_sharded`` / ``topk_exact``) on whatever device its inputs are on,
and every tensor it makes takes that device.

Variants, as the reference's:
  * ``variant="full"`` — the real configuration.
  * ``variant="cost"`` — layer stacks cut to ``cost_layers`` per stack;
    the dry run extrapolates from cost variants 1 and 2 to full depth
    beside its direct count.

Divergences by design from the reference:
  * The reference's execution knobs ``remat`` and ``*_unroll`` (and
    GraphCast's ``layer_unroll``) have no counterpart: PyTorch runs layers
    and chunks in Python loops, so eager code counts every layer.
    ``q_chunk``, ``vocab_chunk`` and the cost variants' ``n_layers`` stay.
  * The decode step's ``index`` keeps the reference's 0-d int32 slot in
    ``abstract_args``, but ``fn`` ignores the value it is given and writes
    position ``seq_len - 1``: the port's ``decode_step`` takes a Python
    int, and a meta tensor has no value to read.
  * The layouts place nothing: the LM, GNN and recsys steps run eager and
    unsharded, and :func:`_with_act` keeps the reference's activation rules
    (on ``fn.act_rules``) for the report without applying them.  The
    retrieve step's ``topk_sharded`` does split the corpus over the mesh.
  * Attention runs ``attn_impl="torch"``: the reference's full configs use
    its XLA path, and the encoder always passes a key mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.core import pytree
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import DeviceMesh
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.models import graphcast as gcast
from repro_torch.models import nn
from repro_torch.models import recsys as rcs
from repro_torch.models import transformer as tfm
from repro_torch.models.biencoder import biencoder_spec, contrastive_loss
from repro_torch.train import optim
from repro_torch.train.trainer import make_train_step

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the port's ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclasses.dataclass
class StepSpec:
    cell: str
    kind: str                       # train | prefill | decode | serve | retrieval | encode
    fn: Callable
    abstract_args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple
    meta: Dict[str, Any]


def _repl(mesh):
    return NamedSharding(mesh, P())


def _act_rules(mesh: DeviceMesh, *, sp: bool = False) -> Dict[str, Any]:
    """The reference's logical activation axes -> mesh axes: batch on the
    data-parallel axes, head / mlp / vocab projections on "model", the
    residual stream replicated over "model" between blocks, or (``sp``,
    sequence parallelism) sharded over it on the sequence dim."""
    dp = shd.batch_axes(mesh)
    return {"act_batch": dp, "act_seq": ("model" if sp else None),
            "act_embed": None,
            "act_heads": "model", "act_kv_heads": "model",
            "act_mlp": "model", "act_vocab": "model",
            "act_expert": "model",
            "act_rows": dp + ("model",)}


def _with_act(fn: Callable, mesh: DeviceMesh, rules: Optional[Dict] = None,
              *, sp: bool = False) -> Callable:
    """``fn`` with the reference's activation rules attached as
    ``act_rules``.  The port's models place no activation constraints, so
    the wrapper runs ``fn`` unchanged."""
    rules = rules if rules is not None else _act_rules(mesh, sp=sp)

    def wrapped(*args):
        return fn(*args)

    wrapped.act_rules = rules
    return wrapped


def _named(mesh, spec):
    return NamedSharding(mesh, spec)


def _count(tree) -> int:
    return int(sum(math.prod(leaf.shape) for leaf in pytree.tree_leaves(tree)))


def _mesh_size(mesh: DeviceMesh, axes) -> int:
    return int(math.prod(mesh.shape[a] for a in axes))


def _to_bf16(tree):
    """Every floating leaf of a meta tree as bf16 (the serving weights)."""
    return pytree.tree_map(
        lambda t: _sds(t.shape, torch.bfloat16) if t.is_floating_point()
        else t, tree)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

# full-config execution knobs of the dry-run configs: vocab_chunk keeps the
# (tokens, V) logits off the device, q_chunk bounds attention's working set
_LM_DRYRUN_KNOBS = dict(q_chunk=512, vocab_chunk=8192)


def _lm_cfg(arch_id: str, *, variant: str, kind: str,
            cost_layers: int = 1) -> tfm.TransformerConfig:
    cfg = registry.get(arch_id).full_config()
    knobs = dict(_LM_DRYRUN_KNOBS)
    if variant == "cost":
        # reduced depth: first_k_dense dense layers + cost_layers MoE ones
        n_dense = cfg.first_k_dense if cfg.is_moe else cost_layers
        n_moe = cost_layers if cfg.is_moe else 0
        knobs.update(n_layers=n_dense + n_moe)
        if cfg.is_moe and cfg.first_k_dense == 0:
            knobs["n_layers"] = cost_layers           # all-MoE stacks (arctic)
    return dataclasses.replace(cfg, **knobs)


def _lm_active_params(cfg: tfm.TransformerConfig,
                      params_abs) -> Tuple[int, int]:
    """(total, active) parameter counts.  Active replaces the routed-expert
    block with top_k experts (an MoE forward touches top_k + shared
    only)."""
    total = _count(params_abs)
    if not cfg.is_moe:
        return total, total
    n_moe_layers = cfg.n_layers - cfg.first_k_dense
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = n_moe_layers * (cfg.moe_num_experts - cfg.moe_top_k) \
        * per_expert
    return total, total - inactive


def _lm_attn_flops(cfg, S_q: int, T_kv: int, batch: int,
                   causal_avg: bool) -> float:
    """QK^T + PV matmul flops for one forward pass."""
    t_eff = (T_kv + 1) / 2 if causal_avg else T_kv
    if cfg.mla:
        d_qk, d_v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        per = 2 * cfg.n_heads * (d_qk + d_v) * t_eff
    else:
        per = 4 * cfg.n_heads * cfg.head_dim * t_eff
    return cfg.n_layers * batch * S_q * per


def _lm_model_flops(cfg, kind: str, B: int, S: int,
                    params_abs) -> Dict[str, float]:
    total, active = _lm_active_params(cfg, params_abs)
    if kind == "train":
        tokens = B * S
        mf = 6.0 * active * tokens + 3 * _lm_attn_flops(cfg, S, S, B, True)
    elif kind == "prefill":
        tokens = B * S
        mf = 2.0 * active * tokens + _lm_attn_flops(cfg, S, S, B, True)
    else:  # decode: one token against a T=S cache
        tokens = B
        mf = 2.0 * active * tokens + _lm_attn_flops(cfg, 1, S, B, False)
    return {"model_flops": mf, "params": total, "active_params": active,
            "tokens": tokens}


def _lm_abstract_params(cfg, mesh, rules):
    shapes, axes = nn.abstract_init(tfm, cfg)
    return shapes, shd.tree_shardings(shapes, axes, rules, mesh)


def _make_optimizer(arch_id: str):
    if arch_id == "arctic-480b":        # full Adam state doesn't fit 256 chips
        return optim.adafactor(1e-4), "adafactor"
    return optim.adamw(optim.warmup_cosine(3e-4, 2000, 100_000)), "adamw"


_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def lm_train_spec(arch_id: str, shape: dict, mesh: DeviceMesh, *,
                  variant: str = "full", cost_layers: int = 1,
                  sp: Optional[bool] = None,
                  cfg_overrides: Optional[Dict[str, Any]] = None
                  ) -> StepSpec:
    B, S = shape["global_batch"], shape["seq_len"]
    cfg = _lm_cfg(arch_id, variant=variant, kind="train",
                  cost_layers=cost_layers)
    if cfg_overrides:
        ov = dict(cfg_overrides)
        for key in ("param_dtype", "compute_dtype"):
            if key in ov:
                ov[key] = _DTYPES[ov[key]]
        cfg = dataclasses.replace(cfg, **ov)
    full_cfg = registry.get(arch_id).full_config()
    if sp is None:
        # sequence parallelism when the per-layer carry stack would not
        # fit: L x (B/dp) x S x D bf16 against a 4 GiB budget
        dp = _mesh_size(mesh, shd.batch_axes(mesh))
        carry_gib = (full_cfg.n_layers * (B // dp) * S * full_cfg.d_model
                     * 2 / 2**30)
        sp = carry_gib > 4.0
    rules = shd.lm_train_rules()
    params_abs, params_sh = _lm_abstract_params(cfg, mesh, rules)
    opt, opt_name = _make_optimizer(arch_id)
    opt_abs = opt.init(params_abs)
    opt_sh = shd.opt_state_shardings(opt_abs, params_abs, params_sh, mesh)

    batch_abs = {"tokens": _sds((B, S), torch.int32)}
    batch_sh = {"tokens": _named(mesh, shd.lm_batch_spec(mesh, B))}

    step = make_train_step(lambda p, b: tfm.lm_loss(p, cfg, b), opt)
    meta = _lm_model_flops(cfg, "train", B, S, params_abs)
    meta.update(optimizer=opt_name, n_layers=cfg.n_layers, variant=variant,
                sequence_parallel=bool(sp))
    return StepSpec(
        cell=f"{arch_id}/train", kind="train", fn=_with_act(step, mesh, sp=sp),
        abstract_args=(params_abs, opt_abs, batch_abs),
        in_shardings=(params_sh, opt_sh, batch_sh),
        out_shardings=(params_sh, opt_sh, _repl(mesh)),
        donate_argnums=(0, 1), meta=meta)


def _serve_params(cfg, mesh, layout: str = "2d"):
    """Serving weights in bf16, laid out 2-D (``"2d"``: TP on "model" plus
    "data" on the embed dim) or resident per TP group (``"tp"``)."""
    if layout == "tp":
        rules = shd.Rules({
            "embed": None, "embed2": None, "heads": "model",
            "kv_heads": "model", "mlp": "model", "vocab": "model",
            "expert": "model", "kv_lora": None,
            "table_rows": [("data", "model"), "data", "model"],
            "pos": None, "seq": None, "interests": None,
        })
    else:
        rules = shd.lm_serve_rules()
    shapes, axes = nn.abstract_init(tfm, cfg)
    shapes = _to_bf16(shapes)
    return shapes, shd.tree_shardings(shapes, axes, rules, mesh)


def _cache_abs(cfg, B: int, T: int):
    return tfm.init_cache(cfg, B, T, dtype=cfg.compute_dtype, device=META)


def _cache_sh(mesh, cache_abs, B: int):
    return pytree.tree_map(
        lambda t: _named(mesh, shd.cache_spec(mesh, tuple(t.shape), B)),
        cache_abs)


def lm_prefill_spec(arch_id: str, shape: dict, mesh: DeviceMesh, *,
                    variant: str = "full", cost_layers: int = 1,
                    serve_layout: str = "2d") -> StepSpec:
    B, S = shape["global_batch"], shape["seq_len"]
    cfg = _lm_cfg(arch_id, variant=variant, kind="prefill",
                  cost_layers=cost_layers)
    params_abs, params_sh = _serve_params(cfg, mesh, serve_layout)
    tokens_abs = _sds((B, S), torch.int32)
    tokens_sh = _named(mesh, shd.lm_batch_spec(mesh, B))

    def prefill_step(params, tokens):
        return tfm.prefill(params, cfg, tokens, max_len=S)

    cache_sh = _cache_sh(mesh, _cache_abs(cfg, B, S), B)
    meta = _lm_model_flops(cfg, "prefill", B, S, params_abs)
    meta.update(n_layers=cfg.n_layers, variant=variant)
    return StepSpec(
        cell=f"{arch_id}/prefill", kind="prefill",
        fn=_with_act(prefill_step, mesh),
        abstract_args=(params_abs, tokens_abs),
        in_shardings=(params_sh, tokens_sh),
        out_shardings=(_named(mesh, shd.lm_batch_spec(mesh, B)), cache_sh),
        donate_argnums=(), meta=meta)


def lm_decode_spec(arch_id: str, shape: dict, mesh: DeviceMesh, *,
                   variant: str = "full", cost_layers: int = 1,
                   serve_layout: str = "2d") -> StepSpec:
    B, T = shape["global_batch"], shape["seq_len"]
    cfg = _lm_cfg(arch_id, variant=variant, kind="decode",
                  cost_layers=cost_layers)
    params_abs, params_sh = _serve_params(cfg, mesh, serve_layout)
    cache_abs = _cache_abs(cfg, B, T)
    cache_sh = _cache_sh(mesh, cache_abs, B)
    tok_abs = _sds((B, 1), torch.int32)
    tok_sh = _named(mesh, shd.lm_batch_spec(mesh, B))
    idx_abs = _sds((), torch.int32)

    def decode(params, caches, token, index):
        # index: the reference's 0-d slot; the port's decode_step takes a
        # Python int, so the step writes the last position (module doc)
        del index
        return tfm.decode_step(params, cfg, caches, token, T - 1)

    meta = _lm_model_flops(cfg, "decode", B, T, params_abs)
    meta.update(n_layers=cfg.n_layers, variant=variant)
    return StepSpec(
        cell=f"{arch_id}/decode", kind="decode", fn=_with_act(decode, mesh),
        abstract_args=(params_abs, cache_abs, tok_abs, idx_abs),
        in_shardings=(params_sh, cache_sh, tok_sh, _repl(mesh)),
        out_shardings=(tok_sh, cache_sh),
        donate_argnums=(1,), meta=meta)


# ---------------------------------------------------------------------------
# GNN family (graphcast)
# ---------------------------------------------------------------------------


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _gnn_shapes(shape: dict, mesh: DeviceMesh) -> Tuple[int, int, int]:
    """(n_nodes, n_edges, d_feat) on device, padded to shard evenly."""
    n_dev = mesh.size
    if shape["kind"] == "minibatch":
        b, (f1, f2) = shape["batch_nodes"], shape["fanout"]
        n = b * (1 + f1 + f1 * f2)
        e = b * (f1 + f1 * f2)
        d = 602                              # reddit feature dim
    elif shape["kind"] == "batched_graphs":
        n = shape["batch"] * shape["n_nodes"]
        e = shape["batch"] * shape["n_edges"]
        d = 9                                # molecule atom features
    else:
        n, e, d = shape["n_nodes"], shape["n_edges"], shape.get("d_feat", 128)
    return _pad_to(n, n_dev), _pad_to(e, n_dev), d


def _row_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)


def gnn_train_spec(arch_id: str, shape: dict, mesh: DeviceMesh, *,
                   variant: str = "full", cost_layers: int = 1) -> StepSpec:
    cfg = registry.get(arch_id).full_config()
    N, E, d_feat = _gnn_shapes(shape, mesh)
    cfg = dataclasses.replace(cfg, d_feat=d_feat)
    if variant == "cost":
        cfg = dataclasses.replace(cfg, n_layers=cost_layers)

    shapes, axes = nn.abstract_init(gcast, cfg)
    rules = shd.lm_train_rules()
    params_sh = shd.tree_shardings(shapes, axes, rules, mesh)
    opt = optim.adamw(1e-3)
    opt_abs = opt.init(shapes)
    opt_sh = shd.opt_state_shardings(opt_abs, shapes, params_sh, mesh)

    row = _row_axes(mesh)
    batch_abs = {"node_feat": _sds((N, d_feat), torch.float32),
                 "src": _sds((E,), torch.int32),
                 "dst": _sds((E,), torch.int32),
                 "target": _sds((N, cfg.n_vars), torch.float32),
                 "node_mask": _sds((N,), torch.float32)}
    batch_sh = {key: _named(mesh, P(row)) for key in batch_abs}

    step = make_train_step(lambda p, b: gcast.loss_fn(p, cfg, b), opt)
    D = cfg.d_hidden

    def mlp2(d_in, d_out):
        return 2 * d_in * D + 2 * D * d_out

    fwd = (N * mlp2(d_feat, D) + E * mlp2(2 * D, D)          # encoders
           + cfg.n_layers * (E * mlp2(3 * D, D) + N * mlp2(2 * D, D))
           + N * mlp2(D, cfg.n_vars))                        # decoder
    meta = {"model_flops": 3.0 * fwd, "params": _count(shapes),
            "active_params": _count(shapes), "tokens": N,
            "n_layers": cfg.n_layers, "optimizer": "adamw",
            "variant": variant, "padded_nodes": N, "padded_edges": E}
    return StepSpec(
        cell=f"{arch_id}/train", kind="train", fn=_with_act(step, mesh),
        abstract_args=(shapes, opt_abs, batch_abs),
        in_shardings=(params_sh, opt_sh, batch_sh),
        out_shardings=(params_sh, opt_sh, _repl(mesh)),
        donate_argnums=(0, 1), meta=meta)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def _recsys_retrieval(cfg: rcs.RecsysConfig) -> Callable:
    """One query user against the candidate corpus, exact top 100."""
    from repro_torch.core.retrieval import topk_exact

    def retrieval_fn(params, b):
        u = rcs.user_embed(params, cfg, b["hist"])
        if u.ndim == 3:                       # mind interests -> rows
            u = u.reshape(-1, u.shape[-1])
        cand = rcs._item_table(params, cfg)[b["cand_ids"].long()].float()
        return topk_exact(u.float(), cand, k=100, block=65536)

    return retrieval_fn


def _recsys_batch(cfg: rcs.RecsysConfig, kind: str, shape: dict,
                  mesh: DeviceMesh) -> Tuple[dict, dict, Optional[Callable]]:
    """(abstract batch, shardings, fn(params, batch)); fn is None for
    training, which ``recsys_spec`` wraps in a train step."""
    dp = shd.batch_axes(mesh)
    dp_size = _mesh_size(mesh, dp)
    rep = P()

    def sh(spec):
        return _named(mesh, spec)

    if cfg.model_type == "deepfm":
        B = shape["n_candidates"] if kind == "retrieval" else shape["batch"]
        B = _pad_to(B, dp_size)
        F, M = cfg.n_fields, cfg.max_hot
        batch = {"ids": _sds((B, F, M), torch.int32),
                 "valid": _sds((B, F, M), torch.bool)}
        specs = {"ids": sh(P(dp)), "valid": sh(P(dp))}
        if kind == "train":
            batch["label"] = _sds((B,), torch.float32)
            specs["label"] = sh(P(dp))
            return batch, specs, None
        return batch, specs, \
            lambda p, b: rcs.deepfm_scores(p, cfg, b["ids"], b["valid"])

    S = cfg.seq_len
    if kind == "train":
        B = _pad_to(shape["batch"], dp_size)
        neg = _sds((cfg.n_negatives,), torch.int32)
        if cfg.model_type == "sasrec":
            batch = {"hist": _sds((B, S), torch.int32),
                     "pos": _sds((B, S), torch.int32), "neg_ids": neg}
        elif cfg.model_type == "bert4rec":
            M = max(1, S * 15 // 100)
            batch = {"tokens": _sds((B, S), torch.int32),
                     "mlm_positions": _sds((B, M), torch.int32),
                     "mlm_labels": _sds((B, M), torch.int32),
                     "mlm_mask": _sds((B, M), torch.float32),
                     "neg_ids": neg}
        else:  # mind
            batch = {"hist": _sds((B, S), torch.int32),
                     "target": _sds((B,), torch.int32), "neg_ids": neg}
        specs = {key: sh(P(dp)) for key in batch}
        specs["neg_ids"] = sh(rep)
        return batch, specs, None

    if kind == "serve":
        B = _pad_to(shape["batch"], dp_size)
        batch = {"hist": _sds((B, S), torch.int32),
                 "cand_ids": _sds((cfg.n_serve_candidates,), torch.int32)}
        specs = {"hist": sh(P(dp)), "cand_ids": sh(rep)}
        return batch, specs, lambda p, b: rcs.serve_fn(p, cfg, b)

    # retrieval: one query user against the full item corpus, exact top-k
    batch = {"hist": _sds((1, S), torch.int32),
             "cand_ids": _sds((shape["n_candidates"],), torch.int32)}
    specs = {"hist": sh(rep), "cand_ids": sh(P(dp))}
    return batch, specs, _recsys_retrieval(cfg)


def recsys_spec(arch_id: str, shape: dict, mesh: DeviceMesh, *,
                variant: str = "full", cost_layers: int = 1) -> StepSpec:
    cfg = registry.get(arch_id).full_config()
    if variant == "cost" and cfg.model_type in ("bert4rec", "sasrec"):
        cfg = dataclasses.replace(cfg, n_blocks=cost_layers)
    kind = shape["kind"]
    shapes, axes = nn.abstract_init(rcs, cfg)
    rules = shd.lm_train_rules() if kind == "train" else shd.lm_serve_rules()
    params_sh = shd.tree_shardings(shapes, axes, rules, mesh)
    batch_abs, batch_sh, serve_fn = _recsys_batch(cfg, kind, shape, mesh)

    total = _count(shapes)
    B = next(iter(batch_abs.values())).shape[0]
    D = cfg.embed_dim
    if cfg.model_type in ("bert4rec", "sasrec"):
        S = cfg.seq_len
        dense = cfg.n_blocks * (4 * D * D + 2 * D * (
            cfg.d_ff or (4 * D if cfg.model_type == "bert4rec" else D)))
        fwd = B * S * 2 * dense + B * cfg.n_blocks * 4 * S * S * D
    elif cfg.model_type == "mind":
        fwd = B * cfg.capsule_iters * 4 * cfg.n_interests * cfg.seq_len * D
    else:
        dims = (cfg.n_fields * D,) + tuple(cfg.mlp_dims) + (1,)
        fwd = B * sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    if kind == "retrieval" and cfg.model_type != "deepfm":
        fwd += 2 * shape["n_candidates"] * D
    mf = 3.0 * fwd if kind == "train" else float(fwd)

    meta = {"model_flops": mf, "params": total, "active_params": total,
            "tokens": B, "optimizer": "adamw", "variant": variant,
            "embedding_rows": (cfg.total_rows if cfg.model_type == "deepfm"
                               else cfg.item_vocab)}

    if kind == "train":
        opt = optim.adamw(1e-3)
        opt_abs = opt.init(shapes)
        opt_sh = shd.opt_state_shardings(opt_abs, shapes, params_sh, mesh)
        step = make_train_step(lambda p, b: rcs.loss_fn(p, cfg, b), opt)
        return StepSpec(
            cell=f"{arch_id}/train", kind="train", fn=step,
            abstract_args=(shapes, opt_abs, batch_abs),
            in_shardings=(params_sh, opt_sh, batch_sh),
            out_shardings=(params_sh, opt_sh, _repl(mesh)),
            donate_argnums=(0, 1), meta=meta)

    return StepSpec(
        cell=f"{arch_id}/{kind}", kind=kind, fn=_with_act(serve_fn, mesh),
        abstract_args=(shapes, batch_abs),
        in_shardings=(params_sh, batch_sh),
        out_shardings=None,
        donate_argnums=(), meta=meta)


# ---------------------------------------------------------------------------
# Bi-encoder (the paper's own architecture): train / encode / retrieve
# ---------------------------------------------------------------------------


def biencoder_spec_cell(arch_id: str, shape: dict, mesh: DeviceMesh, *,
                        variant: str = "full", cost_layers: int = 1,
                        encode_weights: str = "fsdp") -> StepSpec:
    cfg = registry.get(arch_id).full_config()
    if variant == "cost":
        cfg = dataclasses.replace(cfg, n_layers=cost_layers)
    kind = shape["kind"]
    if kind == "train":
        rules = shd.lm_train_rules()
    elif encode_weights == "replicated":
        rules = shd.Rules({}, default=None)
    else:
        rules = shd.fsdp_only_rules()
    shapes, axes = nn.abstract_init(tfm, cfg)
    if kind != "train" and encode_weights == "replicated":
        shapes = _to_bf16(shapes)
    params_sh = shd.tree_shardings(shapes, axes, rules, mesh)
    dp = shd.batch_axes(mesh)
    total = _count(shapes)

    if kind == "train":
        B, Lq, Lp, npsg = (shape["global_batch"], shape["q_len"],
                           shape["p_len"], shape["n_passages"])
        spec = biencoder_spec(cfg, q_max_len=Lq, p_max_len=Lp)
        batch_abs = {"q_tokens": _sds((B, Lq), torch.int32),
                     "q_mask": _sds((B, Lq), torch.bool),
                     "p_tokens": _sds((B, npsg, Lp), torch.int32),
                     "p_mask": _sds((B, npsg, Lp), torch.bool)}
        batch_sh = {key: _named(mesh, P(dp)) for key in batch_abs}
        opt = optim.adamw(2e-5)
        opt_abs = opt.init(shapes)
        opt_sh = shd.opt_state_shardings(opt_abs, shapes, params_sh, mesh)
        step = make_train_step(
            lambda p, b: contrastive_loss(p, spec, b), opt)
        tokens = B * (Lq + npsg * Lp)
        meta = {"model_flops": 6.0 * total * tokens, "params": total,
                "active_params": total, "tokens": tokens,
                "optimizer": "adamw", "variant": variant}
        return StepSpec(
            cell=f"{arch_id}/train", kind="train", fn=step,
            abstract_args=(shapes, opt_abs, batch_abs),
            in_shardings=(params_sh, opt_sh, batch_sh),
            out_shardings=(params_sh, opt_sh, _repl(mesh)),
            donate_argnums=(0, 1), meta=meta)

    row_all = _row_axes(mesh)
    if kind == "encode":
        B, Lp = shape["batch"], shape["p_len"]
        # corpus encoding is data-parallel: rows over the whole mesh
        batch_abs = (_sds((B, Lp), torch.int32), _sds((B, Lp), torch.bool))
        batch_sh = (_named(mesh, P(row_all)), _named(mesh, P(row_all)))
        enc_rules = _act_rules(mesh)
        enc_rules["act_batch"] = row_all

        def encode_step(params, tokens, mask):
            return tfm.encode(params, cfg, tokens, mask, "cls")

        tokens = B * Lp
        meta = {"model_flops": 2.0 * total * tokens, "params": total,
                "active_params": total, "tokens": tokens, "variant": variant}
        return StepSpec(
            cell=f"{arch_id}/encode", kind="encode",
            fn=_with_act(encode_step, mesh, enc_rules),
            abstract_args=(shapes,) + batch_abs,
            in_shardings=(params_sh,) + batch_sh,
            out_shardings=_named(mesh, P(row_all)),
            donate_argnums=(), meta=meta)

    # retrieve: sharded exact MIPS over the encoded corpus
    nq, corpus, dim, k = (shape["n_queries"], shape["corpus"], shape["dim"],
                          shape["k"])
    corpus = _pad_to(corpus, mesh.size)
    q_abs = _sds((_pad_to(nq, 1), dim), torch.float32)
    c_abs = _sds((corpus, dim), torch.float32)

    def retrieve_step(q, c):
        # per-shard top-k over the corpus rows split on the mesh, then a
        # merge one mesh axis at a time (the reference's hierarchical one)
        from repro_torch.core.retrieval import topk_sharded
        return topk_sharded(mesh, q, c, k=k, axis_names=row_all,
                            block=65536)

    meta = {"model_flops": 2.0 * nq * corpus * dim, "params": 0,
            "active_params": 0, "tokens": nq, "variant": variant,
            "corpus_padded": corpus}
    return StepSpec(
        cell=f"{arch_id}/retrieve", kind="retrieval",
        fn=_with_act(retrieve_step, mesh),
        abstract_args=(q_abs, c_abs),
        in_shardings=(_repl(mesh), _named(mesh, P(row_all))),
        out_shardings=None,
        donate_argnums=(), meta=meta)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_LM_KIND_BUILDER = {"train": lm_train_spec, "prefill": lm_prefill_spec,
                    "decode": lm_decode_spec}


def build_step(arch_id: str, shape_name: str, mesh: DeviceMesh, *,
               variant: str = "full", cost_layers: int = 1,
               sp=None, serve_layout: str = "2d",
               cfg_overrides: Optional[Dict[str, Any]] = None) -> StepSpec:
    spec = registry.get(arch_id)
    shape = spec.shapes[shape_name]
    kw = dict(variant=variant, cost_layers=cost_layers)
    if spec.family == "lm":
        if shape["kind"] == "train":
            if sp is not None:
                kw["sp"] = sp
            if cfg_overrides:
                kw["cfg_overrides"] = cfg_overrides
        else:
            kw["serve_layout"] = serve_layout
        s = _LM_KIND_BUILDER[shape["kind"]](arch_id, shape, mesh, **kw)
    elif spec.family == "gnn":
        s = gnn_train_spec(arch_id, shape, mesh, **kw)
    elif spec.family == "recsys":
        s = recsys_spec(arch_id, shape, mesh, **kw)
    elif spec.family == "biencoder":
        if cfg_overrides and "encode_weights" in cfg_overrides:
            kw["encode_weights"] = cfg_overrides["encode_weights"]
        s = biencoder_spec_cell(arch_id, shape, mesh, **kw)
    else:
        raise ValueError(spec.family)
    s.cell = f"{arch_id}/{shape_name}"
    return s


def all_cells(include_paper_arch: bool = True):
    archs = list(registry.ASSIGNED_ARCH_IDS)
    if include_paper_arch:
        archs.append("dr-bert-base")
    return [(a, sname) for a in archs for sname in registry.get(a).shapes]
