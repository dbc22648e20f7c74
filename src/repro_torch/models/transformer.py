"""The JAX package's transformer trunk (``repro/models/transformer.py``) in
PyTorch: one code path for the LM family and the BERT-style encoder.

  * dense LMs (qwen2-0.5b / 72b, deepseek-67b): pre-RMSNorm layers, GQA with
    optional QKV bias, rotary embeddings, SwiGLU MLPs, causal attention,
    tied or untied LM head, KV caches for prefill and decode;
  * arctic-480b: the same layers with a 128-expert top-2 MoE as a
    *residual* branch beside the dense MLP (``moe_mode="residual"``);
  * deepseek-v2-lite-16b: multi-head latent attention (MLA: a compressed
    ``(c_kv, k_rope)`` cache, absorbed decode) and a 64-expert top-6 MoE
    with 2 shared experts after ``first_k_dense`` dense layers;
  * the dense retriever's BERT encoder (dr-bert-base): post-LN layers,
    learned positions, GELU (tanh) MLPs, bidirectional attention with a key
    mask, then ``encode``.

The config's defaults are the reference's, so a config file copied across
builds the same model.  The reference's JAX-only execution knobs have no
counterpart here: ``remat`` and the ``*_unroll`` cost-extraction unrolls
(PyTorch runs the layers and chunks in Python loops), and
``attn_expand_kv``, which lays repeated KV heads out on a sharded TPU mesh
axis; on one card it computes what the grouped path computes.

Parameters keep the reference's key paths and its stacked leading ``L``
axis (``embed``, ``pos_embed``, ``dense_layers`` and, for an MoE config,
``moe_layers``, each ``{attn, attn_norm, mlp, mlp_norm, moe}``,
``final_norm``, ``lm_head``), so the JAX package's parameter trees and
checkpoints load without renaming (:func:`params_from_numpy`).  The MoE
router is f32 whatever ``param_dtype`` is, as the reference's
(:func:`param_dtypes`).

Attention follows the reference's dispatch.  With ``attn_impl="cuda"`` (the
reference's ``"pallas"``), no KV cache and no key mask, GQA attention goes
to the flash-attention kernel (``kernels/flash_attention``).  With
``"cuda"``, a KV cache, one query token and no caller's key mask (the
decode step), it goes to the decode-attention kernel
(``kernels/decode_attention``) over the cache's valid prefix
``[0, cache_index + 1)``: the call site that the reference's comment names
for its decode kernel, computing what the reference's ``decode_step``
computes, with p kept in f32 as in the kernel.  Everything else (prefill,
masked calls, ``"torch"``) goes to :func:`_chunked_attention`, the
reference's XLA path: query chunks of ``q_chunk`` rows, compute-dtype
operands multiplied into f32 sums, masked keys at ``-1e30``, softmax in
f32, the probabilities cast to the value dtype before the second product.
Those products run as f32 matmuls of compute-dtype values, which is exact
for bf16 inputs and so is the reference's "bf16 operands, f32
accumulation".  MLA never reaches either kernel, under any ``attn_impl``:
its qk dim (``qk_nope_dim + qk_rope_dim``) is not its v dim, and the
reference sends it to the chunked path in prefill and to plain products
against the compressed cache in decode.

The MoE block is the reference's token-choice top-k with sort-based
dispatch (:func:`_moe_dispatch`), each batch row a routing group with
``capacity`` slots per expert; tokens past an expert's capacity are
dropped.  The expert SwiGLU runs as batched products over the experts, and
the combine back to ``(S, D)`` gathers each token's K slots and sums them in
a fixed order, which is deterministic on a card (the reference
scatter-adds slots in slot order: the sums agree to rounding).  Routing
ties: ``jax.lax.top_k`` puts the lower expert first among equal
probabilities and ``torch.topk`` on a card does not promise that, so equal
router probabilities may route differently; random routers have none.

KV caches are updated in place (the reference returns new arrays): the
caches that ``prefill`` and ``decode_step`` return are the tensors they were
given, written at ``cache_index``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import nn


@dataclasses.dataclass
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    vocab_size: int = 1000
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    causal: bool = True
    act: str = "swiglu"                 # swiglu | gelu
    use_rope: bool = True
    max_position_embeddings: int = 0    # learned positions when >0 (BERT)
    norm_style: str = "pre"             # pre (rms) | post (layernorm, BERT)
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_mode: str = "replace"           # replace | residual (arctic)
    moe_capacity_factor: float = 1.25
    first_k_dense: int = 0
    router_aux_coef: float = 0.01
    # --- MLA ---
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- execution ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    q_chunk: int = 512                  # attention query-chunk size
    vocab_chunk: int = 0                # 0 = full logits; >0 = chunked xent
    attn_impl: str = "torch"            # torch | cuda (flash, decode kernels)

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0


def _check(cfg: TransformerConfig) -> None:
    for field, allowed in (("act", ("swiglu", "gelu")),
                           ("norm_style", ("pre", "post")),
                           ("moe_mode", ("replace", "residual")),
                           ("attn_impl", ("torch", "cuda"))):
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"{cfg.name}: {field}={getattr(cfg, field)!r}, "
                             f"expected one of {allowed}")


def _group_sizes(cfg: TransformerConfig):
    """(dense layers, MoE layers): an MoE config's first ``first_k_dense``
    layers are dense, the rest MoE."""
    n_dense = cfg.first_k_dense if cfg.is_moe else cfg.n_layers
    return n_dense, cfg.n_layers - n_dense


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's structure with each leaf's shape — the template
    :func:`repro_torch.ckpt.checkpoint.restore` reads a checkpoint with.
    A layer group with no layers (``dense_layers`` of arctic) is absent, as
    in the reference.  Allocates nothing."""
    _check(cfg)
    D, V, H = cfg.d_model, cfg.vocab_size, cfg.n_heads
    Hd, KVd = H * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    post = cfg.norm_style == "post"

    def norm(*lead):
        shapes = {"scale": (*lead, D)}
        if post:
            shapes["bias"] = (*lead, D)
        return shapes

    def mlp(L, F):
        if cfg.act == "swiglu":
            return {"w1": (L, D, F), "w3": (L, D, F), "w2": (L, F, D)}
        return {"w1": {"w": (L, D, F), "b": (L, F)},
                "w2": {"w": (L, F, D), "b": (L, D)}}

    def attn(L):
        if cfg.mla:
            R, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
            return {"wq": (L, D, H * (dn + dr)), "wdkv": (L, D, R + dr),
                    "kv_norm": {"scale": (L, R)},
                    "wuk": (L, R, H * dn), "wuv": (L, R, H * cfg.v_head_dim),
                    "wo": (L, H * cfg.v_head_dim, D)}
        shapes = {"wq": (L, D, Hd), "wk": (L, D, KVd), "wv": (L, D, KVd),
                  "wo": (L, Hd, D)}
        if cfg.qkv_bias:
            shapes.update(bq=(L, Hd), bk=(L, KVd), bv=(L, KVd))
        return shapes

    def stack(L, moe):
        layer = {"attn": attn(L), "attn_norm": norm(L), "mlp_norm": norm(L)}
        if moe:
            E, F = cfg.moe_num_experts, cfg.moe_d_ff
            layer["moe"] = {"router": (L, D, E), "w1": (L, E, D, F),
                            "w3": (L, E, D, F), "w2": (L, E, F, D)}
            if cfg.moe_num_shared:
                layer["moe"]["shared"] = mlp(L, cfg.moe_num_shared * F)
        if not moe or cfg.moe_mode == "residual":
            layer["mlp"] = mlp(L, cfg.d_ff)
        return layer

    n_dense, n_moe = _group_sizes(cfg)
    shapes = {"embed": {"table": (V, D)}, "final_norm": norm()}
    if n_dense:
        shapes["dense_layers"] = stack(n_dense, moe=False)
    if n_moe:
        shapes["moe_layers"] = stack(n_moe, moe=True)
    if cfg.max_position_embeddings:
        shapes["pos_embed"] = {"table": (cfg.max_position_embeddings, D)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"w": (D, V)}
    return shapes


def param_dtypes(cfg: TransformerConfig) -> Dict[str, Any]:
    """:func:`param_shapes`' tree with each leaf's dtype: ``param_dtype``,
    except the MoE router, which the reference keeps in f32."""
    def build(node, name):
        if isinstance(node, dict):
            return {key: build(val, key) for key, val in node.items()}
        return torch.float32 if name == "router" else cfg.param_dtype

    return build(param_shapes(cfg), "")


def init_std(name: str, shape) -> float:
    """The standard deviation the reference's init draws a weight leaf
    with: 0.02 for embedding tables and the MoE router, 1/sqrt(fan_in)
    (:func:`~repro_torch.models.nn.fan_in_std`) for the rest."""
    return 0.02 if name in ("table", "router") else nn.fan_in_std(shape)


def init_numpy(cfg: TransformerConfig, seed: int) -> Dict[str, Any]:
    """Random parameters as nested dicts of numpy f32 arrays, drawn from
    ``numpy.random.default_rng(seed)``: norm scales 1, biases 0, weights
    N(0, :func:`init_std`).  The scheme is the reference's; the numbers
    are not (JAX draws from its own generator)."""
    return nn.init_numpy(param_shapes(cfg), seed, init_std)


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (nested dicts of numpy arrays, as
    ``repro.ckpt.restore`` or ``nn.materialize(tfm.init(...))`` gives it;
    tensors are taken too) of either family, dense or MoE, GQA or MLA ->
    the port's parameters on ``device``, with the same key paths and
    dtypes."""
    missing = [key for key in ("embed", "final_norm") if key not in tree]
    if "dense_layers" not in tree and "moe_layers" not in tree:
        missing.append("dense_layers or moe_layers")
    if missing:
        raise ValueError(f"not a transformer parameter tree: missing "
                         f"{missing}")
    return nn.to_torch_tree(tree, device)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _norm(p, x, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.norm_style == "post":
        return nn.layernorm(p, x, cfg.norm_eps)
    return nn.rmsnorm(p, x, cfg.norm_eps)


def _chunked_attention(q, k, v, *, causal: bool, q_offset: int,
                       q_chunk: int, kv_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Grouped-query attention in query chunks.

    q (B, S, KV, G, hd); k, v (B, T, KV, hd); ``q_offset`` is the absolute
    position of q[:, 0] (for the causal mask in decode); ``kv_mask`` an
    optional (B or 1, T) validity mask.  Returns (B, S, KV, G, hd) in v's
    dtype."""
    S, hd = q.shape[1], q.shape[-1]
    T = k.shape[1]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32).to(q.dtype)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(T, device=q.device)
    nq = max(1, min(q_chunk, S))
    outs = []
    for s0 in range(0, S, nq):
        qi = q[:, s0:s0 + nq] * scale
        s = torch.einsum("bqkgd,btkd->bkgqt", qi.float(), kf)
        if causal:
            qpos = q_offset + s0 + torch.arange(qi.shape[1], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask[:, None, None, None, :], -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), vf)
        outs.append(o.to(v.dtype))
    return torch.cat(outs, dim=1)


def _attention(p, x, cfg: TransformerConfig, *, positions, cache=None,
               cache_index: Optional[int] = None, kv_mask=None):
    """GQA attention of one layer. Returns (out, cache)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q, k, v = (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
               v.reshape(B, S, KV, hd))
    if cfg.use_rope:
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)

    # the cached single-token step without a caller's mask: decode kernel
    decode = cfg.attn_impl == "cuda" and cache is not None and S == 1 \
        and kv_mask is None
    q_offset = 0
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        k_all, v_all = ck.to(cd), cv.to(cd)
        # positions < cache_index + S are populated (prefill writes S at once)
        valid = torch.arange(ck.shape[1], device=x.device)[None, :] \
            < cache_index + S
        kv_mask = valid if kv_mask is None else kv_mask & valid
        q_offset = cache_index
    else:
        k_all, v_all = k, v

    if decode:
        # query head h = kv * G + g reads KV head h // G, as the reshape
        # puts it; keys t <= cache_index are the written prefix
        o = decode_attention(q.reshape(B, KV, H // KV, hd),
                             k_all.transpose(1, 2), v_all.transpose(1, 2),
                             cache_index + 1)
        out = o.reshape(B, S, H * hd)
    elif cfg.attn_impl == "cuda" and cache is None and kv_mask is None:
        o = flash_attention(q.transpose(1, 2), k_all.transpose(1, 2),
                            v_all.transpose(1, 2), causal=cfg.causal)
        out = o.transpose(1, 2)
    else:
        out = _chunked_attention(
            q.reshape(B, S, KV, H // KV, hd), k_all, v_all,
            causal=cfg.causal, q_offset=q_offset, q_chunk=cfg.q_chunk,
            kv_mask=kv_mask)
    return out.reshape(B, S, H * hd) @ p["wo"].to(cd), cache


def _mla_attention(p, x, cfg: TransformerConfig, *, positions, cache=None,
                   cache_index: Optional[int] = None, kv_mask=None):
    """Multi-head latent attention (DeepSeek-V2); the cache holds
    ``(c_kv, k_rope)``.  Returns (out, cache).

    Train and prefill expand ``c_kv`` to per-head K_nope and V and run
    :func:`_chunked_attention` (H KV heads of qk dim ``dn + dr`` and v dim
    ``dv``).  A cached single-token step runs the *absorbed* form: the
    query is projected into the ``kv_lora_rank`` space and attends to the
    compressed cache directly.  Neither reaches an attention kernel."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, R = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = nn.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    dkv = x @ p["wdkv"].to(cd)                             # (B, S, R + dr)
    c_kv = nn.rmsnorm(p["kv_norm"], dkv[..., :R], cfg.norm_eps)
    k_rope = nn.apply_rope(dkv[..., R:].reshape(B, S, 1, dr), positions,
                           cfg.rope_theta)

    if cache is not None:
        cc, cr = cache["ckv"], cache["krope"]
        cc[:, cache_index:cache_index + S] = c_kv.to(cc.dtype)
        cr[:, cache_index:cache_index + S] = k_rope[:, :, 0].to(cr.dtype)
    if cache is not None and S == 1:
        # absorbed decode: attention in the compressed space
        # the reference's f32 1 / sqrt(dn + dr), as a Python scalar
        scale = float(np.float32(1.0) / np.sqrt(np.float32(dn + dr)))
        T = cc.shape[1]
        valid = torch.arange(T, device=x.device)[None, :] <= cache_index
        if kv_mask is not None:
            valid = valid & kv_mask
        wuk = p["wuk"].to(cd).reshape(R, H, dn)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wuk)
        # compute-dtype operands, f32 sums (as _chunked_attention)
        s = torch.einsum("bshr,btr->bhst", q_lat.float(), cc.float())
        s = s + torch.einsum("bshd,btd->bhst", q_rope.float(), cr.float())
        s = s * scale
        s = s.masked_fill(~valid[:, None, None, :], -1e30)
        prob = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", prob.to(cd), cc.to(cd))
        wuv = p["wuv"].to(cd).reshape(R, H, dv)
        out = torch.einsum("bshr,rhd->bshd", ctx, wuv)
    else:
        # train / prefill: expand the compressed kv, chunked attention
        q_offset = 0
        if cache is not None:
            c_all, r_all = cc.to(cd), cr.to(cd)[:, :, None]
            valid = torch.arange(cc.shape[1], device=x.device)[None, :] \
                < cache_index + S
            kv_mask = valid if kv_mask is None else kv_mask & valid
            q_offset = cache_index
        else:
            c_all, r_all = c_kv, k_rope
        T = c_all.shape[1]
        k_nope = (c_all @ p["wuk"].to(cd)).reshape(B, T, H, dn)
        vv = (c_all @ p["wuv"].to(cd)).reshape(B, T, H, dv)
        k = torch.cat([k_nope, r_all.expand(B, T, H, dr)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        # H KV heads, no grouping: KV = H, G = 1
        out = _chunked_attention(
            qq.reshape(B, S, H, 1, dn + dr), k, vv, causal=cfg.causal,
            q_offset=q_offset, q_chunk=cfg.q_chunk, kv_mask=kv_mask)
    return out.reshape(B, S, H * dv) @ p["wo"].to(cd), cache


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------


def _dense_mlp(p, x, cfg: TransformerConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.act == "swiglu":
        h = nn.silu(x @ p["w1"].to(cd)) * (x @ p["w3"].to(cd))
        return h @ p["w2"].to(cd)
    h = nn.gelu(nn.linear(p["w1"], x, cd))
    return nn.linear(p["w2"], h, cd)


def moe_capacity(cfg: TransformerConfig, S: int) -> int:
    """Slots per expert in a routing group of ``S`` tokens, with the
    reference's Python float arithmetic."""
    return max(1, int(S * cfg.moe_top_k / cfg.moe_num_experts
                      * cfg.moe_capacity_factor))


def _moe_dispatch(x_flat, expert_idx, gates, E: int, capacity: int):
    """Sort-based dispatch of routing groups.

    x_flat (..., S, D); expert_idx and gates (..., S, K); each leading index
    is one group (the reference vmaps its one-group function over them).
    Assignments are sorted stably by expert, so an expert's slots go to its
    tokens in (token, k) order and those past ``capacity`` are dropped.
    Returns (xe (..., E, C, D), slot_tok (..., E*C) int64, slot_gate
    (..., E*C) in gates' dtype, slot_valid (..., E*C) bool, tok_slot
    (..., S, K) int64): the reference's four and, for the combine, each
    assignment's slot in the flattened ``(groups * E * C)`` slots, or
    ``groups * E * C`` when it was dropped.  Empty slots hold token 0 with
    gate 0, as the reference's."""
    lead, (S, K), D = expert_idx.shape[:-2], expert_idx.shape[-2:], \
        x_flat.shape[-1]
    G = int(np.prod(lead, dtype=np.int64))
    N, C, dev = S * K, capacity, expert_idx.device
    # group g's expert e sorts as g * E + e, so one stable sort orders the
    # groups and, within each, the experts
    key = (expert_idx.reshape(G, N).long()
           + E * torch.arange(G, device=dev)[:, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    stok = (order % N) // K                   # the group-local token
    # each (group, expert)'s first sorted position; searchsorted over the
    # sorted keys, where a bincount would read its size back to the host
    starts = torch.searchsorted(sk, torch.arange(G * E, device=dev))
    pos = torch.arange(G * N, device=dev) - starts[sk]
    keep = pos < C
    overflow = G * E * C                      # dropped -> sliced away
    slot = torch.where(keep, sk * C + pos, overflow)
    slot_tok = torch.zeros(overflow + 1, dtype=torch.long, device=dev)
    slot_tok[slot] = stok
    slot_gate = torch.zeros(overflow + 1, dtype=gates.dtype, device=dev)
    slot_gate[slot] = gates.reshape(-1)[order]
    slot_valid = torch.zeros(overflow + 1, dtype=torch.bool, device=dev)
    slot_valid[slot] = keep
    slot_tok, slot_gate, slot_valid = (slot_tok[:-1].reshape(G, E * C),
                                       slot_gate[:-1].reshape(G, E * C),
                                       slot_valid[:-1].reshape(G, E * C))
    tok_slot = torch.empty_like(slot)
    tok_slot[order] = slot
    xe = x_flat.reshape(G, S, D)[torch.arange(G, device=dev)[:, None],
                                 slot_tok]
    return (xe.reshape(*lead, E, C, D), slot_tok.reshape(*lead, E * C),
            slot_gate.reshape(*lead, E * C), slot_valid.reshape(*lead, E * C),
            tok_slot.reshape(*lead, S, K))


#: the most elements of one expert weight cast to the compute dtype at once
_EXPERT_BLOCK_ELEMENTS = 1 << 28


def _expert_swiglu(p, xt: torch.Tensor, cd) -> torch.Tensor:
    """xt (E, N, D) -> (E, N, D): each expert's SwiGLU on its N rows, as
    batched products.  Weights already in the compute dtype go in one
    product each; others are cast a block of experts at a time (at most
    ``_EXPERT_BLOCK_ELEMENTS`` elements a weight), so an f32 computation
    over bf16 weights never holds an f32 copy of every expert."""
    E, D, F = p["w1"].shape
    step = E if p["w1"].dtype == cd \
        else max(1, _EXPERT_BLOCK_ELEMENTS // (D * F))
    outs = []
    for e0 in range(0, E, step):
        x = xt[e0:e0 + step]
        w1, w3, w2 = (p[key][e0:e0 + step].to(cd) for key in ("w1", "w3",
                                                              "w2"))
        outs.append(torch.bmm(nn.silu(torch.bmm(x, w1)) * torch.bmm(x, w3),
                              w2))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _moe_block(p, x, cfg: TransformerConfig):
    """Token-choice top-k MoE with sort-based dispatch; each batch row is a
    routing group.  x (B, S, D) -> (out (B, S, D), aux loss).

    Router logits, softmax and top-k in f32, the top-k gates renormalised
    and cast to the compute dtype; the GShard load-balancing loss
    ``E * sum_e f_e * p_e`` (f_e the top-1 share, p_e the mean
    probability); the expert SwiGLU as batched products over the experts;
    the combine sums each token's K weighted slot outputs in k order."""
    B, S, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    cd = cfg.compute_dtype
    C = moe_capacity(cfg, S)
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    gates, expert_idx = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(dim=(0, 1))
    fe = torch.nn.functional.one_hot(expert_idx[..., 0], E).float() \
        .mean(dim=(0, 1))
    aux = E * (me * fe).sum()

    xe, _, slot_gate, slot_valid, tok_slot = _moe_dispatch(
        x.to(cd), expert_idx, gates.to(cd), E, C)
    # (B, E, C, D) -> (E, B*C, D): batched products over the experts
    oe = _expert_swiglu(p, xe.transpose(0, 1).reshape(E, B * C, D), cd)
    oe = oe.reshape(E, B, C, D).transpose(0, 1)
    wgt = (slot_gate * slot_valid.to(cd)).reshape(B, E, C)
    oe = (oe * wgt[..., None]).reshape(B * E * C, D)
    # combine: gather each token's K slots (dropped -> a zero row), sum
    oe = torch.cat([oe, oe.new_zeros(1, D)])
    out = oe[tok_slot].sum(dim=-2)                          # (B, S, D)
    if cfg.moe_num_shared:
        out = out + _dense_mlp(p["shared"], x, cfg)
    return out, aux


# ---------------------------------------------------------------------------
# Layers and the trunk
# ---------------------------------------------------------------------------


def _layer(p, x, cfg: TransformerConfig, *, positions, moe: bool = False,
           cache=None, cache_index=None, kv_mask=None):
    """One layer. Returns (x, cache, aux loss: 0 unless ``moe``)."""
    attn_fn = _mla_attention if cfg.mla else _attention
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.norm_style == "post":
        a, cache = attn_fn(p["attn"], x, cfg, positions=positions,
                           cache=cache, cache_index=cache_index,
                           kv_mask=kv_mask)
        x = _norm(p["attn_norm"], x + a, cfg)
        return _norm(p["mlp_norm"], x + _dense_mlp(p["mlp"], x, cfg),
                     cfg), cache, aux
    a, cache = attn_fn(p["attn"], _norm(p["attn_norm"], x, cfg), cfg,
                       positions=positions, cache=cache,
                       cache_index=cache_index, kv_mask=kv_mask)
    x = x + a
    h = _norm(p["mlp_norm"], x, cfg)
    if moe:
        mo, aux = _moe_block(p["moe"], h, cfg)
        if cfg.moe_mode == "residual":
            mo = mo + _dense_mlp(p["mlp"], h, cfg)
    else:
        mo = _dense_mlp(p["mlp"], h, cfg)
    return x + mo, cache, aux


def forward(params, cfg: TransformerConfig, tokens: torch.Tensor, *,
            caches=None, cache_index: Optional[int] = None,
            kv_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Run the trunk: the dense layer group, then the MoE group.  Returns
    (hidden (B, S, D) in the compute dtype, caches (written in place) or
    None, the MoE layers' summed aux loss (0 without MoE))."""
    _check(cfg)
    S = tokens.shape[1]
    cd = cfg.compute_dtype
    x = nn.embedding(params["embed"], tokens, cd)
    if positions is None:       # (1, S): broadcast over the batch
        positions = torch.arange(S, device=tokens.device)[None, :] \
            + (cache_index or 0)
    if cfg.max_position_embeddings:
        x = x + nn.embedding(params["pos_embed"], positions, cd)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for group, moe in (("dense", False), ("moe", True)):
        stack = params.get(f"{group}_layers")
        if stack is None:
            continue
        group_caches = caches.get(group) if caches is not None else None
        n = stack["attn_norm"]["scale"].shape[0]
        group_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(nn.unstack(stack, n)):
            cache = None if group_caches is None else \
                {key: t[i] for key, t in group_caches.items()}
            x, _, aux = _layer(layer, x, cfg, positions=positions, moe=moe,
                               cache=cache, cache_index=cache_index,
                               kv_mask=kv_mask)
            group_aux = group_aux + aux
        aux_total = aux_total + group_aux
    return _norm(params["final_norm"], x, cfg), caches, aux_total


def _lm_head_weight(params, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def logits(params, cfg: TransformerConfig, hidden: torch.Tensor
           ) -> torch.Tensor:
    return hidden @ _lm_head_weight(params, cfg).to(cfg.compute_dtype)


def chunked_softmax_xent(hidden, w_lm, labels, mask, chunk: int
                         ) -> torch.Tensor:
    """Cross-entropy without the full (..., V) logits: a running logsumexp
    and the label's logit over vocab chunks of ``chunk`` columns.

    hidden (..., D); w_lm (D, V); labels (...,) int; mask (...,) bool."""
    V = w_lm.shape[1]
    lse = torch.full(labels.shape, float("-inf"), device=hidden.device)
    lab = torch.full(labels.shape, float("-inf"), device=hidden.device)
    labels = labels.long()
    for base in range(0, V, chunk):
        lg = (hidden @ w_lm[:, base:base + chunk]).float()
        width = lg.shape[-1]
        lse = torch.logaddexp(lse, torch.logsumexp(lg, dim=-1))
        local = labels - base
        got = lg.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
        lab = torch.where((local >= 0) & (local < width), got, lab)
    nll = (lse - lab) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def lm_loss(params, cfg: TransformerConfig, batch):
    """Causal LM loss. batch: {"tokens": (B, S) int} (optionally "mask").
    Returns (loss, {"xent", "aux"})."""
    tokens = batch["tokens"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(tokens, dtype=torch.bool)
    hidden, _, aux = forward(params, cfg, tokens)
    tgt = tokens[:, 1:]
    h = hidden[:, :-1]
    m = mask[:, 1:] & mask[:, :-1]
    w = _lm_head_weight(params, cfg).to(cfg.compute_dtype)
    if cfg.vocab_chunk:
        xent = chunked_softmax_xent(h, w, tgt, m, cfg.vocab_chunk)
    else:
        lg = (h @ w).float()                               # (B, S-1, V)
        lse = torch.logsumexp(lg, dim=-1)
        lab = lg.gather(-1, tgt.long()[..., None])[..., 0]
        xent = ((lse - lab) * m).sum() / m.sum().clamp(min=1)
    loss = xent + cfg.router_aux_coef * aux
    return loss, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed caches stacked per layer group, as the reference's:
    ``{"dense", "moe"}``, None for a group without layers.  GQA caches hold
    ``k``, ``v`` (n, B, T, KV, hd); MLA caches ``ckv`` (n, B, T,
    kv_lora_rank) and ``krope`` (n, B, T, qk_rope_dim)."""
    def one(n):
        if n == 0:
            return None
        if cfg.mla:
            shapes = {"ckv": (n, batch, max_len, cfg.kv_lora_rank),
                      "krope": (n, batch, max_len, cfg.qk_rope_dim)}
        else:
            kv = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            shapes = {"k": kv, "v": kv}
        return {key: torch.zeros(shape, dtype=dtype, device=device)
                for key, shape in shapes.items()}

    n_dense, n_moe = _group_sizes(cfg)
    return {"dense": one(n_dense), "moe": one(n_moe)}


def prefill(params, cfg: TransformerConfig, tokens: torch.Tensor,
            max_len: int = 0):
    """Encode a prompt, returning (last-token logits (B, 1, V), caches).

    max_len: cache capacity (0 -> prompt length; set larger to decode
    after)."""
    B, S = tokens.shape
    caches = init_cache(cfg, B, max(max_len, S), dtype=cfg.compute_dtype,
                        device=tokens.device)
    hidden, caches, _ = forward(params, cfg, tokens, caches=caches,
                                cache_index=0)
    return logits(params, cfg, hidden[:, -1:]), caches


def decode_step(params, cfg: TransformerConfig, caches, token: torch.Tensor,
                index: int):
    """One decode step. token (B, 1) int; index: the position to write."""
    hidden, caches, _ = forward(params, cfg, token, caches=caches,
                                cache_index=index)
    return logits(params, cfg, hidden), caches


# ---------------------------------------------------------------------------
# Embedding/encoding entry point (dense-retriever usage)
# ---------------------------------------------------------------------------


def encode(params, cfg: TransformerConfig, tokens: torch.Tensor,
           mask: torch.Tensor, pooling: str = "mean") -> torch.Tensor:
    """Embed token sequences -> (B, D) L2-normalized f32 vectors (CLS or
    masked-mean pooling, as ``repro.models.transformer.encode``)."""
    hidden, _, _ = forward(params, cfg, tokens, kv_mask=mask)
    if pooling == "cls":
        emb = hidden[:, 0]
    else:
        m = mask.to(hidden.dtype)[..., None]
        emb = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    emb = emb.float()
    return emb / torch.clamp(emb.norm(dim=-1, keepdim=True), min=1e-6)
