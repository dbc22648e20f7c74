"""The JAX package's transformer trunk (``repro/models/transformer.py``) in
PyTorch: one code path for the dense LM family and the BERT-style encoder.

  * dense LMs (qwen2-0.5b / 72b, deepseek-67b): pre-RMSNorm layers, GQA with
    optional QKV bias, rotary embeddings, SwiGLU MLPs, causal attention,
    tied or untied LM head, KV caches for prefill and decode;
  * the dense retriever's BERT encoder (dr-bert-base): post-LN layers,
    learned positions, GELU (tanh) MLPs, bidirectional attention with a key
    mask, then ``encode``.

The config's defaults are the reference's, so a config file copied across
builds the same model.  MoE and MLA wait for the slice that ports them
(``ROADMAP.md`` A13): a config asking for either (``moe_num_experts``,
``mla``) raises, and their other fields come with that slice.  The
reference's JAX-only execution knobs have no counterpart here: ``remat``
and the ``*_unroll`` cost-extraction unrolls (PyTorch runs the layers and
chunks in Python loops), and ``attn_expand_kv``, which lays repeated KV
heads out on a sharded TPU mesh axis; on one card it computes what the
grouped path computes.

Parameters keep the reference's key paths and its stacked leading ``L``
axis (``embed``, ``pos_embed``, ``dense_layers/{attn,attn_norm,mlp,
mlp_norm}``, ``final_norm``, ``lm_head``), so the JAX package's parameter
trees and checkpoints load without renaming (:func:`params_from_numpy`).

Attention follows the reference's dispatch.  With ``attn_impl="cuda"`` (the
reference's ``"pallas"``), no KV cache and no key mask, it goes to the
flash-attention kernel (``kernels/flash_attention``).  With ``"cuda"``, a KV
cache, one query token and no caller's key mask (the decode step), it goes
to the decode-attention kernel (``kernels/decode_attention``) over the
cache's valid prefix ``[0, cache_index + 1)``: the call site that the
reference's comment names for its decode kernel, computing what the
reference's ``decode_step`` computes, with p kept in f32 as in the kernel.
Everything else (prefill, masked calls, ``"torch"``) goes
to :func:`_chunked_attention`, the reference's XLA path: query chunks of
``q_chunk`` rows, compute-dtype operands multiplied into f32 sums, masked
keys at ``-1e30``, softmax in f32, the probabilities cast to the value
dtype before the second product.  Those products run as f32 matmuls of
compute-dtype values, which is exact for bf16 inputs and so is the
reference's "bf16 operands, f32 accumulation".

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
    # --- MoE and MLA: not ported yet (a config that sets them raises) ---
    moe_num_experts: int = 0
    mla: bool = False
    # --- execution ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    q_chunk: int = 512                  # attention query-chunk size
    vocab_chunk: int = 0                # 0 = full logits; >0 = chunked xent
    attn_impl: str = "torch"            # torch | cuda (flash, decode kernels)


def _check(cfg: TransformerConfig) -> None:
    if cfg.moe_num_experts > 0 or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA layers are not ported yet; they come "
            "with the MoE/MLA slice of the LM family (ROADMAP A13)")
    for field, allowed in (("act", ("swiglu", "gelu")),
                           ("norm_style", ("pre", "post")),
                           ("attn_impl", ("torch", "cuda"))):
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"{cfg.name}: {field}={getattr(cfg, field)!r}, "
                             f"expected one of {allowed}")


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's structure with each leaf's shape — the template
    :func:`repro_torch.ckpt.checkpoint.restore` reads a checkpoint with.
    Allocates nothing."""
    _check(cfg)
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hd, KVd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    post = cfg.norm_style == "post"

    def norm(*lead):
        shapes = {"scale": (*lead, D)}
        if post:
            shapes["bias"] = (*lead, D)
        return shapes

    attn = {"wq": (L, D, Hd), "wk": (L, D, KVd), "wv": (L, D, KVd),
            "wo": (L, Hd, D)}
    if cfg.qkv_bias:
        attn.update(bq=(L, Hd), bk=(L, KVd), bv=(L, KVd))
    if cfg.act == "swiglu":
        mlp = {"w1": (L, D, F), "w3": (L, D, F), "w2": (L, F, D)}
    else:
        mlp = {"w1": {"w": (L, D, F), "b": (L, F)},
               "w2": {"w": (L, F, D), "b": (L, D)}}
    shapes = {
        "embed": {"table": (V, D)},
        "dense_layers": {"attn": attn, "attn_norm": norm(L),
                         "mlp_norm": norm(L), "mlp": mlp},
        "final_norm": norm(),
    }
    if cfg.max_position_embeddings:
        shapes["pos_embed"] = {"table": (cfg.max_position_embeddings, D)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"w": (D, V)}
    return shapes


def init_numpy(cfg: TransformerConfig, seed: int) -> Dict[str, Any]:
    """Random parameters as nested dicts of numpy f32 arrays, drawn from
    ``numpy.random.default_rng(seed)``: norm scales 1, biases 0, embedding
    tables N(0, 0.02), weights N(0, 1/fan_in).  The scheme is the
    reference's; the numbers are not (JAX draws from its own generator)."""
    rng = np.random.default_rng(seed)

    def build(node, name):
        if isinstance(node, dict):
            return {key: build(node[key], key) for key in sorted(node)}
        if name == "scale":
            return np.ones(node, np.float32)
        if name in ("bias", "b", "bq", "bk", "bv"):
            return np.zeros(node, np.float32)
        std = 0.02 if name == "table" else 1.0 / np.sqrt(node[-2])
        return rng.standard_normal(node, dtype=np.float32) * np.float32(std)

    return build(param_shapes(cfg), "")


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (nested dicts of numpy arrays, as
    ``repro.ckpt.restore`` or ``nn.materialize(tfm.init(...))`` gives it;
    tensors are taken too) of either family -> the port's parameters on
    ``device``, with the same key paths and dtypes."""
    missing = [key for key in ("embed", "dense_layers", "final_norm")
               if key not in tree]
    if missing:
        raise ValueError(f"not a transformer parameter tree: missing "
                         f"{missing}")
    if "moe_layers" in tree:
        raise NotImplementedError("MoE parameter trees are not ported yet")
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


# ---------------------------------------------------------------------------
# Layers and the trunk
# ---------------------------------------------------------------------------


def _dense_mlp(p, x, cfg: TransformerConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.act == "swiglu":
        h = nn.silu(x @ p["w1"].to(cd)) * (x @ p["w3"].to(cd))
        return h @ p["w2"].to(cd)
    h = nn.gelu(nn.linear(p["w1"], x, cd))
    return nn.linear(p["w2"], h, cd)


def _layer(p, x, cfg: TransformerConfig, *, positions, cache=None,
           cache_index=None, kv_mask=None):
    if cfg.norm_style == "post":
        a, cache = _attention(p["attn"], x, cfg, positions=positions,
                              cache=cache, cache_index=cache_index,
                              kv_mask=kv_mask)
        x = _norm(p["attn_norm"], x + a, cfg)
        return _norm(p["mlp_norm"], x + _dense_mlp(p["mlp"], x, cfg),
                     cfg), cache
    a, cache = _attention(p["attn"], _norm(p["attn_norm"], x, cfg), cfg,
                          positions=positions, cache=cache,
                          cache_index=cache_index, kv_mask=kv_mask)
    x = x + a
    return x + _dense_mlp(p["mlp"], _norm(p["mlp_norm"], x, cfg), cfg), cache


def _layer_params(stack, i: int):
    if isinstance(stack, dict):
        return {key: _layer_params(val, i) for key, val in stack.items()}
    return stack[i]


def forward(params, cfg: TransformerConfig, tokens: torch.Tensor, *,
            caches=None, cache_index: Optional[int] = None,
            kv_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Run the trunk. Returns (hidden (B, S, D) in the compute dtype,
    caches (written in place) or None, aux loss (0: no MoE))."""
    _check(cfg)
    S = tokens.shape[1]
    cd = cfg.compute_dtype
    x = nn.embedding(params["embed"], tokens, cd)
    if positions is None:       # (1, S): broadcast over the batch
        positions = torch.arange(S, device=tokens.device)[None, :] \
            + (cache_index or 0)
    if cfg.max_position_embeddings:
        x = x + nn.embedding(params["pos_embed"], positions, cd)
    stack = params["dense_layers"]
    dense = caches["dense"] if caches is not None else None
    for i in range(stack["attn"]["wq"].shape[0]):
        cache = None if dense is None else {"k": dense["k"][i],
                                            "v": dense["v"][i]}
        x, _ = _layer(_layer_params(stack, i), x, cfg, positions=positions,
                      cache=cache, cache_index=cache_index, kv_mask=kv_mask)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _norm(params["final_norm"], x, cfg), caches, aux


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
    # the reference adds router_aux_coef * aux; aux is 0 without MoE
    return xent, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed KV caches stacked per layer group, as the reference's."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"dense": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)},
            "moe": None}


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
