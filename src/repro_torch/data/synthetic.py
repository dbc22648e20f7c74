"""Synthetic batch generators, one per architecture family: the port's own
copy of ``repro/data/synthetic.py`` (numpy only).  Given the same
``numpy.random.Generator`` each returns the reference's arrays bit for bit.
"""

from __future__ import annotations

import numpy as np


def lm_batch(rng: np.random.Generator, vocab: int, batch: int, seq: int):
    return {"tokens": rng.integers(1, vocab, size=(batch, seq), dtype=np.int32)}


def biencoder_batch(rng, vocab: int, batch: int, q_len: int, p_len: int,
                    n_psg: int = 2):
    return {
        "q_tokens": rng.integers(1, vocab, size=(batch, q_len), dtype=np.int32),
        "q_mask": np.ones((batch, q_len), bool),
        "p_tokens": rng.integers(1, vocab, size=(batch, n_psg, p_len),
                                 dtype=np.int32),
        "p_mask": np.ones((batch, n_psg, p_len), bool),
    }


def graph_batch(rng, n_nodes: int, n_edges: int, d_feat: int, n_vars: int):
    src = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    return {
        "node_feat": rng.standard_normal((n_nodes, d_feat), np.float32),
        "src": src, "dst": dst,
        "target": rng.standard_normal((n_nodes, n_vars), np.float32),
    }


def batched_molecule_graphs(rng, n_graphs: int, nodes_per: int, edges_per: int,
                            d_feat: int, n_vars: int):
    """Block-diagonal batching of small graphs into one disjoint graph."""
    N, E = n_graphs * nodes_per, n_graphs * edges_per
    offs = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    src = rng.integers(0, nodes_per, size=E).astype(np.int32) + offs.astype(np.int32)
    dst = rng.integers(0, nodes_per, size=E).astype(np.int32) + offs.astype(np.int32)
    return {
        "node_feat": rng.standard_normal((N, d_feat), np.float32),
        "src": src, "dst": dst,
        "target": rng.standard_normal((N, n_vars), np.float32),
    }


def sasrec_batch(rng, item_vocab: int, batch: int, seq: int, n_neg: int):
    hist = rng.integers(1, item_vocab, size=(batch, seq), dtype=np.int32)
    pos = rng.integers(1, item_vocab, size=(batch, seq), dtype=np.int32)
    # left-pad some sequences to exercise masking
    lens = rng.integers(1, seq + 1, size=batch)
    for i, L in enumerate(lens):
        hist[i, L:] = 0
        pos[i, L:] = 0
    return {"hist": hist, "pos": pos,
            "neg_ids": rng.integers(1, item_vocab, size=n_neg, dtype=np.int32)}


def bert4rec_batch(rng, item_vocab: int, batch: int, seq: int, n_mask: int,
                   n_neg: int):
    tokens = rng.integers(2, item_vocab, size=(batch, seq), dtype=np.int32)
    pos = np.stack([rng.choice(seq, size=n_mask, replace=False)
                    for _ in range(batch)]).astype(np.int32)
    labels = np.take_along_axis(tokens, pos, axis=1)
    mask_token = 1
    for i in range(batch):
        tokens[i, pos[i]] = mask_token
    return {"tokens": tokens, "mlm_positions": pos, "mlm_labels": labels,
            "mlm_mask": np.ones((batch, n_mask), bool),
            "neg_ids": rng.integers(2, item_vocab, size=n_neg, dtype=np.int32)}


def mind_batch(rng, item_vocab: int, batch: int, seq: int, n_neg: int):
    return {"hist": rng.integers(1, item_vocab, size=(batch, seq), dtype=np.int32),
            "target": rng.integers(1, item_vocab, size=batch, dtype=np.int32),
            "neg_ids": rng.integers(1, item_vocab, size=n_neg, dtype=np.int32)}


def deepfm_batch(rng, field_vocabs, batch: int, max_hot: int):
    F = len(field_vocabs)
    offsets = np.concatenate([[0], np.cumsum(field_vocabs)[:-1]])
    ids = np.zeros((batch, F, max_hot), np.int32)
    valid = np.zeros((batch, F, max_hot), bool)
    for f, (v, off) in enumerate(zip(field_vocabs, offsets)):
        ids[:, f] = rng.integers(0, v, size=(batch, max_hot)) + off
        valid[:, f, 0] = True
        if max_hot > 1:
            valid[:, f, 1:] = rng.random((batch, max_hot - 1)) < 0.3
    return {"ids": ids, "valid": valid,
            "label": (rng.random(batch) < 0.3).astype(np.float32)}
