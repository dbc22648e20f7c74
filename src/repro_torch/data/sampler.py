"""Neighbor sampler for minibatch GNN training (GraphSAGE-style fanout),
the port's own copy of ``repro/data/sampler.py``.

Host-side numpy, as in production systems: the sampler runs in the input
pipeline and the device step consumes padded subgraph tensors of a fixed
shape.  Given the same ``numpy.random.Generator`` it returns the arrays the
reference's returns, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed adjacency (out-edges)."""
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        order = np.argsort(src, kind="stable")
        s, d = src[order], dst[order]
        counts = np.bincount(s, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=d.astype(np.int32))

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]


def sampled_subgraph_shape(batch_nodes: int, fanout: Sequence[int]
                           ) -> Tuple[int, int]:
    """Padded (n_nodes, n_edges) of a fanout-sampled subgraph (worst case)."""
    n_nodes, n_edges, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        n_edges += frontier * f
        frontier = frontier * f
        n_nodes += frontier
    return n_nodes, n_edges


def sample_subgraph(graph: CSRGraph, seeds: np.ndarray, fanout: Sequence[int],
                    rng: np.random.Generator):
    """Layer-wise fanout sampling; returns a padded, relabeled subgraph.

    Returns dict: nodes (global ids, padded with -1), src/dst (local ids,
    padded self-loops on node 0), edge_mask, node_mask, n_seeds.  Padding
    keeps shapes fixed across batches.
    """
    max_nodes, max_edges = sampled_subgraph_shape(len(seeds), fanout)
    nodes = list(seeds)
    local = {int(g): i for i, g in enumerate(seeds)}
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in fanout:
        nxt = []
        for u in frontier:
            nbr = graph.neighbors(int(u))
            if len(nbr) == 0:
                continue
            take = nbr if len(nbr) <= f else rng.choice(nbr, size=f,
                                                        replace=False)
            for v in take:
                v = int(v)
                if v not in local:
                    local[v] = len(nodes)
                    nodes.append(v)
                    nxt.append(v)
                # message flows neighbor -> center
                src_l.append(local[v])
                dst_l.append(local[int(u)])
        frontier = nxt

    n, e = len(nodes), len(src_l)
    out_nodes = np.full(max_nodes, -1, np.int64)
    out_nodes[:n] = np.asarray(nodes, np.int64)
    src = np.zeros(max_edges, np.int32)
    dst = np.zeros(max_edges, np.int32)
    src[:e] = np.asarray(src_l, np.int32)
    dst[:e] = np.asarray(dst_l, np.int32)
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[:e] = True
    node_mask = np.zeros(max_nodes, bool)
    node_mask[:n] = True
    return {"nodes": out_nodes, "src": src, "dst": dst,
            "edge_mask": edge_mask, "node_mask": node_mask,
            "n_seeds": len(seeds)}
