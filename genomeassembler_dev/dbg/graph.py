"""Device de Bruijn graph over integer k-mer codes.

The reference builds the graph with string hash maps
(lib/DeNovoAssembler.cpp:104-169). Key observation: because the adjacency map
stores *unique* suffixes per prefix (cpp:111-121), the edge set is exactly the
set of unique k-mer codes — (prefix, suffix) <-> k-mer bijectively. So the
whole graph is:

  * sort the k-mer codes, mark unique entries  (edges),
  * nodes = unique (k-1)-mer codes among prefixes+suffixes,
  * in/out-degree by scatter-add over node indices,
  * branch nodes: (in != 1 or out != 1) and out > 0   (cpp:160-169),
  * successor index for out==1 nodes (the only ones walks pass through).

All arrays are fixed-capacity with sentinel padding (code SENTINEL sorts
last), so every step is static-shape and jit-compatible.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = np.int32(2**31 - 1)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "edges", "edge_valid", "nodes", "node_valid",
        "in_deg", "out_deg", "branch", "succ", "pred", "n_edges", "n_nodes",
    ],
    meta_fields=["k"],
)
@dataclass
class DBG:
    """Fixed-capacity device graph. E = edge capacity (= #input k-mers),
    V = node capacity (= 2E). Valid entries are a prefix of each array."""

    k: int
    edges: jnp.ndarray  # [E] sorted unique k-mer codes, SENTINEL-padded
    edge_valid: jnp.ndarray  # [E] bool
    nodes: jnp.ndarray  # [V] sorted unique (k-1)-mer codes, SENTINEL-padded
    node_valid: jnp.ndarray  # [V] bool
    in_deg: jnp.ndarray  # [V] int32
    out_deg: jnp.ndarray  # [V] int32
    branch: jnp.ndarray  # [V] bool
    succ: jnp.ndarray  # [V] int32 node index of unique successor, -1 otherwise
    pred: jnp.ndarray  # [V] int32 node index of unique predecessor, -1 otherwise
    n_edges: jnp.ndarray  # scalar int32
    n_nodes: jnp.ndarray  # scalar int32


def _sorted_unique(vals: jnp.ndarray, valid: jnp.ndarray):
    """Sort with invalids as SENTINEL; return (sorted, unique_mask, count)."""
    v = jnp.where(valid, vals, SENTINEL)
    s = jnp.sort(v)
    uniq = (s != SENTINEL) & jnp.concatenate(
        [jnp.ones((1,), bool), s[1:] != s[:-1]]
    )
    return s, uniq, uniq.sum()


@partial(jax.jit, static_argnames=("k", "node_cap"))
def build_dbg(kmer_codes: jnp.ndarray, kmer_valid: jnp.ndarray, k: int,
              node_cap: int | None = None) -> DBG:
    """Build the graph from (possibly repeated) k-mer codes [N].

    node_cap (static) bounds the node arrays: unique nodes are compacted to
    the front of the sorted array, so slicing to node_cap is exact whenever
    n_nodes <= node_cap (callers check the returned n_nodes and retry with a
    larger cap). Without it V = 2E, and the downstream doubling walk pays
    ~2E/n_nodes x redundant gather work (~60x at BASELINE config 1: 1.6M
    k-mers, 50k real nodes)."""
    n = kmer_codes.shape[0]
    s, uniq, n_edges = _sorted_unique(kmer_codes.astype(jnp.int32), kmer_valid)
    # compact unique edges to the front, SENTINEL elsewhere
    edges = jnp.sort(jnp.where(uniq, s, SENTINEL))
    edge_valid = edges != SENTINEL

    km1_mask = jnp.int32((1 << (2 * (k - 1))) - 1)
    prefix = jnp.where(edge_valid, edges >> 2, SENTINEL)
    suffix = jnp.where(edge_valid, edges & km1_mask, SENTINEL)

    both = jnp.concatenate([prefix, suffix])
    bs, buniq, n_nodes = _sorted_unique(both, both != SENTINEL)
    nodes = jnp.sort(jnp.where(buniq, bs, SENTINEL))
    if node_cap is not None and node_cap < nodes.shape[0]:
        nodes = nodes[:node_cap]
    node_valid = nodes != SENTINEL
    V = nodes.shape[0]

    # node index lookup by binary search (nodes sorted, SENTINEL at end)
    p_idx = jnp.searchsorted(nodes, prefix).astype(jnp.int32)
    s_idx = jnp.searchsorted(nodes, suffix).astype(jnp.int32)
    p_idx = jnp.where(edge_valid, p_idx, V)  # out-of-range -> dropped
    s_idx = jnp.where(edge_valid, s_idx, V)

    ones = edge_valid.astype(jnp.int32)
    out_deg = jnp.zeros(V, jnp.int32).at[p_idx].add(ones, mode="drop")
    in_deg = jnp.zeros(V, jnp.int32).at[s_idx].add(ones, mode="drop")

    branch = ((in_deg != 1) | (out_deg != 1)) & (out_deg > 0) & node_valid

    # successor: for out==1 prefixes exactly one edge writes; for out>1 all
    # writes store -1; out==0 slots keep the initial -1.
    single = out_deg.at[jnp.minimum(p_idx, V - 1)].get() == 1
    succ_val = jnp.where(single & edge_valid, s_idx, -1)
    succ = jnp.full(V, -1, jnp.int32).at[p_idx].set(succ_val, mode="drop")
    # out>1 nodes may have had a -1 or s_idx raced in .set (unordered);
    # force them to -1 explicitly:
    succ = jnp.where(out_deg == 1, succ, -1)

    single_in = in_deg.at[jnp.minimum(s_idx, V - 1)].get() == 1
    pred_val = jnp.where(single_in & edge_valid, p_idx, -1)
    pred = jnp.full(V, -1, jnp.int32).at[s_idx].set(pred_val, mode="drop")
    pred = jnp.where(in_deg == 1, pred, -1)

    return DBG(
        k=k,
        edges=edges,
        edge_valid=edge_valid,
        nodes=nodes,
        node_valid=node_valid,
        in_deg=in_deg,
        out_deg=out_deg,
        branch=branch,
        succ=succ,
        pred=pred,
        n_edges=n_edges.astype(jnp.int32),
        n_nodes=n_nodes.astype(jnp.int32),
    )


@partial(jax.jit, static_argnames=("max_walks",))
def walk_starts_sparse(g: DBG, max_walks: int):
    """Edges whose prefix node branches, compacted to [max_walks]. Returns
    (start_node_idx, prefix_codes, valid, n_walks_total)."""
    V = g.nodes.shape[0]
    km1_mask = jnp.int32((1 << (2 * (g.k - 1))) - 1)
    prefix = g.edges >> 2
    suffix = g.edges & km1_mask
    p_idx = jnp.minimum(jnp.searchsorted(g.nodes, prefix), V - 1).astype(jnp.int32)
    s_idx = jnp.minimum(jnp.searchsorted(g.nodes, suffix), V - 1).astype(jnp.int32)
    is_walk = g.edge_valid & g.branch[p_idx]
    n_total = is_walk.sum().astype(jnp.int32)
    (sel,) = jnp.nonzero(is_walk, size=max_walks, fill_value=0)
    valid = jnp.arange(max_walks) < jnp.minimum(n_total, max_walks)
    return s_idx[sel], prefix[sel], valid, n_total


@partial(jax.jit, static_argnames=("k", "max_len", "max_walks", "node_cap"))
def contigs_sparse(kmer_codes: jnp.ndarray, kmer_valid: jnp.ndarray, k: int,
                   max_len: int, max_walks: int, node_cap: int | None = None):
    """Fused sparse build + doubling walk for one segment. Returns
    (buf [W, max_len], lens, walk_valid, overflow, n_walks_total, n_nodes).
    With node_cap=None capacity is 2E and can never overflow; with a cap the
    caller must check n_nodes <= node_cap (retry larger) — see build_dbg."""
    from genomeassembler_dev.dbg.doubling import walk_contigs_doubling

    g = build_dbg(kmer_codes.reshape(-1), kmer_valid.reshape(-1), k,
                  node_cap=node_cap)
    start, prefix, valid, n_total = walk_starts_sparse(g, max_walks)
    node_char = (g.nodes & 3).astype(jnp.uint8)
    buf, lens, overflow = walk_contigs_doubling(
        node_char, g.succ, g.pred, g.branch, g.out_deg,
        jnp.where(valid, start, -1), prefix, valid, k, max_len,
    )
    return buf, lens, valid, overflow, n_total, g.n_nodes
