"""Breakage-probability-biased dBG traversal.

The reference's README frames octamer breakage probabilities steering the
assembly as the ideal use of the method (README.md:79-81); the shipped code
never implements it. This module adds it as a first-class capability
(BASELINE.json config 4):

Standard traversal stops at every branch node and emits one unitig per
out-edge. Biased traversal instead *continues through* branches, at each
node picking the present out-edge whose junction octamer — the trailing
8-mer of the (k)-mer formed by node + candidate base — has the highest
breakage probability. Since sonication breakpoints concentrate on
high-probability octamers, read starts (and thus correct continuations) are
enriched there.

Walks start from the same (branch node, out-edge) pairs as the standard
traversal, follow the greedy successor, and stop at dead ends or at the
max_len cap (cycles are possible once branches are passable; the cap is the
documented termination guarantee — capped walks return overflow=True).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.dbg.dense import DenseDBG, _sort_compact, build_dbg_dense

PAD = np.uint8(255)


def biased_successor(g: DenseDBG, probs8: jnp.ndarray) -> jnp.ndarray:
    """succ_b[node] = dense node id of the greedy out-edge, -1 at dead ends.

    Requires k-1 >= 8 (dbg_kmer >= 9, true of every reference config), so
    the junction octamer is the trailing 16 bits of the candidate edge code.
    """
    V = g.succ.shape[0]
    node = jnp.arange(V, dtype=jnp.int32)
    cand_edge = (node[:, None] << 2) | jnp.arange(4, dtype=jnp.int32)  # [V, 4]
    oct_code = cand_edge & ((1 << 16) - 1)
    w = probs8[oct_code]  # [V, 4]
    present = g.presence.reshape(V, 4)
    w = jnp.where(present, w, -1.0)
    best_char = jnp.argmax(w, axis=1).astype(jnp.int32)
    return jnp.where(g.out_deg > 0, ((node << 2) | best_char) & (V - 1), -1)


def biased_successor_edges(p_idx, s_idx, char, oct_code, edge_valid, V,
                           probs8) -> jnp.ndarray:
    """succ_b[node_index] for compacted (sparse / big-k) graphs: the node
    index reached by the out-edge whose junction octamer has the highest
    breakage probability; -1 at dead ends. Edge lists carry each (node, char)
    pair at most once (edges are unique), so the [V, 4] scatters are
    race-free; argmax ties prefer the smallest char, matching
    biased_successor's dense argmax."""
    w = jnp.where(edge_valid, probs8[oct_code], -1.0)
    rows = jnp.where(edge_valid, p_idx, V)
    w4 = jnp.full((V, 4), -1.0, jnp.float32).at[rows, char].set(w, mode="drop")
    s4 = jnp.full((V, 4), -1, jnp.int32).at[rows, char].set(
        jnp.where(edge_valid, s_idx, -1), mode="drop")
    best = jnp.argmax(w4, axis=1)
    has = jnp.take_along_axis(w4, best[:, None], axis=1)[:, 0] >= 0.0
    succ = jnp.take_along_axis(s4, best[:, None], axis=1)[:, 0]
    return jnp.where(has, succ, -1)


def _greedy_walk(node_char, succ_b, w_start, prefix_chars, wvalid, k: int,
                 max_len: int):
    """Greedy continuation walk over node indices: from each start node,
    follow succ_b until a dead end (-1) or the max_len cap. prefix_chars
    [W, k-1] seed the buffer; the start node's own char lands at column k-1.
    Returns (buf, lens, overflow).

    succ_b is a STATIC functional graph (the greedy choice depends only on
    the node, never on walk state — cycles terminate via the cap), so the
    whole path is materialized by pointer doubling instead of a char-per-
    iteration while_loop: with jump_L = succ^L, the node at step j+L is
    jump_L[P[:, j]], so each round doubles the materialized path length.
    log2(max_len) rounds of [W, L] gathers replace max_len sequential steps
    (50 kb walks: ~17 rounds vs ~50,000 iterations). The gather work scales
    with the STATIC walk capacity W, so callers must size W near the real
    walk count (dbg/assemble.py ladder, mw0=64)."""
    W = w_start.shape[0]
    V = node_char.shape[0]
    steps = max_len - (k - 1)  # chars appended after the seeded prefix
    # sink-augmented jump table: dead ends (-1) -> sink V, succ[sink] = sink
    succ1 = jnp.concatenate(
        [jnp.where(succ_b < 0, V, succ_b).astype(jnp.int32),
         jnp.array([V], jnp.int32)])
    # P[:, j] = node after j greedy steps (sink-absorbed once dead)
    P = jnp.where(wvalid, w_start, V).astype(jnp.int32)[:, None]
    jump = succ1
    L = 1
    while L < steps:
        P = jnp.concatenate([P, jump[P]], axis=1)  # steps L .. 2L-1
        jump = jump[jump]
        L *= 2
    P = P[:, :steps]
    live = P < V  # a char is written at step j iff the node is real
    chars = jnp.where(live, node_char[jnp.minimum(P, V - 1)], PAD)
    buf = jnp.concatenate(
        [jnp.where(wvalid[:, None], prefix_chars, PAD), chars], axis=1)
    lens = jnp.where(
        wvalid, (k - 1) + live.sum(axis=1, dtype=jnp.int32), 0)
    # overflow = the cap hit while still extending: every step wrote a char
    # and the last node still has a successor
    overflow = wvalid & live[:, -1] & (succ1[P[:, -1]] < V)
    return buf, lens, overflow


@partial(jax.jit, static_argnames=("k", "max_len", "max_walks", "node_cap"))
def biased_contigs_sparse(
    kmer_codes: jnp.ndarray,
    kmer_valid: jnp.ndarray,
    probs8: jnp.ndarray,
    k: int,
    max_len: int,
    max_walks: int,
    node_cap: int | None = None,
):
    """Biased traversal on the sorted-unique (sparse) graph, 8 < k <= 15.
    Same return contract as biased_contigs_dense plus n_nodes last."""
    if k - 1 < 8:
        raise ValueError("biased traversal needs dbg_kmer >= 9 (octamer junctions)")
    from genomeassembler_dev.dbg.graph import build_dbg, walk_starts_sparse

    g = build_dbg(kmer_codes.reshape(-1), kmer_valid.reshape(-1), k,
                  node_cap=node_cap)
    V = g.nodes.shape[0]
    km1_mask = jnp.int32((1 << (2 * (k - 1))) - 1)
    prefix = g.edges >> 2
    suffix = g.edges & km1_mask
    p_idx = jnp.minimum(jnp.searchsorted(g.nodes, prefix), V - 1).astype(jnp.int32)
    s_idx = jnp.minimum(jnp.searchsorted(g.nodes, suffix), V - 1).astype(jnp.int32)
    succ_b = biased_successor_edges(
        p_idx, s_idx, (g.edges & 3).astype(jnp.int32),
        jnp.where(g.edge_valid, g.edges & ((1 << 16) - 1), 0),
        g.edge_valid, V, probs8.astype(jnp.float32))

    w_start, w_prefix, wvalid, n_walks = walk_starts_sparse(g, max_walks)
    cols = jnp.arange(k - 1, dtype=jnp.int32)
    shifts = 2 * (k - 2 - cols)
    prefix_chars = ((w_prefix[:, None] >> shifts[None, :]) & 3).astype(jnp.uint8)
    node_char = (g.nodes & 3).astype(jnp.uint8)
    buf, lens, overflow = _greedy_walk(
        node_char, succ_b, jnp.where(wvalid, w_start, 0), prefix_chars,
        wvalid, k, max_len)
    return buf, lens, wvalid, overflow, n_walks, g.n_nodes


@partial(jax.jit, static_argnames=("k", "max_len", "max_walks", "node_cap"))
def biased_contigs_big_k(
    codes_hi: jnp.ndarray,
    codes_lo: jnp.ndarray,
    kmer_valid: jnp.ndarray,
    probs8: jnp.ndarray,
    k: int,
    max_len: int,
    max_walks: int,
    node_cap: int | None = None,
):
    """Biased traversal for 16 < k <= 31 (two-word codes; BASELINE config 1
    runs k=31). The junction octamer is the trailing 16 bits of the edge's
    low word (k-1 >= 8)."""
    from genomeassembler_dev.dbg.big_k import _graph_big_k

    g = _graph_big_k(codes_hi, codes_lo, kmer_valid, k, max_walks, node_cap)
    V = g["node_char"].shape[0]
    succ_b = biased_successor_edges(
        g["p_idx"], g["s_idx"], (g["e_lo"] & 3).astype(jnp.int32),
        jnp.where(g["edge_valid"], g["e_lo"] & ((1 << 16) - 1),
                  jnp.uint32(0)).astype(jnp.int32),
        g["edge_valid"], V, probs8.astype(jnp.float32))
    buf, lens, overflow = _greedy_walk(
        g["node_char"], succ_b, jnp.where(g["wvalid"], g["w_start"], 0),
        g["prefix_chars"], g["wvalid"], k, max_len)
    return buf, lens, g["wvalid"], overflow, g["n_walks"], g["n_nodes_total"]


@partial(jax.jit, static_argnames=("k", "max_len", "max_walks"))
def biased_contigs_dense(
    kmer_codes: jnp.ndarray,
    kmer_valid: jnp.ndarray,
    probs8: jnp.ndarray,
    k: int,
    max_len: int,
    max_walks: int,
):
    """Greedy probability-guided assemblies from every branch out-edge.

    Returns (buf [W, max_len] uint8, lens, walk_valid, overflow, n_walks).
    """
    if k - 1 < 8:
        raise ValueError("biased traversal needs dbg_kmer >= 9 (octamer junctions)")
    g = build_dbg_dense(kmer_codes, kmer_valid, k)
    V = g.succ.shape[0]
    succ_b = biased_successor(g, probs8.astype(jnp.float32))

    # walk starts: same (branch node, out-char) pairs as the standard walk
    edge = jnp.arange(4 * V, dtype=jnp.int32)
    is_walk = g.presence & g.branch[edge >> 2]
    # compact via sort on the edge domain
    sel, wvalid, n_walks = _sort_compact(is_walk, max_walks)
    w_prefix = sel >> 2
    w_start = sel & (V - 1)  # dense node id of the edge suffix

    cols = jnp.arange(k - 1, dtype=jnp.int32)
    shifts = 2 * (k - 2 - cols)
    prefix_chars = ((w_prefix[:, None] >> shifts[None, :]) & 3).astype(jnp.uint8)
    node_char = (jnp.arange(V, dtype=jnp.int32) & 3).astype(jnp.uint8)
    buf, lens, overflow = _greedy_walk(
        node_char, succ_b, w_start, prefix_chars, wvalid, k, max_len)
    return buf, lens, wvalid, overflow, n_walks
