"""Contig traversal by pointer doubling (parallel list ranking).

The reference's walk is an O(chain length) sequential loop per contig
(lib/DeNovoAssembler.cpp:171-189); the while_loop port of it (traverse.py)
pays one device step per character. This module replaces it with the classic
parallel formulation — O(log max_len) vectorised steps total:

  * every interior node of a unitig chain has exactly one successor and one
    predecessor (in = out = 1; anything else is a branch/terminal), so chains
    are disjoint linked lists;
  * upstream doubling of (uptr, uoff) gives every interior node its chain
    head and offset — the head's walk id is scattered from the walk list;
  * a downstream chase is NOT needed: the chain's last node (the one whose
    successor is terminal) knows the walk's length (its offset + 1) and the
    terminal character (its successor's), so lengths and terminal chars are
    scattered from last nodes instead of chased from starts — half the
    doubling gathers;
  * the contig characters are then written with scatters: prefix chars, all
    interior-node characters to (walk, k-1+offset), the terminal character
    at (walk, k+offset_last), and per-walk lengths from last nodes.

Works over any node-indexed graph arrays, so the dense (direct-indexed) and
sparse (sorted-unique) builders share it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PAD = np.uint8(255)


@partial(jax.jit, static_argnames=("k", "max_len"))
def walk_contigs_doubling(
    node_char: jnp.ndarray,  # [V] uint8 last base of each node
    succ: jnp.ndarray,  # [V] int32 successor node index (-1 if out != 1)
    pred: jnp.ndarray,  # [V] int32 predecessor node index (-1 if in != 1)
    branch: jnp.ndarray,  # [V] bool
    out_deg: jnp.ndarray,  # [V] int32
    walk_start: jnp.ndarray,  # [W] int32 node index (edge suffix), -1 invalid
    walk_prefix: jnp.ndarray,  # [W] int32 (k-1)-mer code of the branch prefix
    walk_valid: jnp.ndarray,  # [W] bool
    k: int,
    max_len: int,
):
    """Returns (buf [W, max_len] uint8, lens [W] int32, overflow [W] bool)."""
    V = node_char.shape[0]
    W = walk_start.shape[0]
    self_idx = jnp.arange(V, dtype=jnp.int32)

    terminal = branch | (out_deg == 0)

    # --- upstream doubling: head + offset for interior nodes ---------------
    interior = ~terminal  # interior nodes have in==1, out==1, a valid pred
    has_pred = pred >= 0
    head = interior & (~has_pred | terminal[jnp.maximum(pred, 0)])
    uptr = jnp.where(interior & ~head & has_pred, jnp.maximum(pred, 0), self_idx)
    uoff = jnp.where(interior & ~head & has_pred, 1, 0).astype(jnp.int32)
    # chains have at most V nodes, so 2^n_iters >= min(max_len, V) suffices:
    # anything longer either cannot exist (> V) or is flagged as overflow
    n_iters = max(1, min(max_len, V).bit_length())
    for _ in range(n_iters):
        uoff = uoff + uoff[uptr]
        uptr = uptr[uptr]

    # --- walk ids at heads --------------------------------------------------
    start_c = jnp.where(walk_valid, walk_start, V)
    start_nonterm = walk_valid & ~terminal[jnp.minimum(walk_start, V - 1)]
    head_walk = jnp.full(V, -1, jnp.int32).at[
        jnp.where(start_nonterm, start_c, V)
    ].set(jnp.arange(W, dtype=jnp.int32), mode="drop")

    # --- assemble buffers ---------------------------------------------------
    # all character scatters use FLAT (1D) indices wid*max_len + pos: 2D
    # scatters into long rows were orders of magnitude slower on the first
    # accelerator (not re-measured on the H100)
    if W * max_len >= 2**31:
        raise ValueError(
            f"walk buffer {W} x {max_len} overflows int32 flat indexing")
    flat = jnp.full(W * max_len, PAD)
    OOB = jnp.int32(min(W * max_len, 2**31 - 1))

    # interior characters: one scatter over all nodes
    wid = head_walk[uptr]  # [V] walk id (or -1)
    node_ok = interior & (wid >= 0)
    poss = jnp.minimum(k - 1 + uoff, max_len - 1)
    idx_i = jnp.where(node_ok, wid * max_len + poss, OOB)
    flat = flat.at[idx_i].set(node_char, mode="drop")

    # last chain node (successor is terminal) scatters the walk's terminal
    # character and total length; interior => succ >= 0
    succ_c = jnp.maximum(succ, 0)
    is_last = node_ok & terminal[succ_c]
    idx_l = jnp.where(is_last, wid * max_len + jnp.minimum(k + uoff, max_len - 1),
                      OOB)
    flat = flat.at[idx_l].set(node_char[succ_c], mode="drop")
    lrows = jnp.where(is_last, wid, W)
    lens0 = jnp.zeros(W, jnp.int32).at[lrows].set(k + 1 + uoff, mode="drop")

    # walks whose start node is itself terminal have length k and the start
    # node's own character at column k-1
    s_clamped = jnp.minimum(jnp.maximum(walk_start, 0), V - 1)
    start_term = walk_valid & terminal[s_clamped]
    idx_t = jnp.where(start_term,
                      jnp.arange(W, dtype=jnp.int32) * max_len + (k - 1), OOB)
    flat = flat.at[idx_t].set(node_char[s_clamped], mode="drop")

    # prefix characters (first k-1 columns): contiguous 2D update, cheap
    buf = flat.reshape(W, max_len)
    cols = jnp.arange(k - 1, dtype=jnp.int32)
    shifts = 2 * (k - 2 - cols)
    prefix_chars = ((walk_prefix[:, None] >> shifts[None, :]) & 3).astype(jnp.uint8)
    buf = buf.at[:, : k - 1].set(jnp.where(walk_valid[:, None], prefix_chars, PAD))

    lens = jnp.where(walk_valid, jnp.where(start_term, k, lens0), 0)
    # a valid interior-start walk with lens0 == 0 means the up-chain did not
    # converge within 2^n_iters >= max_len steps — the chain is longer than
    # max_len, i.e. overflow
    overflow = walk_valid & ((lens > max_len) | (start_nonterm & (lens0 == 0)))

    return buf, lens, overflow
