"""Vectorised contig traversal: every walk advances one node per step.

The reference walks from each branch node along each out-edge sequentially
(lib/DeNovoAssembler.cpp:171-189). Here all walks advance together in a
`while_loop`: at step t each active walk emits the last base of its current
node into column k-1+t and hops to succ[node]. A walk deactivates after
emitting a branch node or a dead end (matching the reference's stop-at-branch
and dict-empty break, cpp:179-186).

Walks cannot revisit a pass-through node: re-entering an (in=1, out=1) node
would require a second in-edge, contradicting in=1 — so walk length is
bounded by the node count and the loop terminates (the reference relies on
the same invariant).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.dbg.graph import DBG

PAD = np.uint8(255)


@partial(jax.jit, static_argnames=("max_len", "max_walks"))
def walk_contigs(g: DBG, max_len: int, max_walks: int | None = None):
    """Walk every (branch-node, out-edge) pair to the next branch/dead end.

    Returns (contigs [W, max_len] uint8 codes PAD-padded, lens [W] int32,
    walk_valid [W] bool, overflow [W] bool, n_walks_total scalar int32).

    By default W = E (one walk slot per edge). Walks are sparse (only edges
    whose prefix node branches), so max_walks compacts them into a fixed
    smaller capacity; if n_walks_total > max_walks the surplus walks were
    dropped and the caller must retry with a larger cap.
    """
    E = g.edges.shape[0]
    V = g.nodes.shape[0]
    k = g.k

    prefix = g.edges >> 2
    km1_mask = jnp.int32((1 << (2 * (k - 1))) - 1)
    suffix = g.edges & km1_mask
    p_idx = jnp.minimum(jnp.searchsorted(g.nodes, prefix), V - 1).astype(jnp.int32)
    s_idx = jnp.minimum(jnp.searchsorted(g.nodes, suffix), V - 1).astype(jnp.int32)

    walk_valid = g.edge_valid & g.branch[p_idx]
    n_walks_total = walk_valid.sum().astype(jnp.int32)

    if max_walks is not None and max_walks < E:
        (sel,) = jnp.nonzero(walk_valid, size=max_walks, fill_value=0)
        slot_ok = jnp.arange(max_walks) < jnp.minimum(n_walks_total, max_walks)
        prefix = prefix[sel]
        s_idx = s_idx[sel]
        walk_valid = slot_ok
        W = max_walks
    else:
        W = E

    # first k-1 columns: the branch prefix's characters
    cols = jnp.arange(max_len, dtype=jnp.int32)
    shifts = 2 * (k - 2 - cols[: k - 1])
    prefix_chars = ((prefix[:, None] >> shifts[None, :]) & 3).astype(jnp.uint8)
    buf0 = jnp.full((W, max_len), PAD)
    buf0 = buf0.at[:, : k - 1].set(jnp.where(walk_valid[:, None], prefix_chars, PAD))

    def cond(state):
        t, cur, active, buf, lens = state
        return active.any() & (t + k - 1 < max_len)

    def body(state):
        t, cur, active, buf, lens = state
        node_code = g.nodes[cur]
        ch = (node_code & 3).astype(jnp.uint8)
        col = k - 1 + t
        buf = buf.at[:, col].set(jnp.where(active, ch, buf[:, col]))
        lens = jnp.where(active, col + 1, lens)
        terminal = g.branch[cur] | (g.out_deg[cur] == 0)
        nxt = g.succ[cur]
        still = active & ~terminal & (nxt >= 0)
        cur = jnp.where(still, jnp.maximum(nxt, 0), cur)
        return t + 1, cur, still, buf, lens

    t0 = jnp.int32(0)
    lens0 = jnp.where(walk_valid, k - 1, 0).astype(jnp.int32)
    t, cur, active, buf, lens = jax.lax.while_loop(
        cond, body, (t0, s_idx, walk_valid, buf0, lens0)
    )
    overflow = active  # ran out of buffer while still walking
    return buf, lens, walk_valid, overflow, n_walks_total
