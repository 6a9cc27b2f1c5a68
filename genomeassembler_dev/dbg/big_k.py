"""De Bruijn graphs for k up to 31 (two-word k-mer codes).

The int32 code path covers k <= 15; standard assembly of 150 bp reads uses
k around 31 (BASELINE config 1). JAX runs without x64, so a k-mer here
is a (hi, lo) pair of uint32 words — 62 bits big-endian — and every ordering
operation uses multi-key `lax.sort`:

  * unique edges: sort (hi, lo), adjacent-pair diff;
  * node set: sort the 2E prefix/suffix pairs;
  * node-index assignment (the hash lookup of the int32 path's searchsorted):
    a sort-merge join — concatenate tagged (nodes, queries), sort by
    (hi, lo, tag), take rank = cumsum(is_node) - 1, scatter ranks back
    through a carried origin index;
  * degrees by segment boundaries on the sorted edge list.

The traversal is the same pointer-doubling walk as the small-k paths
(dbg/doubling.py) — it works on node indices, not codes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from genomeassembler_dev.dbg.doubling import walk_contigs_doubling

U32 = (1 << 32) - 1


def pair_shift_right2(hi, lo):
    """(hi, lo) >> 2 over the 64-bit concatenation."""
    return hi >> 2, ((lo >> 2) | ((hi & 3) << 30)) & jnp.uint32(U32)


def pair_mask_low(hi, lo, bits: int):
    """Keep the low `bits` bits of the 64-bit pair."""
    if bits >= 64:
        return hi, lo
    if bits <= 32:
        return jnp.zeros_like(hi), lo & jnp.uint32((1 << bits) - 1)
    return hi & jnp.uint32((1 << (bits - 32)) - 1), lo


def kmer_pair_codes(codes: jnp.ndarray, k: int):
    """Rolling k-mer codes as (hi, lo) uint32 pairs, k <= 31.

    codes: [..., L] base codes (values > 3 invalid). Returns
    (hi [..., L-k+1], lo [...], valid [...]).
    """
    if not 16 < k <= 31:
        raise ValueError("pair codes are for 16 < k <= 31")
    L = codes.shape[-1]
    n = L - k + 1
    base = codes.astype(jnp.uint32)
    valid_base = codes <= 3
    hi = jnp.zeros(codes.shape[:-1] + (n,), jnp.uint32)
    lo = jnp.zeros(codes.shape[:-1] + (n,), jnp.uint32)
    valid = jnp.ones(codes.shape[:-1] + (n,), bool)
    for i in range(k):
        hi = ((hi << 2) | (lo >> 30)) & jnp.uint32(U32)
        lo = ((lo << 2) | (base[..., i : i + n] & 3)) & jnp.uint32(U32)
        valid = valid & valid_base[..., i : i + n]
    # top bits beyond 2k are zero by construction
    return hi, lo, valid


def _rank_join(node_hi, node_lo, node_valid, q_hi, q_lo, q_valid):
    """For each query pair, the index of its value in the sorted unique node
    arrays (join by sort; queries must all be present among nodes)."""
    V = node_hi.shape[0]
    Q = q_hi.shape[0]
    big = jnp.uint32(U32)
    hi = jnp.concatenate([jnp.where(node_valid, node_hi, big),
                          jnp.where(q_valid, q_hi, big)])
    lo = jnp.concatenate([jnp.where(node_valid, node_lo, big),
                          jnp.where(q_valid, q_lo, big)])
    tag = jnp.concatenate([jnp.zeros(V, jnp.uint32), jnp.ones(Q, jnp.uint32)])
    origin = jnp.concatenate(
        [jnp.zeros(V, jnp.int32), jnp.arange(Q, dtype=jnp.int32)]
    )
    hi_s, lo_s, tag_s, origin_s = jax.lax.sort(
        (hi, lo, tag, origin), num_keys=3
    )
    rank = jnp.cumsum((tag_s == 0).astype(jnp.int32)) - 1
    out = jnp.full(Q, -1, jnp.int32)
    rows = jnp.where(tag_s == 1, origin_s, Q)
    return out.at[rows].set(jnp.where(tag_s == 1, rank, -1), mode="drop")


def _graph_big_k(codes_hi: jnp.ndarray, codes_lo: jnp.ndarray,
                 kmer_valid: jnp.ndarray, k: int, max_walks: int,
                 node_cap: int | None):
    """Shared big-k graph build: unique edges, node set, index joins,
    degrees/branching, chain succ/pred, walk starts and their prefix chars.
    Used by the standard (doubling) and biased (greedy) traversals."""
    big = jnp.uint32(U32)
    flat_hi = jnp.where(kmer_valid.reshape(-1), codes_hi.reshape(-1), big)
    flat_lo = jnp.where(kmer_valid.reshape(-1), codes_lo.reshape(-1), big)
    E = flat_hi.shape[0]
    max_walks = min(max_walks, E)

    # unique edges
    s_hi, s_lo = jax.lax.sort((flat_hi, flat_lo), num_keys=2)
    first = jnp.concatenate(
        [jnp.ones(1, bool), (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])]
    )
    edge_valid = first & ~((s_hi == big) & (s_lo == big))
    # compact unique edges to the front (sort by (!valid, position))
    key = jnp.where(edge_valid, jnp.arange(E, dtype=jnp.int32), E)
    sel = jax.lax.sort(key)
    sel_ok = sel < E
    sel_c = jnp.minimum(sel, E - 1)
    e_hi = jnp.where(sel_ok, s_hi[sel_c], big)
    e_lo = jnp.where(sel_ok, s_lo[sel_c], big)
    edge_valid = sel_ok

    # prefix/suffix pairs ((k-1)-mers)
    p_hi, p_lo = pair_shift_right2(e_hi, e_lo)
    sfx_hi, sfx_lo = pair_mask_low(e_hi, e_lo, 2 * (k - 1))
    p_hi = jnp.where(edge_valid, p_hi, big)
    p_lo = jnp.where(edge_valid, p_lo, big)
    sfx_hi = jnp.where(edge_valid, sfx_hi, big)
    sfx_lo = jnp.where(edge_valid, sfx_lo, big)

    # unique nodes over prefixes + suffixes
    b_hi = jnp.concatenate([p_hi, sfx_hi])
    b_lo = jnp.concatenate([p_lo, sfx_lo])
    n_hi, n_lo = jax.lax.sort((b_hi, b_lo), num_keys=2)
    nfirst = jnp.concatenate(
        [jnp.ones(1, bool), (n_hi[1:] != n_hi[:-1]) | (n_lo[1:] != n_lo[:-1])]
    )
    node_valid_raw = nfirst & ~((n_hi == big) & (n_lo == big))
    n_nodes_total = node_valid_raw.sum().astype(jnp.int32)
    nkey = jnp.where(node_valid_raw, jnp.arange(2 * E, dtype=jnp.int32), 2 * E)
    nsel = jax.lax.sort(nkey)
    nsel_ok = nsel < 2 * E
    nsel_c = jnp.minimum(nsel, 2 * E - 1)
    node_hi = jnp.where(nsel_ok, n_hi[nsel_c], big)
    node_lo = jnp.where(nsel_ok, n_lo[nsel_c], big)
    node_valid = nsel_ok
    if node_cap is not None and node_cap < node_hi.shape[0]:
        node_hi = node_hi[:node_cap]
        node_lo = node_lo[:node_cap]
        node_valid = node_valid[:node_cap]
    V = node_hi.shape[0]

    # node indices of each edge's prefix and suffix (sort-merge join)
    p_idx = _rank_join(node_hi, node_lo, node_valid, p_hi, p_lo, edge_valid)
    s_idx = _rank_join(node_hi, node_lo, node_valid, sfx_hi, sfx_lo, edge_valid)

    ones = edge_valid.astype(jnp.int32)
    out_deg = jnp.zeros(V, jnp.int32).at[
        jnp.where(edge_valid, p_idx, V)
    ].add(ones, mode="drop")
    in_deg = jnp.zeros(V, jnp.int32).at[
        jnp.where(edge_valid, s_idx, V)
    ].add(ones, mode="drop")
    branch = ((in_deg != 1) | (out_deg != 1)) & (out_deg > 0) & node_valid

    single = out_deg.at[jnp.clip(p_idx, 0, V - 1)].get() == 1
    succ = jnp.full(V, -1, jnp.int32).at[
        jnp.where(edge_valid, p_idx, V)
    ].set(jnp.where(single & edge_valid, s_idx, -1), mode="drop")
    succ = jnp.where(out_deg == 1, succ, -1)
    single_in = in_deg.at[jnp.clip(s_idx, 0, V - 1)].get() == 1
    pred = jnp.full(V, -1, jnp.int32).at[
        jnp.where(edge_valid, s_idx, V)
    ].set(jnp.where(single_in & edge_valid, p_idx, -1), mode="drop")
    pred = jnp.where(in_deg == 1, pred, -1)

    # walks: edges with branching prefixes
    is_walk = edge_valid & branch[jnp.clip(p_idx, 0, V - 1)]
    n_walks = is_walk.sum().astype(jnp.int32)
    wkey = jnp.where(is_walk, jnp.arange(E, dtype=jnp.int32), E)
    wsel = jax.lax.sort(wkey)[:max_walks]
    wvalid = jnp.arange(max_walks) < jnp.minimum(n_walks, max_walks)
    wsel_c = jnp.minimum(wsel, E - 1)
    w_start = jnp.where(wvalid, s_idx[wsel_c], -1)

    # prefix characters of each walk from the (k-1)-mer pair; the generic
    # walkers only handle int32 prefixes, so they are decoded here
    wp_hi = p_hi[wsel_c]
    wp_lo = p_lo[wsel_c]
    cols = jnp.arange(k - 1, dtype=jnp.int32)
    # character t of the (k-1)-mer = bits (2*(k-2-t)) of the pair
    shift = 2 * (k - 2 - cols)
    from_hi = shift >= 32
    char_hi = (wp_hi[:, None] >> jnp.minimum(shift - 32, 31).clip(0)[None, :]) & 3
    char_lo = (wp_lo[:, None] >> jnp.minimum(shift, 31)[None, :]) & 3
    prefix_chars = jnp.where(from_hi[None, :], char_hi, char_lo).astype(jnp.uint8)

    node_char = (node_lo & 3).astype(jnp.uint8)
    return dict(
        node_char=node_char, node_valid=node_valid,
        p_idx=p_idx, s_idx=s_idx, e_lo=e_lo, edge_valid=edge_valid,
        out_deg=out_deg, in_deg=in_deg, branch=branch, succ=succ, pred=pred,
        w_start=w_start, wvalid=wvalid, n_walks=n_walks,
        prefix_chars=prefix_chars, n_nodes_total=n_nodes_total,
    )


@partial(jax.jit, static_argnames=("k", "max_len", "max_walks", "node_cap"))
def contigs_big_k(codes_hi: jnp.ndarray, codes_lo: jnp.ndarray,
                  kmer_valid: jnp.ndarray, k: int, max_len: int,
                  max_walks: int, node_cap: int | None = None):
    """Fused big-k build + doubling walk for one segment's k-mer pair codes.
    Same contract as dbg.graph.contigs_sparse: with node_cap set, the unique
    nodes (compacted to the array front) are sliced to [node_cap] before the
    joins and the walk — callers check the returned n_nodes <= node_cap and
    retry larger. At BASELINE config 1 (E=1.6M, 50k real nodes) this cuts
    the doubling walk's gather work ~60x."""
    g = _graph_big_k(codes_hi, codes_lo, kmer_valid, k, max_walks, node_cap)
    max_walks = g["w_start"].shape[0]
    buf, lens, overflow = walk_contigs_doubling(
        g["node_char"], g["succ"], g["pred"], g["branch"], g["out_deg"],
        g["w_start"], jnp.zeros(max_walks, jnp.int32), g["wvalid"], k, max_len,
    )
    buf = buf.at[:, : k - 1].set(
        jnp.where(g["wvalid"][:, None], g["prefix_chars"], buf[:, : k - 1])
    )
    return buf, lens, g["wvalid"], overflow, g["n_walks"], g["n_nodes_total"]
