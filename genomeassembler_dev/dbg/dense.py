"""Dense (direct-indexed) de Bruijn graph for small k, matmul-formulated.

For dbg_kmer k with 4^k bins that fit memory (k <= ~10), the graph needs no
sorting or hashing — the reference's hash maps
(lib/DeNovoAssembler.cpp:104-169) become dense arrays, built from sorts and
one-hot matmuls rather than gathers and scatters (the design's first
accelerator ran those near-scalar; not re-measured on the H100, ROADMAP S4):

  * edge presence over all 4^k codes via the one-hot matmul histogram
    (ops/mxu.py) — no scatter;
  * out_deg = presence.reshape(V, 4).sum(-1) and
    in_deg = presence.reshape(4, V).sum(0) — the 4 extensions of a prefix
    are adjacent, the 4 predecessors of a suffix are strided: pure reshapes;
  * succ/pred of chain nodes by argmax over those 4 lanes;
  * active nodes compacted by *sorting* (node_id if active else V) instead
    of the scatter inside jnp.nonzero;
  * the pointer-doubling walk runs on the compacted node array with its
    gathers expressed as one-hot permutation matmuls
    (doubling logic mirrors dbg/doubling.py, which documents the algorithm
    against the reference's sequential walk, cpp:171-189).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.ops.mxu import (
    count_kmers_mxu, permutation_gather_mxu, scatter_by_rank_mxu)

PAD = np.uint8(255)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["presence", "in_deg", "out_deg", "branch", "succ", "pred"],
    meta_fields=["k"],
)
@dataclass
class DenseDBG:
    k: int
    presence: jnp.ndarray  # [4^k] bool
    in_deg: jnp.ndarray  # [V] int32, V = 4^(k-1)
    out_deg: jnp.ndarray  # [V] int32
    branch: jnp.ndarray  # [V] bool
    succ: jnp.ndarray  # [V] int32 dense node id (-1 unless out==1)
    pred: jnp.ndarray  # [V] int32 dense node id (-1 unless in==1)


@partial(jax.jit, static_argnames=("k",))
def build_dbg_dense(kmer_codes: jnp.ndarray, kmer_valid: jnp.ndarray, k: int) -> DenseDBG:
    V = 4 ** (k - 1)
    presence = count_kmers_mxu(kmer_codes.reshape(-1), kmer_valid.reshape(-1), k) > 0

    by_prefix = presence.reshape(V, 4)
    out_deg = by_prefix.sum(axis=1).astype(jnp.int32)
    by_suffix = presence.reshape(4, V)
    in_deg = by_suffix.sum(axis=0).astype(jnp.int32)

    branch = ((in_deg != 1) | (out_deg != 1)) & (out_deg > 0)

    node = jnp.arange(V, dtype=jnp.int32)
    succ_char = jnp.argmax(by_prefix, axis=1).astype(jnp.int32)
    succ = jnp.where(out_deg == 1, ((node << 2) | succ_char) & (V - 1), -1)
    pred_char = jnp.argmax(by_suffix, axis=0).astype(jnp.int32)
    # in-edge with first char c has prefix = (c*V + node) >> 2
    pred = jnp.where(in_deg == 1, (pred_char * V + node) >> 2, -1)

    return DenseDBG(k=k, presence=presence, in_deg=in_deg, out_deg=out_deg,
                    branch=branch, succ=succ, pred=pred)


def _gather_limbs24_mxu(vals: jnp.ndarray, idx: jnp.ndarray, M: int) -> jnp.ndarray:
    """out[i] = vals[idx[i]] for int32 vals in [0, 2^24), via a two-level
    one-hot contraction over three 8-bit bf16 limb channels — every operand
    is bf16-exact, so the MXU needs a single pass (an f32 values operand
    would force HIGHEST multi-pass lowering). idx in [0, M), M a power of
    two with M >= 256 lanes-friendly."""
    bits = M.bit_length() - 1
    lo_bits = bits // 2
    H, L = M >> lo_bits, 1 << lo_bits
    hi = (idx >> lo_bits).astype(jnp.int32)
    lo = (idx & (L - 1)).astype(jnp.int32)
    oh_hi = (hi[:, None] == jnp.arange(H, dtype=jnp.int32)).astype(jnp.bfloat16)
    limbs = jnp.stack(
        [(vals >> 16) & 255, (vals >> 8) & 255, vals & 255], axis=-1
    ).astype(jnp.bfloat16)  # [M, 3]
    v2 = limbs.reshape(H, L * 3)
    tmp = jnp.einsum("mh,hd->md", oh_hi, v2,
                     preferred_element_type=jnp.float32).reshape(M, L, 3)
    oh_lo = (lo[:, None] == jnp.arange(L, dtype=jnp.int32)).astype(jnp.float32)
    g = (tmp * oh_lo[..., None]).sum(axis=-2)  # [M, 3] exact f32
    return (g[:, 0].astype(jnp.int32) << 16) | (g[:, 1].astype(jnp.int32) << 8) \
        | g[:, 2].astype(jnp.int32)


def _sort_compact(mask: jnp.ndarray, size: int):
    """Indices of true entries, compacted by sort (ascending index order).
    Returns (idx [size] int32 clamped, valid [size] bool, n_true)."""
    N = mask.shape[0]
    keys = jnp.where(mask, jnp.arange(N, dtype=jnp.int32), N)
    s = jax.lax.sort(keys)[:size]
    valid = s < N
    return jnp.minimum(s, N - 1), valid, mask.sum().astype(jnp.int32)


def _node_table_dense(kmer_codes: jnp.ndarray, kmer_valid: jnp.ndarray,
                      k: int, M: int):
    """Compacted active-node table from the dense 4^k presence bitmap.

    Returns (nodes_c [M] ascending dense (k-1)-mer ids, c_nib [M] packed
    out|in<<4 edge nibbles, n_nodes true count). O(4^k) work — right when
    the k-mer windows outnumber the table."""
    from genomeassembler_dev.ops.mxu import compact_by_rank_mxu

    presence = count_kmers_mxu(kmer_codes.reshape(-1), kmer_valid.reshape(-1), k) > 0
    V = 4 ** (k - 1)

    # the 4 out-edges of a prefix are adjacent codes, the 4 in-edges of a
    # suffix are V-strided: both nibbles come from pure reshapes
    four = jnp.array([1, 2, 4, 8], jnp.int32)
    nib_out = (presence.reshape(V, 4).astype(jnp.int32) * four).sum(axis=1)
    nib_in = (presence.reshape(4, V).astype(jnp.int32) * four[:, None]).sum(axis=0)
    active = (nib_out | nib_in) > 0

    # compact active nodes (ascending id = rank order) via the MXU; weights
    # are 8-bit limbs: node id (2 limbs for k <= 9, 3 beyond) and the nibbles
    node = jnp.arange(V, dtype=jnp.int32)
    id_limbs = [(node >> s) & 255 for s in range(0, 2 * (k - 1), 8)]
    compacted, n_nodes = compact_by_rank_mxu(
        active, tuple(id_limbs + [nib_out | (nib_in << 4)]), M)
    nodes_c = sum(c << (8 * i) for i, c in enumerate(compacted[:-1]))
    return nodes_c, compacted[-1], n_nodes


def _node_table_sorted(kmer_codes: jnp.ndarray, kmer_valid: jnp.ndarray,
                       k: int, M: int):
    """Same contract as _node_table_dense, built from the 2N edge items by
    one sort + rank scatter — O(N log N) instead of O(4^k), the win when the
    windows are few and k is large (study shapes: ~8k items vs 262k dense
    bins at k=9).

    Each k-mer edge contributes two items packed (node_id << 8) | nibble_bit:
    its prefix node with the out-edge bit 1<<last_char, and its suffix node
    with the in-edge bit 16<<first_char. After sorting, distinct items of one
    node carry DISTINCT single-bit nibbles, so summing unique items per node
    == OR — one weighted rank-histogram (MXU) yields the packed nibbles, and
    run-last rows scatter the node ids, with rank = distinct-ids-so-far."""
    from genomeassembler_dev.ops.mxu import scatter_by_rank_mxu

    V = 4 ** (k - 1)
    SENT = jnp.int32(2**30)
    e = kmer_codes.reshape(-1).astype(jnp.int32)
    v = kmer_valid.reshape(-1)
    out_item = ((e >> 2) << 8) | (1 << (e & 3))
    in_item = ((e & (V - 1)) << 8) | (16 << (e >> (2 * (k - 1))))
    items = jnp.concatenate(
        [jnp.where(v, out_item, SENT), jnp.where(v, in_item, SENT)])
    s = jnp.sort(items)
    valid = s < SENT
    head1 = jnp.ones((1,), bool)
    uniq = valid & jnp.concatenate([head1, s[1:] != s[:-1]])
    sid = s >> 8
    id_start = valid & jnp.concatenate([head1, sid[1:] != sid[:-1]])
    run_last = valid & jnp.concatenate([sid[1:] != sid[:-1], head1])
    rank = jnp.cumsum(id_start.astype(jnp.int32)) - 1
    id_limbs = [
        jnp.where(run_last, (sid >> t) & 255, 0)
        for t in range(0, 2 * (k - 1), 8)
    ]
    nib_w = jnp.where(uniq, s & 255, 0)
    outs = scatter_by_rank_mxu(rank, valid, tuple(id_limbs + [nib_w]), M)
    nodes_c = sum(c << (8 * i) for i, c in enumerate(outs[:-1]))
    n_nodes = id_start.sum().astype(jnp.int32)
    return nodes_c, outs[-1], n_nodes


@partial(jax.jit, static_argnames=("k", "max_len", "max_walks", "node_cap"))
def contigs_dense(
    kmer_codes: jnp.ndarray,
    kmer_valid: jnp.ndarray,
    k: int,
    max_len: int,
    max_walks: int,
    node_cap: int = 1024,
):
    """Fused dense build + MXU doubling walk for one segment.

    Returns (buf [max_walks, max_len] uint8, lens, walk_valid, overflow,
    n_walks_total, n_nodes_total). Callers must check n_walks_total <=
    max_walks and n_nodes_total <= node_cap (else retry with larger caps).
    """
    from genomeassembler_dev.ops.mxu import searchsorted_mxu

    V = 4 ** (k - 1)
    M = min(node_cap, V)
    max_walks = min(max_walks, 4 * M)  # walks are (branch node, char) pairs

    # item-sort work is O(2N log 2N), dense-table work is O(4^k): static
    # dispatch on which is smaller (the factor 8 is untuned for the H100,
    # ROADMAP S7)
    if 8 * kmer_codes.size <= 4**k:
        nodes_c, c_nib, n_nodes = _node_table_sorted(kmer_codes, kmer_valid, k, M)
    else:
        nodes_c, c_nib, n_nodes = _node_table_dense(kmer_codes, kmer_valid, k, M)
    node_ok = jnp.arange(M, dtype=jnp.int32) < n_nodes

    bits_out = ((c_nib[:, None] >> jnp.arange(4)) & 1)
    bits_in = ((c_nib[:, None] >> (4 + jnp.arange(4))) & 1)
    out_deg_c = bits_out.sum(axis=1)
    in_deg_c = bits_in.sum(axis=1)
    branch_c = ((in_deg_c != 1) | (out_deg_c != 1)) & (out_deg_c > 0) & node_ok
    out0_c = (out_deg_c == 0) | ~node_ok
    succ_char = jnp.argmax(bits_out, axis=1).astype(jnp.int32)
    pred_char = jnp.argmax(bits_in, axis=1).astype(jnp.int32)

    # dense ids of the unique successor/predecessor (V = none); both are
    # themselves active nodes, so rank lookup = searchsorted into nodes_c
    succ_dense = jnp.where(node_ok & (out_deg_c == 1),
                           ((nodes_c << 2) | succ_char) & (V - 1), V)
    pred_dense = jnp.where(node_ok & (in_deg_c == 1),
                           (pred_char * V + nodes_c) >> 2, V)
    nodes_sorted = jnp.where(node_ok, nodes_c, jnp.int32(2**30))
    succ_c = jnp.where(succ_dense < V, searchsorted_mxu(nodes_sorted, succ_dense), -1)
    pred_c = jnp.where(pred_dense < V, searchsorted_mxu(nodes_sorted, pred_dense), -1)

    nib_c = (bits_out == 1) & node_ok[:, None]
    char_c = (nodes_c & 3).astype(jnp.uint8)

    terminal = branch_c | out0_c  # padding slots are terminal self-loops
    self_idx = jnp.arange(M, dtype=jnp.int32)

    # ---- walks: (branch node, out-char) pairs -----------------------------
    walk_slot_mask = (nib_c & branch_c[:, None]).reshape(M * 4)
    if max_walks & (max_walks - 1) == 0:
        # rank compaction on the MXU instead of a [4M] sort
        from genomeassembler_dev.ops.mxu import compact_by_rank_mxu

        slot = jnp.arange(M * 4, dtype=jnp.int32)
        limbs = tuple((slot >> s) & 255
                      for s in range(0, max(1, (4 * M - 1).bit_length()), 8))
        compacted_w, n_walks = compact_by_rank_mxu(
            walk_slot_mask, limbs, max_walks)
        wsel = sum(c << (8 * i) for i, c in enumerate(compacted_w))
        wvalid = jnp.arange(max_walks, dtype=jnp.int32) < n_walks
    else:
        wsel, wvalid, n_walks = _sort_compact(walk_slot_mask, max_walks)
    w_node = wsel >> 2  # compact index of branch prefix node
    w_char = (wsel & 3).astype(jnp.int32)
    # dense (k-1)-mer code of the prefix (MXU gather: codes < 4^9 < 2^24)
    w_prefix_code = permutation_gather_mxu(
        nodes_c.astype(jnp.float32)[:, None], w_node)[:, 0].astype(jnp.int32)
    w_start_dense = ((w_prefix_code << 2) | w_char) & (V - 1)
    w_start = jnp.where(wvalid, searchsorted_mxu(nodes_sorted, w_start_dense), -1)

    # ---- pointer doubling with MXU permutation gathers --------------------
    # only the upstream (head/offset) chain is chased: the chain's last node
    # (whose successor is terminal) scatters the walk's terminal character
    # and length, so the downstream (terminal/distance) chain — and half the
    # gathers — is unnecessary (see dbg/doubling.py docstring)
    t_at_pred = permutation_gather_mxu(
        terminal.astype(jnp.float32)[:, None], jnp.maximum(pred_c, 0))[:, 0] > 0
    head = ~terminal & ((pred_c < 0) | t_at_pred)
    up_ok = ~terminal & ~head & (pred_c >= 0)
    uptr = jnp.where(up_ok, jnp.maximum(pred_c, 0), self_idx)
    uoff = jnp.where(up_ok, 1, 0).astype(jnp.float32)

    n_iters = max(1, min(max_len, M).bit_length())
    if M * M <= 2**24:
        # pack (uptr, uoff) into ONE f32 gather channel: both are < M (a
        # power of two), so uptr*M + uoff < M^2 <= 2^24 stays f32-exact —
        # halves the gather traffic. (An 8-bit bf16-limb variant, 3 channels
        # in one bf16 pass, was slower on the first accelerator: its widened
        # [M, L*3] intermediate cost more than the f32 HIGHEST passes it
        # avoids.)
        fM = float(M)
        for _ in range(n_iters):
            pk = uptr.astype(jnp.float32) * fM + uoff
            g = permutation_gather_mxu(pk[:, None], uptr)[:, 0]
            gp = jnp.floor(g / fM)
            uoff = uoff + (g - gp * fM)
            uptr = gp.astype(jnp.int32)
        uoff = uoff.astype(jnp.int32)
    else:
        for _ in range(n_iters):
            gu = permutation_gather_mxu(
                jnp.stack([uptr.astype(jnp.float32), uoff], axis=-1), uptr
            )
            uoff = uoff + gu[:, 1]
            uptr = gu[:, 0].astype(jnp.int32)
        uoff = uoff.astype(jnp.int32)

    # ---- walk ids at heads -------------------------------------------------
    # every gather/scatter below is matmul-formulated (dynamic gathers and
    # .at[].set scatters were the step's largest cost on the first
    # accelerator; not re-measured on the H100).
    # Sum-semantics histograms are exact here because no two VALID walks
    # collide: a shared start node would have in-degree >= 2, hence be a
    # branch (terminal) node, hence be excluded from start_nonterm.
    s_c = jnp.maximum(w_start, 0)
    # start node's (char, terminal) in one packed f32 channel (< 8)
    g_s = permutation_gather_mxu(
        ((nodes_c & 3) + 4 * terminal.astype(jnp.int32)
         ).astype(jnp.float32)[:, None], s_c)[:, 0].astype(jnp.int32)
    s_char = (g_s & 3).astype(jnp.uint8)
    s_term = (g_s >> 2) > 0
    start_nonterm = wvalid & ~s_term
    start_term = wvalid & s_term

    # head_walk[m] = id of the walk whose chain head is node m (-1 if none):
    # an inverse-permutation scatter as a rank histogram over the M nodes
    wid_iota = jnp.arange(max_walks, dtype=jnp.int32)
    hw = scatter_by_rank_mxu(
        jnp.where(start_nonterm, w_start, M),
        start_nonterm,
        (wid_iota & 255, wid_iota >> 8, jnp.ones_like(wid_iota)),
        M)
    head_walk = jnp.where(hw[2] > 0, hw[0] | (hw[1] << 8), -1)

    # per-node walk id + successor's (char, terminal), two MXU gathers
    wid = permutation_gather_mxu(
        head_walk.astype(jnp.float32)[:, None], uptr)[:, 0].astype(jnp.int32)
    node_write = ~terminal & (wid >= 0)
    succ_cc = jnp.maximum(succ_c, 0)  # interior => succ_c >= 0
    g_sc = permutation_gather_mxu(
        (char_c.astype(jnp.int32) + 4 * terminal.astype(jnp.int32)
         ).astype(jnp.float32)[:, None], succ_cc)[:, 0].astype(jnp.int32)
    last_char = (g_sc & 3).astype(jnp.uint8)
    is_last = node_write & ((g_sc >> 2) > 0)

    # walk lengths: one-per-walk rank histogram over the walk slots
    MWP = 1 << (max_walks - 1).bit_length()  # histogram sizes: powers of two
    lrows = jnp.where(is_last, wid, MWP)
    lval = k + 1 + uoff  # < 2^16
    lw = scatter_by_rank_mxu(lrows, is_last, (lval & 255, lval >> 8), MWP)
    lens0 = (lw[0] | (lw[1] << 8))[:max_walks]

    # ---- buffer: one char histogram over (walk, position) cells ------------
    # rows: interior nodes, last-of-chain terminal chars, terminal-start
    # walks. Weights are char+1 (so 0 = untouched = PAD); all targets are
    # distinct for valid walks (chain offsets are unique; the last write
    # lands one past the largest interior offset; terminal-start walks have
    # no interior writers), so the f32 sums are the chars themselves.
    MLP = 1 << (max_len - 1).bit_length()  # pad positions to a power of two
    S = MWP * MLP
    if S >= 2**31:
        raise ValueError(
            f"walk buffer {max_walks} x {max_len} overflows int32 flat indexing")
    pbits = MLP.bit_length() - 1
    pos_i = jnp.minimum(k - 1 + uoff, MLP - 1)
    pos_l = jnp.minimum(k + uoff, max_len - 1)
    rank_cat = jnp.concatenate([
        (wid << pbits) | pos_i,
        (wid << pbits) | pos_l,
        (wid_iota << pbits) | (k - 1),
    ])
    mask_cat = jnp.concatenate([node_write, is_last, start_term])
    char_cat = jnp.concatenate([
        char_c.astype(jnp.int32) + 1,
        last_char.astype(jnp.int32) + 1,
        s_char.astype(jnp.int32) + 1,
    ])
    (cells,) = scatter_by_rank_mxu(rank_cat, mask_cat, (char_cat,), S)
    bufp = jnp.where(
        (cells >= 1) & (cells <= 4), cells - 1, jnp.int32(PAD)
    ).astype(jnp.uint8).reshape(MWP, MLP)
    buf = bufp[:max_walks, :max_len]
    cols = jnp.arange(k - 1, dtype=jnp.int32)
    shifts = 2 * (k - 2 - cols)
    prefix_chars = ((w_prefix_code[:, None] >> shifts[None, :]) & 3).astype(jnp.uint8)
    buf = buf.at[:, : k - 1].set(jnp.where(wvalid[:, None], prefix_chars, PAD))

    lens = jnp.where(wvalid, jnp.where(start_term, k, lens0), 0)
    # lens0 == 0 on an interior-start walk: the up-chain did not converge in
    # 2^n_iters >= min(max_len, M) steps, i.e. the chain overflows max_len
    overflow = wvalid & ((lens > max_len) | (start_nonterm & (lens0 == 0)))

    return buf, lens, wvalid, overflow, n_walks, n_nodes
