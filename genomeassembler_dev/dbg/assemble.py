"""Host glue: reads -> device dBG -> canonical contig set.

Chooses the dense direct-indexed graph (no sorts; k <= DENSE_MAX_K) or the
sparse sorted-unique graph, walks contigs by pointer doubling, and compacts
the fixed-capacity buffers to the canonical (sorted, deduplicated) contig
list that the merge stage and the reference semantics operate on
(ref: lib/DeNovoAssembler.cpp:192).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import decode_dna
from genomeassembler_dev.dbg.dense import contigs_dense
from genomeassembler_dev.dbg.graph import contigs_sparse
from genomeassembler_dev.ops.windows import kmer_window_codes

# 4^10 = 1M presence bins per segment; beyond this the sparse path wins
DENSE_MAX_K = 10


# jitted window/pair-code extraction for the serial path: eagerly these are
# O(k) dispatched device ops (~124 dispatches at k=31)
@partial(jax.jit, static_argnames=("k",))
def _window_codes_jit(codes, k: int):
    return kmer_window_codes(codes, k)


@partial(jax.jit, static_argnames=("k",))
def _pair_codes_jit(codes, k: int):
    from genomeassembler_dev.dbg.big_k import kmer_pair_codes

    return kmer_pair_codes(codes, k)


def _walk_cap_ladder(run, n_kmers: int, max_contig_len: int, mw0: int = 4096):
    """Run a contig builder under growing walk/node-capacity ladders.

    `run(max_walks, node_cap)` returns (buf, lens, valid, overflow, n_total,
    n_nodes); n_total/n_nodes are the TRUE counts regardless of capacity.
    Sizing the contig buffer [max_walks, max_contig_len] to the worst case
    (every k-mer a walk) OOMs at scale — e.g. BASELINE config 1 (50 kb,
    150 bp reads, k=31) has 1.6M k-mers x 100k cap = 160 GB — and sizing the
    node arrays to 2E makes the doubling walk pay ~2E/n_nodes x redundant
    gather work, while real counts are tiny. Start small and retry with the
    next power of two on overflow.

    mw0 caps the FIRST rung. The standard walk materialises node-domain
    scatters (cost ~V log V, walk-capacity-free), so 4096 is free there; the
    biased greedy walk materialises a [W, steps] path matrix whose gather
    work scales with W — its callers start at 64 (real walk counts are tens;
    overflow retries once at the true count's power of two, and the rung
    lands in the persistent compile cache for the study's remaining
    experiments)."""
    mw = min(mw0, 1 << max(1, n_kmers - 1).bit_length())
    nc = min(1 << max(1, max_contig_len + 64 - 1).bit_length(), 2 * n_kmers)
    while True:
        out = run(mw, nc)
        n_total, n_nodes = int(out[4]), int(out[5])
        if n_nodes > nc:
            nc = min(1 << (n_nodes - 1).bit_length(), 2 * n_kmers)
            continue
        if n_total <= mw:
            return out
        if n_total > n_kmers:
            raise ValueError(f"walk count {n_total} exceeds k-mer count {n_kmers}")
        mw = 1 << (n_total - 1).bit_length()


def contigs_from_read_codes(
    read_codes: np.ndarray,  # [N, R] base codes
    read_valid: np.ndarray,  # [N] bool
    dbg_kmer: int,
    max_contig_len: int,
    max_walks: int | None = None,
) -> list[str]:
    """Canonical contig set from packed reads. Raises if a walk overflows
    max_contig_len (caller retries with a larger cap); walk capacity is
    auto-laddered unless max_walks is given."""
    codes = jnp.asarray(read_codes)
    if dbg_kmer > 31:
        raise ValueError("dbg_kmer > 31 is not supported (62-bit code limit)")
    if dbg_kmer > 15:
        # two-word code path for large k (standard for 100-150bp reads)
        from genomeassembler_dev.dbg.big_k import contigs_big_k

        hi, lo, kvalid = _pair_codes_jit(codes, dbg_kmer)
        kvalid = kvalid & jnp.asarray(read_valid)[:, None]

        def run_big(mw, nc):
            return contigs_big_k(hi, lo, kvalid, dbg_kmer, max_contig_len, mw,
                                 node_cap=nc)

        if max_walks is None:
            out = _walk_cap_ladder(run_big, int(hi.size), max_contig_len)
        else:
            out = run_big(max_walks, None)
            if int(out[4]) > max_walks:
                raise ValueError(
                    f"{int(out[4])} walks exceed capacity {max_walks}")
        return _fetch_dedup_contigs(out)
    kcodes, kvalid = _window_codes_jit(codes, dbg_kmer)
    kvalid = kvalid & jnp.asarray(read_valid)[:, None]
    if dbg_kmer <= DENSE_MAX_K:
        def runner(mw, _nc):
            node_cap = 1024
            while True:
                out = contigs_dense(kcodes, kvalid, dbg_kmer, max_contig_len,
                                    mw, node_cap)
                if int(out[5]) <= node_cap:
                    # dense ladders its own node capacity; report it as fitting
                    return out[:5] + (jnp.int32(0),)
                node_cap = 1 << int(out[5] - 1).bit_length()  # retry, larger
    else:
        def runner(mw, nc):
            return contigs_sparse(kcodes, kvalid, dbg_kmer, max_contig_len,
                                  mw, node_cap=nc)

    if max_walks is None:
        out = _walk_cap_ladder(runner, int(kcodes.size), max_contig_len)
    else:
        out = runner(max_walks, None)
        if int(out[4]) > max_walks:
            raise ValueError(
                f"{int(out[4])} walks exceed capacity {max_walks}")
    return _fetch_dedup_contigs(out)


def _fetch_dedup_contigs(out) -> list[str]:
    """Slice the contig buffer to the real walk rows before the host fetch —
    the padded buffer can be hundreds of MB (4096 x 100k at config 1, with
    one real walk)."""
    buf, lens, valid, overflow, n_total, _ = out
    n = min(int(n_total), buf.shape[0])
    return dedup_contigs(
        np.asarray(buf[:n]), np.asarray(lens[:n]), np.asarray(valid[:n]),
        np.asarray(overflow[:n])
    )


def dedup_contigs(
    buf: np.ndarray, lens: np.ndarray, walk_valid: np.ndarray, overflow: np.ndarray
) -> list[str]:
    if (overflow & walk_valid).any():
        raise ValueError("contig walk overflowed max_contig_len; increase the cap")
    out = set()
    for row, ln, ok in zip(buf, lens, walk_valid):
        if ok:
            out.add(decode_dna(row[:ln]))
    return sorted(out)
