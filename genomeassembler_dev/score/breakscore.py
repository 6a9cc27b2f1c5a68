"""Device breakage scorer.

Device re-design of the reference scorer (lib/DeNovoAssembler.cpp:316-477):

  * read dedup with counts happens once on host (cpp:333-337),
  * exact matching of every distinct read in every solution is the packed-word
    search of ops/match.py (cpp:354-360's string::find loop),
  * break-site octamers come from the solutions' precomputed octamer window
    codes: site code = win8[start] >> 2*(8-ek) with the pos in {1,2,3} edge
    shrinkage to 2/4/6-mers (cpp:362-386),
  * per-solution break counts are a scatter-add into the combined 69,904-entry
    table index space (cpp:389-390), and every bp_score flavour is a dense
    dot product counts @ probs (cpp:394-426) — one f32 matmul over the batch
    at HIGHEST precision (ops/mxu.dot_f32).

Outputs use the canonical combined-table order for path_freq; the reference
emits hash-map order, which only feeds order-invariant statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from genomeassembler_dev.core.querytable import OFFSETS, TOTAL
from genomeassembler_dev.ops.match import find_first_match_auto
from genomeassembler_dev.ops.windows import kmer_window_codes
from genomeassembler_dev.ops.mxu import dot_f32


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "bp_score", "bp_score_norm_by_break_freqs", "bp_score_norm_by_len",
        "kmer_breaks", "path_freq", "site_counts",
    ],
    meta_fields=[],
)
@dataclass
class BreakScores:
    bp_score: jnp.ndarray  # [S] float32
    bp_score_norm_by_break_freqs: jnp.ndarray  # [S] float32
    bp_score_norm_by_len: jnp.ndarray  # [S] float32
    kmer_breaks: jnp.ndarray  # [S] int32 total matched read count
    path_freq: jnp.ndarray  # [S, TOTAL] float32, NaN rows when no matches
    site_counts: jnp.ndarray  # [S, TOTAL] float32 raw break counts


@partial(jax.jit, static_argnames=("break_kmer", "read_chunk"))
def breakscore(
    path_codes: jnp.ndarray,  # [S, L] base codes, pad > 3
    path_lens: jnp.ndarray,  # [S] int32
    read_codes: jnp.ndarray,  # [U, R] distinct read base codes
    read_counts: jnp.ndarray,  # [U] int32 multiplicities
    read_valid: jnp.ndarray,  # [U] bool
    probs_combined: jnp.ndarray,  # [TOTAL] float32 (true or uniform table)
    break_kmer: int = 8,
    read_chunk: int = 512,
) -> BreakScores:
    S, L = path_codes.shape
    found, first = find_first_match_auto(path_codes, path_lens, read_codes,
                                         read_valid, read_chunk=read_chunk)

    # break-site combined-table index per (solution, read)
    pos = first  # [S, U]
    start = jnp.maximum(0, pos - break_kmer // 2)
    ek = jnp.where(pos == 1, 2, jnp.where(pos == 2, 4, jnp.where(pos == 3, 6, 8)))
    ek = jnp.where(start == 0, ek, 8)
    win8, win8_valid = kmer_window_codes(path_codes, 8)  # [S, L-7]
    start_c = jnp.minimum(start, win8.shape[1] - 1)
    code8 = jnp.take_along_axis(win8, start_c, axis=1)  # [S, U]
    site_code = code8 >> (2 * (8 - ek))
    offsets = jnp.array([OFFSETS[2], OFFSETS[4], OFFSETS[6], OFFSETS[8]], jnp.int32)
    off = offsets[(ek >> 1) - 1]
    combined_idx = off + site_code

    # scatter-add read multiplicities into per-solution break counts;
    # unmatched reads carry weight 0, so routing them to index 0 is a no-op
    # add (keeps every index in range: the scorer is checkify-index-clean,
    # tests/test_sanitizers.py)
    w = jnp.where(found, read_counts[None, :], 0).astype(jnp.float32)
    row = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[:, None], combined_idx.shape)
    idx = jnp.where(found, combined_idx, 0)
    counts = jnp.zeros((S, TOTAL), jnp.float32).at[row, idx].add(w, mode="drop")
    total = w.sum(axis=1)  # [S]

    probs = probs_combined.astype(jnp.float32)
    bp_score = dot_f32(counts, probs)
    safe_total = jnp.maximum(total, 1.0)
    norm_by_breaks = dot_f32(counts / safe_total[:, None], probs)
    norm_by_breaks = jnp.where(total > 0, norm_by_breaks, 0.0)
    norm_by_len = bp_score / jnp.maximum(path_lens.astype(jnp.float32), 1.0)
    path_freq = jnp.where(total[:, None] > 0, counts / safe_total[:, None], jnp.nan)

    return BreakScores(
        bp_score=bp_score,
        bp_score_norm_by_break_freqs=norm_by_breaks,
        bp_score_norm_by_len=norm_by_len,
        kmer_breaks=total.astype(jnp.int32),
        path_freq=path_freq,
        site_counts=counts,
    )
