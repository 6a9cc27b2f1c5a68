"""Ultrasonication read simulation on device.

Reproduces the reference simulator (lib/GenerateReads.R:235-313):

  1. per-position octamer breakage-probability track of the segment
     (GenerateReads.R:243-259) — here a gather from the dense k=8 table,
  2. ceil(coverage * L / read_len) breakpoint draws with replacement,
     weighted by the track (GenerateReads.R:302-308) — here inverse-CDF
     sampling (cumsum + searchsorted) with JAX uniforms,
  3. discard draws whose read would overrun the 3' end
     (GenerateReads.R:310-313),
  4. reads = genome[pos : pos+read_len] (GenerateReads.R:368-379); read_2 is
     the reverse complement of read_1 (GenerateReads.R:437-439) and is only
     needed by external assemblers, so it is derived on demand.

The reference draws with R's `sample(prob=)` (Mersenne-Twister + walker
alias); replaying that bit-exactly is deliberately out of scope — the
framework's equality gate is: *given identical read sets*, contigs and scores
are bit-identical (SURVEY.md §7.1). Read sets can be saved/loaded so a run is
reproducible and sharable across backends.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.core.querytable import QueryTable
from genomeassembler_dev.ops.windows import kmer_window_codes


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["codes", "valid", "positions", "track"],
    meta_fields=["read_len"],
)
@dataclass
class ReadSet:
    """Fixed-capacity simulated read set (invalid slots = boundary discards)."""

    codes: jnp.ndarray  # [N, read_len] uint8 base codes
    valid: jnp.ndarray  # [N] bool
    positions: jnp.ndarray  # [N] int32 0-based breakpoint positions
    track: jnp.ndarray  # [L-k+1] float32 octamer probability track
    read_len: int

    @property
    def n_reads(self):
        return self.valid.sum()

    def coverage(self, genome_len: int):
        """Realised coverage (ref: GenerateReads.R:381-384)."""
        return self.n_reads * self.read_len / genome_len


def probability_track(genome_codes: jnp.ndarray, table_probs_k: jnp.ndarray, k: int):
    """Per-position k-mer probability track (GenerateReads.R:243-259).
    Windows containing non-ACGT bases get probability 0 (the reference would
    propagate NA and fail; we keep them unsampleable instead)."""
    codes, valid = kmer_window_codes(genome_codes, k)
    probs = jnp.asarray(table_probs_k, dtype=jnp.float32)[codes]
    return jnp.where(valid, probs, 0.0)


@partial(jax.jit, static_argnames=("read_len", "n_draws", "break_kmer"))
def simulate_reads(
    key: jax.Array,
    genome_codes: jnp.ndarray,  # [L] base codes
    table_probs_k8: jnp.ndarray,  # [65536] float32
    read_len: int,
    n_draws: int,
    break_kmer: int = 8,
) -> ReadSet:
    """Draw breakpoints weighted by the octamer track and gather reads."""
    L = genome_codes.shape[0]
    track = probability_track(genome_codes, table_probs_k8, break_kmer)
    cdf = jnp.cumsum(track)
    total = cdf[-1]
    u = jax.random.uniform(key, (n_draws,), dtype=jnp.float32) * total
    pos = jnp.searchsorted(cdf, u, side="right").astype(jnp.int32)
    pos = jnp.minimum(pos, track.shape[0] - 1)
    valid = pos + read_len <= L  # 3' boundary discard (GenerateReads.R:310-313)
    gather_idx = pos[:, None] + jnp.arange(read_len, dtype=jnp.int32)[None, :]
    gather_idx = jnp.minimum(gather_idx, L - 1)
    codes = genome_codes[gather_idx].astype(jnp.uint8)
    return ReadSet(codes=codes, valid=valid, positions=pos, track=track, read_len=read_len)


def n_draws_for(coverage_target: float, genome_len: int, read_len: int) -> int:
    """ceil(coverage * L / read_len) (GenerateReads.R:302)."""
    return math.ceil(coverage_target * genome_len / read_len)


def generate_reads(
    seed_key: jax.Array,
    genome_codes: np.ndarray,
    table: QueryTable,
    read_len: int,
    coverage_target: float,
    break_kmer: int = 8,
) -> ReadSet:
    """Convenience wrapper with the reference's draw-count formula."""
    n = n_draws_for(coverage_target, len(genome_codes), read_len)
    return simulate_reads(
        seed_key,
        jnp.asarray(genome_codes),
        jnp.asarray(table.probs[break_kmer], dtype=jnp.float32),
        read_len,
        n,
        break_kmer,
    )


def dedup_reads(read_codes: np.ndarray, valid: np.ndarray):
    """Distinct reads with multiplicities (ref: lib/DeNovoAssembler.cpp:333-337
    — scores are driven by counts of distinct reads, not raw reads).

    Reads containing non-ACGT codes are dropped here: downstream packed-word
    matching masks codes to 2 bits, which would silently alias N to T.

    Host-side: np.unique over a bytes view. Returns (unique_codes [U, R],
    counts [U] int32)."""
    read_codes = np.asarray(read_codes)
    valid = np.asarray(valid) & (read_codes <= 3).all(axis=1)
    arr = np.ascontiguousarray(read_codes[valid])
    if arr.size == 0:
        return arr.reshape(0, read_codes.shape[1]), np.zeros(0, np.int32)
    view = arr.view([("", arr.dtype)] * arr.shape[1]).ravel()
    uniq, counts = np.unique(view, return_counts=True)
    return uniq.view(arr.dtype).reshape(-1, arr.shape[1]), counts.astype(np.int32)
