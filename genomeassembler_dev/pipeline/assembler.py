"""Per-experiment orchestrator: the device-side run_assembler.

Mirrors the reference driver (lib/DeNovoAssembler.R:51-91): simulate reads ->
assemble -> score against the true and the uniform ("random") probability
tables -> join into one results table. Two deliberate efficiency divergences,
both output-preserving:

  * the reference recomputes get_contigs + assemble_contigs + the full
    read-matching pass twice, once per probability table
    (lib/DeNovoAssembler.R:325-355) — but assembly and matching do not depend
    on the table at all, so here the break-count matrix is computed once and
    both score families are two dot products against it;
  * consequently path_freq (and hence the KS statistic) is identical between
    the true and random passes — which is also true of the reference's
    outputs, since observed break frequencies never involve the table.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.core.encoding import INVALID, encode_dna
from genomeassembler_dev.core.querytable import QueryTable, load_default_query_table
from genomeassembler_dev.dbg.assemble import contigs_from_read_codes
from genomeassembler_dev.merge.engine import assemble_solutions
from genomeassembler_dev.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev.ops.histogram import count_kmers
from genomeassembler_dev.ops.ks import batched_ks_2samp
from genomeassembler_dev.ops.windows import kmer_window_codes
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.score.breakscore import breakscore
from genomeassembler_dev.sim.reads import dedup_reads, generate_reads
from genomeassembler_dev.utils.timers import StageTimer
from genomeassembler_dev.ops.mxu import dot_f32

RESULT_COLUMNS = [
    "sequence",
    "sequence_len",
    "bp_score_true",
    "bp_score_norm_by_break_freqs_true",
    "bp_score_norm_by_len_true",
    "kmer_breaks",
    "lev_dist_vs_true",
    "stat_test_KS_true",
    "contig_frac_len",
    "bp_score_random",
    "bp_score_norm_by_break_freqs_random",
    "bp_score_norm_by_len_random",
    "stat_test_KS_random",
]


@dataclass
class ExperimentResult:
    """One experiment's outputs: the joined solutions table (column order of
    the reference's inner join, lib/DeNovoAssembler.R:463-472) plus the
    dbg_summary stats (GenerateReads.R:218-223,381-385,461)."""

    columns: dict[str, np.ndarray | list]
    stats: dict
    timings: dict[str, float]

    @property
    def n_solutions(self) -> int:
        return len(self.columns["sequence"])


def _ladder(x: int, base: int) -> int:
    """Round x up the geometric-ish ladder {base, 2b, 4b, ... } then
    multiples of the largest power step — few distinct values, so repeated
    experiments share jit cache entries (remote compiles cost minutes)."""
    v = base
    while v < x and v < 16 * base:
        v *= 2
    if v >= x:
        return v
    step = 8 * base
    return -(-x // step) * step


def pack_strings(strings: list[str], pad: int = INVALID,
                 s_multiple: int = 1, l_multiple: int = 1):
    """[S] strings -> ([S', L'] uint8 codes, [S'] int32 lens).

    With s_multiple/l_multiple > 1, shapes round up a coarse bucket ladder so
    experiments with different solution counts/lengths hit the same jit cache
    entries instead of recompiling (pad rows have len 0)."""
    if not strings:
        return np.zeros((s_multiple, l_multiple), np.uint8), np.zeros(s_multiple, np.int32)
    Lmax = max(len(s) for s in strings)
    Smax = len(strings)
    L = _ladder(Lmax, l_multiple) if l_multiple > 1 else Lmax
    S = _ladder(Smax, s_multiple) if s_multiple > 1 else Smax
    mat = np.full((S, L), pad, np.uint8)
    lens = np.zeros(S, np.int32)
    for i, s in enumerate(strings):
        mat[i, : len(s)] = encode_dna(s)
        lens[i] = len(s)
    return mat, lens


def pad_reads(uniq: np.ndarray, counts: np.ndarray, multiple: int = 512):
    """Bucket the distinct-read arrays so the matcher's shapes repeat."""
    U = uniq.shape[0]
    Up = _ladder(max(U, 1), multiple)
    codes = np.zeros((Up, uniq.shape[1] if uniq.size else 1), np.uint8)
    cnts = np.zeros(Up, np.int32)
    valid = np.zeros(Up, bool)
    if U:
        codes[:U] = uniq
        cnts[:U] = counts
        valid[:U] = True
    return codes, cnts, valid


class Assembler:
    """Drives experiments over segments. Stateless across experiments apart
    from the loaded QueryTable."""

    def __init__(self, config: ExperimentConfig, table: QueryTable | None = None,
                 verbose: bool = False):
        self.config = config.validate()
        self.table = table if table is not None else load_default_query_table()
        self.uniform = QueryTable.uniform()
        self.verbose = verbose

    # -- stages -------------------------------------------------------------

    def simulate(self, genome_codes: np.ndarray, timer: StageTimer):
        cfg = self.config
        with timer.stage("Generating sequencing reads"):
            # the reference reseeds identically before every experiment
            # (scripts/02_…:37), so every experiment uses the same key here
            rs = generate_reads(
                jax.random.key(cfg.seed), genome_codes, self.table,
                cfg.read_len, cfg.coverage_target, cfg.kmer,
            )
            jax.block_until_ready(rs.codes)
        return rs

    def _replay_read_set(self, genome_codes: np.ndarray, read_set: tuple):
        """Wrap stored read arrays as a ReadSet (track recomputed from the
        segment — it is a pure function of segment + table)."""
        from genomeassembler_dev.sim.reads import ReadSet, probability_track

        codes, valid, positions = read_set
        track = probability_track(
            jnp.asarray(genome_codes),
            jnp.asarray(self.table.probs[self.config.kmer], jnp.float32),
            self.config.kmer,
        )
        return ReadSet(
            codes=jnp.asarray(codes), valid=jnp.asarray(valid),
            positions=jnp.asarray(positions), track=track,
            read_len=int(codes.shape[1]),
        )

    def contigs(self, read_codes, read_valid, timer: StageTimer) -> list[str]:
        cfg = self.config
        with timer.stage("Running DBG de novo genome assembler"):
            if cfg.traversal == "biased":
                return self._biased_contigs(read_codes, read_valid)
            return contigs_from_read_codes(
                np.asarray(read_codes), np.asarray(read_valid),
                cfg.dbg_kmer, cfg.contig_cap,
            )

    def _biased_contigs(self, read_codes, read_valid) -> list[str]:
        """Probability-guided traversal (dbg/biased.py): greedy continuation
        through branches by junction-octamer probability; the resulting
        extended assemblies then enter the same merge/score stages. Dispatch
        mirrors the standard walk: dense k <= 10, sparse k <= 15, two-word
        codes to k = 31 (BASELINE config 1 shape)."""
        from genomeassembler_dev.dbg.assemble import (
            DENSE_MAX_K, _walk_cap_ladder, dedup_contigs)
        from genomeassembler_dev.dbg.biased import (
            biased_contigs_big_k, biased_contigs_dense, biased_contigs_sparse)

        cfg = self.config
        probs8 = jnp.asarray(self.table.probs[8], jnp.float32)
        codes = jnp.asarray(np.asarray(read_codes))
        rvalid = jnp.asarray(np.asarray(read_valid))
        if cfg.dbg_kmer <= DENSE_MAX_K:
            kc, kv = kmer_window_codes(codes, cfg.dbg_kmer)
            kv = kv & rvalid[:, None]
            # walk-capacity ladder, mirroring the sparse/big-k paths: out[4]
            # is the TRUE walk count regardless of capacity, so graphs with
            # more branch out-edges than the current cap retry larger instead
            # of silently dropping walks
            mw = 2048
            while True:
                out = biased_contigs_dense(
                    kc, kv, probs8, cfg.dbg_kmer, cfg.contig_cap, mw,
                )
                n_walks = int(out[4])
                if n_walks <= mw:
                    out = out + (jnp.int32(0),)
                    break
                if n_walks > kc.size:
                    raise ValueError(
                        f"walk count {n_walks} exceeds k-mer count {kc.size}")
                mw = 1 << (n_walks - 1).bit_length()
        else:
            if cfg.dbg_kmer <= 15:
                kc, kv = kmer_window_codes(codes, cfg.dbg_kmer)
                kv = kv & rvalid[:, None]

                def run(mw, nc):
                    return biased_contigs_sparse(
                        kc, kv, probs8, cfg.dbg_kmer, cfg.contig_cap, mw,
                        node_cap=nc)
            else:
                from genomeassembler_dev.dbg.big_k import kmer_pair_codes

                hi, lo, kv = kmer_pair_codes(codes, cfg.dbg_kmer)
                kv = kv & rvalid[:, None]
                kc = hi  # size proxy for the ladder

                def run(mw, nc):
                    return biased_contigs_big_k(
                        hi, lo, kv, probs8, cfg.dbg_kmer, cfg.contig_cap, mw,
                        node_cap=nc)

            # the greedy walk's [W, steps] path materialisation scales with
            # walk capacity; start the ladder at 64 (see _walk_cap_ladder)
            out = _walk_cap_ladder(run, int(kc.size), cfg.contig_cap, mw0=64)
        buf, lens, wvalid, ovf = out[:4]
        # capped (overflowing) walks are kept at their truncated length
        return dedup_contigs(np.asarray(buf), np.asarray(lens),
                             np.asarray(wvalid), np.asarray(ovf) & False)

    def merge(self, contigs: list[str], timer: StageTimer) -> list[str]:
        cfg = self.config
        with timer.stage("Merging shuffled contig orderings"):
            if cfg.traversal == "biased":
                # the ordering-ensemble merge is the fragment-JOINING stage
                # for standard unitigs; biased walks already continue through
                # branches to dead ends, so each walk IS a maximal candidate
                # assembly. Merging them is both semantically vacuous (their
                # ends rarely share exact (k-1) overlaps) and combinatorially
                # explosive (distinct order-dependent concatenations of
                # ~50 kb strings OOM'd at 130 GB on BASELINE config 1).
                # Solution set = the canonically-sorted deduped assemblies,
                # truncated to the longest biased_max_solutions.
                sols = sorted(set(contigs), key=lambda s: (-len(s), s))
                return sols[: cfg.biased_max_solutions]
            return assemble_solutions(
                contigs, cfg.dbg_kmer, cfg.seed, cfg.n_orderings,
                backend=cfg.merge_backend,
            )

    def score(self, solutions: list[str], rs, genome_codes: np.ndarray,
              timer: StageTimer) -> dict[str, np.ndarray | list]:
        cfg = self.config
        with timer.stage("Evaluating each de novo assembled solution"):
            # bucketed shapes: jit caches hit across experiments whose
            # solution counts/lengths differ slightly
            pmat, plens = pack_strings(solutions, s_multiple=64, l_multiple=128)
            uniq, counts = dedup_reads(np.asarray(rs.codes), np.asarray(rs.valid))
            rcodes, rcounts, rvalid = pad_reads(uniq, counts, cfg.read_chunk)
            bs = breakscore(
                jnp.asarray(pmat), jnp.asarray(plens), jnp.asarray(rcodes),
                jnp.asarray(rcounts), jnp.asarray(rvalid),
                jnp.asarray(self.table.combined, jnp.float32),
                break_kmer=cfg.kmer, read_chunk=cfg.read_chunk,
            )
            # random pass: same break counts, uniform probabilities
            # (the reference recomputes everything; outputs are identical)
            uni = jnp.asarray(self.uniform.combined, jnp.float32)
            site_counts = bs.site_counts
            total = jnp.maximum(bs.kmer_breaks.astype(jnp.float32), 1.0)
            bp_rand = dot_f32(site_counts, uni)
            bp_rand_norm_breaks = jnp.where(
                bs.kmer_breaks > 0, dot_f32(site_counts / total[:, None], uni), 0.0
            )
            bp_rand_norm_len = bp_rand / jnp.maximum(plens.astype(jnp.float32), 1.0)

            lev = batched_levenshtein_auto(
                jnp.asarray(pmat), jnp.asarray(plens),
                jnp.asarray(genome_codes), mode="NW",
            )
            ks = batched_ks_2samp(bs.path_freq, rs.track)

            # own-path coverage fraction: all startpos are 0
            # (lib/DeNovoAssembler.R:363-364,431-445), so covered fraction is
            # max solution length / seq_len, capped at 100%.
            max_len = int(plens.max()) if len(solutions) else 0
            contig_frac = min(100.0, 100.0 * max_len / cfg.seq_len)

            # row order: true-table bp_score descending, stable
            # (data.table setorder; lib/DeNovoAssembler.R:359); bucket pad
            # rows are excluded
            n_real = len(solutions)
            order = np.argsort(-np.asarray(bs.bp_score)[:n_real], kind="stable")
            ksv = np.asarray(ks)
            cols = {
                "sequence": [solutions[i] for i in order],
                "sequence_len": plens[order],
                "bp_score_true": np.asarray(bs.bp_score)[order],
                "bp_score_norm_by_break_freqs_true": np.asarray(bs.bp_score_norm_by_break_freqs)[order],
                "bp_score_norm_by_len_true": np.asarray(bs.bp_score_norm_by_len)[order],
                "kmer_breaks": np.asarray(bs.kmer_breaks)[order],
                "lev_dist_vs_true": np.asarray(lev)[order],
                "stat_test_KS_true": ksv[order],
                "contig_frac_len": np.full(len(solutions), contig_frac),
                "bp_score_random": np.asarray(bp_rand)[order],
                "bp_score_norm_by_break_freqs_random": np.asarray(bp_rand_norm_breaks)[order],
                "bp_score_norm_by_len_random": np.asarray(bp_rand_norm_len)[order],
                "stat_test_KS_random": ksv[order],
            }
        return cols

    def count_only(self, rs, timer: StageTimer) -> dict[str, np.ndarray]:
        """The only_kmers_from_reads path (lib/DeNovoAssembler.R:135-168):
        count breakage-k-mers across reads and join with the probability
        table -> {kmer codes order}, prob, count."""
        cfg = self.config
        with timer.stage("Extracting k-mers from sequencing reads"):
            codes, valid = kmer_window_codes(jnp.asarray(rs.codes), cfg.kmer)
            valid = valid & jnp.asarray(rs.valid)[:, None]
            counts = count_kmers(codes, valid, 4**cfg.kmer)
            return {
                "prob": np.asarray(self.table.probs[cfg.kmer]),
                "count": np.asarray(counts),
            }

    # -- full experiment ----------------------------------------------------

    def run_experiment(self, segment: str,
                       read_set: tuple | None = None) -> ExperimentResult:
        """Run one experiment. `read_set` optionally replays a stored
        (codes, valid, positions) tuple (sim.reads_io npz format) instead of
        simulating — the cross-backend bit-equality gate of SURVEY §7.1:
        given identical read sets, every downstream output is deterministic.
        """
        cfg = self.config
        timer = StageTimer(self.verbose)
        genome_codes = encode_dna(segment)
        if read_set is not None:
            rs = self._replay_read_set(genome_codes, read_set)
        else:
            rs = self.simulate(genome_codes, timer)

        n_reads = int(np.asarray(rs.valid).sum())
        acgt = np.bincount(genome_codes[genome_codes <= 3], minlength=4)
        stats = {
            "base_composition": (acgt / len(segment)).tolist(),
            "coverage": round(n_reads * cfg.read_len / cfg.seq_len, 3),
            "nr_of_reads": n_reads,
            "genome_seq": segment,
        }

        if cfg.only_kmers_from_reads:
            cols = self.count_only(rs, timer)
            return ExperimentResult(columns=cols, stats=stats, timings=timer.times)

        contigs = self.contigs(rs.codes, rs.valid, timer)
        solutions = self.merge(contigs, timer)
        cols = self.score(solutions, rs, genome_codes, timer)
        return ExperimentResult(columns=cols, stats=stats, timings=timer.times)
