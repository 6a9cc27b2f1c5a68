"""Industry-standard (external-assembler) path.

The reference's velvet path (SURVEY.md §3.2): reads are written as paired
FASTAs, velvet assembles them externally, and the resulting contigs.fa enters
the scoring pipeline with its own variant semantics
(lib/DeNovoAssembler.R:173-233, lib/BreakageScorer.cpp):

  * 20,000 shuffled orderings, shuffling seeded inside the merge
    (BreakageScorer.cpp:85-94) — our merge engine already seeds its own
    mt19937, so semantics are identical;
  * per-solution rolling octamer probability profile `path_prob_dist`
    (BreakageScorer.cpp:199-215);
  * `path_prob_dist_startpos` = first occurrence of the solution in the true
    sequence (BreakageScorer.cpp:273-274; computed unconditionally here —
    the reference only updates it when a read matches, leaving 0 otherwise,
    which is drift, see SURVEY §3.2);
  * solutions absent from the true sequence (startpos == -1) are dropped
    (lib/DeNovoAssembler.R:360-362);
  * Levenshtein in HW (infix) mode (BreakageScorer.cpp:46);
  * KS statistic of the probability profile vs the genome's octamer track
    (the documented intent of lib/DeNovoAssembler.R:419-426);
  * genome coverage fraction via interval union of [startpos, startpos+len]
    (lib/DeNovoAssembler.R:431-445, replicated literally including its
    endpoint convention).

The velveth/velvetg subprocess adapter mirrors lib/DeNovoAssembler.R:182-222
and activates only when the binaries exist; otherwise callers supply a
contigs FASTA (the C14 contract: contigs.fa in, scored solutions out).
"""

from __future__ import annotations

import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.merge.engine import assemble_solutions
from genomeassembler_dev.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev.ops.ks import batched_ks_2samp_masked
from genomeassembler_dev.ops.windows import kmer_window_codes
from genomeassembler_dev.pipeline.assembler import (
    Assembler,
    ExperimentResult,
    pack_strings,
    pad_reads,
)
from genomeassembler_dev.score.breakscore import breakscore
from genomeassembler_dev.sim.reads import dedup_reads
from genomeassembler_dev.sim.segments import read_fasta
from genomeassembler_dev.utils.timers import StageTimer
from genomeassembler_dev.ops.mxu import dot_f32

VELVET_RESULT_COLUMNS = [
    "sequence", "sequence_len",
    "bp_score_true", "bp_score_norm_by_break_freqs_true",
    "bp_score_norm_by_len_true", "kmer_breaks", "lev_dist_vs_true",
    "stat_test_KS_true", "path_prob_dist_startpos", "contig_frac_len",
    "bp_score_random", "bp_score_norm_by_break_freqs_random",
    "bp_score_norm_by_len_random", "stat_test_KS_random",
]


def covered_fraction(startpos: np.ndarray, lens: np.ndarray, seq_len: int) -> float:
    """GRanges reduce/setdiff coverage (lib/DeNovoAssembler.R:431-445):
    solution ranges [startpos, startpos+len] (the R code's literal endpoint
    convention) unioned; covered% of [1, seq_len]."""
    ivals = []
    for s, ln in zip(startpos, lens):
        lo, hi = max(1, int(s)), min(seq_len, int(s) + int(ln))
        if hi >= lo:
            ivals.append((lo, hi))
    if not ivals:
        return 0.0
    ivals.sort()
    covered = 0
    cur_lo, cur_hi = ivals[0]
    for lo, hi in ivals[1:]:
        if lo > cur_hi + 1:
            covered += cur_hi - cur_lo + 1
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    covered += cur_hi - cur_lo + 1
    return 100.0 * (1.0 - (seq_len - covered) / seq_len)


class IndustryAssembler(Assembler):
    """Scores externally-assembled contigs with the velvet-path semantics."""

    def run_external(self, segment: str, external_contigs: list[str]) -> ExperimentResult:
        cfg = self.config
        timer = StageTimer(self.verbose)
        genome_codes = encode_dna(segment)
        rs = self.simulate(genome_codes, timer)

        n_reads = int(np.asarray(rs.valid).sum())
        acgt = np.bincount(genome_codes[genome_codes <= 3], minlength=4)
        stats = {
            "base_composition": (acgt / len(segment)).tolist(),
            "coverage": round(n_reads * cfg.read_len / cfg.seq_len, 3),
            "nr_of_reads": n_reads,
            "genome_seq": segment,
        }

        with timer.stage("Merging shuffled contig orderings (velvet path)"):
            n_ord = cfg.velvet_n_orderings or 20000
            solutions = assemble_solutions(
                external_contigs, cfg.dbg_kmer, cfg.seed, n_ord,
                backend=cfg.merge_backend,
            )

        with timer.stage("Evaluating each de novo assembled solution"):
            pmat, plens = pack_strings(solutions, s_multiple=64, l_multiple=128)
            uniq, counts = dedup_reads(np.asarray(rs.codes), np.asarray(rs.valid))
            rcodes, rcounts, rvalid = pad_reads(uniq, counts, cfg.read_chunk)
            # repeat-heavy ensembles can emit thousands of ~2x-genome-length
            # solutions; evaluating all of them in one device program runs
            # out of device memory (22.8 GB at S=8192 x L~103 kb: the
            # [S, P] octamer profile + its pooled KS sorts + the [S, 69904]
            # f32 count matrices + the [S, P, read_chunk] matcher compares;
            # the 2e9-cell budget is untuned for the H100, ROADMAP S3).
            # Chunk the solution axis under the same cell budget the batched
            # runner uses (batch_runner._group_cap); one compiled shape for
            # all full chunks, the tail padded with empty rows.
            S_pad, L_pad = pmat.shape
            P = L_pad - 8 + 1
            s_chunk = int(min(
                S_pad,
                max(64, (int(2.0e9) // max(P * cfg.read_chunk, 1)) // 64 * 64),
            ))
            probs_dev = jnp.asarray(self.table.combined, jnp.float32)
            probs8_dev = jnp.asarray(self.table.probs[8], jnp.float32)
            uni = jnp.asarray(self.uniform.combined, jnp.float32)
            rc_dev = jnp.asarray(rcodes)
            rn_dev = jnp.asarray(rcounts)
            rv_dev = jnp.asarray(rvalid)
            g_dev = jnp.asarray(genome_codes)
            outs: dict[str, list[np.ndarray]] = {
                k: [] for k in ("bp_score", "bp_nb", "bp_nl", "kmer_breaks",
                                "bp_rand", "bp_rand_nb", "bp_rand_nl",
                                "ks", "lev")
            }
            for lo in range(0, S_pad, s_chunk):
                pm_c = pmat[lo : lo + s_chunk]
                pl_c = plens[lo : lo + s_chunk]
                if pm_c.shape[0] < s_chunk:  # keep one compiled shape
                    pad = s_chunk - pm_c.shape[0]
                    pm_c = np.concatenate(
                        [pm_c, np.zeros((pad, L_pad), pm_c.dtype)])
                    pl_c = np.concatenate([pl_c, np.zeros(pad, pl_c.dtype)])
                pm_d = jnp.asarray(pm_c)
                pl_d = jnp.asarray(pl_c)
                bs = breakscore(
                    pm_d, pl_d, rc_dev, rn_dev, rv_dev, probs_dev,
                    break_kmer=cfg.kmer, read_chunk=cfg.read_chunk,
                )
                total = jnp.maximum(bs.kmer_breaks.astype(jnp.float32), 1.0)
                bp_rand = dot_f32(bs.site_counts, uni)
                bp_rand_nb = jnp.where(
                    bs.kmer_breaks > 0,
                    dot_f32(bs.site_counts / total[:, None], uni), 0.0)
                bp_rand_nl = bp_rand / jnp.maximum(pl_d.astype(jnp.float32), 1.0)

                # per-position octamer probability profile of each solution
                win8, win8_valid = kmer_window_codes(pm_d, 8)
                prof_valid = win8_valid & (
                    jnp.arange(win8.shape[1])[None, :] + 8 <= pl_d[:, None]
                )
                prof = probs8_dev[jnp.minimum(win8, 65535)]
                ks_c = batched_ks_2samp_masked(prof, prof_valid, rs.track)
                lev_c = batched_levenshtein_auto(pm_d, pl_d, g_dev, mode="HW")
                outs["bp_score"].append(np.asarray(bs.bp_score))
                outs["bp_nb"].append(
                    np.asarray(bs.bp_score_norm_by_break_freqs))
                outs["bp_nl"].append(np.asarray(bs.bp_score_norm_by_len))
                outs["kmer_breaks"].append(np.asarray(bs.kmer_breaks))
                outs["bp_rand"].append(np.asarray(bp_rand))
                outs["bp_rand_nb"].append(np.asarray(bp_rand_nb))
                outs["bp_rand_nl"].append(np.asarray(bp_rand_nl))
                outs["ks"].append(np.asarray(ks_c))
                outs["lev"].append(np.asarray(lev_c))
            cat = {k: np.concatenate(v)[:S_pad] for k, v in outs.items()}

            startpos = np.array([segment.find(s) for s in solutions], np.int64)
            keep = startpos != -1  # lib/DeNovoAssembler.R:360-362
            frac = covered_fraction(startpos[keep],
                                    np.asarray(plens)[: len(solutions)][keep],
                                    cfg.seq_len)

            n_real = len(solutions)
            order = np.argsort(-cat["bp_score"][:n_real], kind="stable")
            order = order[keep[order]]
            ksv = cat["ks"]
            cols = {
                "sequence": [solutions[i] for i in order],
                "sequence_len": np.asarray(plens)[order],
                "bp_score_true": cat["bp_score"][order],
                "bp_score_norm_by_break_freqs_true": cat["bp_nb"][order],
                "bp_score_norm_by_len_true": cat["bp_nl"][order],
                "kmer_breaks": cat["kmer_breaks"][order],
                "lev_dist_vs_true": cat["lev"][order],
                "stat_test_KS_true": ksv[order],
                "path_prob_dist_startpos": startpos[order],
                "contig_frac_len": np.full(len(order), frac),
                "bp_score_random": cat["bp_rand"][order],
                "bp_score_norm_by_break_freqs_random": cat["bp_rand_nb"][order],
                "bp_score_norm_by_len_random": cat["bp_rand_nl"][order],
                "stat_test_KS_random": ksv[order],
            }
        return ExperimentResult(columns=cols, stats=stats, timings=timer.times)

    # -- velvet subprocess adapter (lib/DeNovoAssembler.R:182-222) ----------

    @staticmethod
    def velvet_available() -> bool:
        return shutil.which("velveth") is not None and shutil.which("velvetg") is not None

    def run_velvet(self, read1_fasta: str, read2_fasta: str, out_dir: str) -> list[str]:
        """velveth/velvetg with the reference's flags; returns contigs."""
        cfg = self.config
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run(
            ["velveth", out_dir, str(cfg.dbg_kmer), "-shortPaired", "-fasta",
             "-separate", read1_fasta, read2_fasta],
            check=True, capture_output=True,
        )
        subprocess.run(
            ["velvetg", out_dir, "-exp_cov", "auto", "-cov_cutoff", "auto",
             "-scaffolding", "yes"],
            check=True, capture_output=True,
        )
        contigs = read_fasta(os.path.join(out_dir, "contigs.fa"))
        return list(contigs.values())
