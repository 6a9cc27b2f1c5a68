"""Breakage-biased dBG traversal."""

import numpy as np
import pytest
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import encode_dna, kmer_code
from genomeassembler_dev.dbg.assemble import dedup_contigs
from genomeassembler_dev.dbg.biased import biased_contigs_dense, biased_successor
from genomeassembler_dev.dbg.dense import build_dbg_dense
from genomeassembler_dev.ops.windows import kmer_window_codes


def contigs_of(buf, lens, wvalid, ovf):
    return dedup_contigs(np.asarray(buf), np.asarray(lens), np.asarray(wvalid),
                         np.asarray(ovf) & False)  # ignore overflow for dedup


def sliding(s, k):
    return [s[i : i + k] for i in range(len(s) - k + 1)]


class TestBiasedTraversal:
    def test_picks_high_probability_branch(self):
        k = 9
        # two continuations after a shared 8-mer context: base A vs base T
        stem = "ACGTACGG"  # 8 chars, the shared (k-1)-mer context
        a_path = stem + "ATTGCCAA"
        t_path = stem + "TGGCAACC"
        reads = sliding(a_path, 12) + sliding(t_path, 12)
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        kc, kv = kmer_window_codes(codes, k)

        probs = np.full(65536, 1e-6, np.float32)
        winner = kmer_code(stem[1:] + "T")  # octamer ending in the T branch
        probs[winner] = 1.0

        buf, lens, wv, ovf, nw = biased_contigs_dense(
            kc, kv, jnp.asarray(probs), k, 64, 32
        )
        got = contigs_of(buf, lens, wv, ovf)
        # some greedy assembly must follow the T branch through the junction
        assert any(stem + "T" in c for c in got), got
        # and with the bias flipped, the A branch wins
        probs2 = np.full(65536, 1e-6, np.float32)
        probs2[kmer_code(stem[1:] + "A")] = 1.0
        buf2, lens2, wv2, ovf2, _ = biased_contigs_dense(
            kc, kv, jnp.asarray(probs2), k, 64, 32
        )
        got2 = contigs_of(buf2, lens2, wv2, ovf2)
        assert any(stem + "A" in c for c in got2), got2

    def test_successor_structure(self):
        k = 9
        g_str = "ACGTACGTTGCATGCAGGATCCTTAA"
        reads = sliding(g_str, 12)
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        kc, kv = kmer_window_codes(codes, k)
        g = build_dbg_dense(kc, kv, k)
        probs = jnp.ones(65536, jnp.float32)
        sb = np.asarray(biased_successor(g, probs))
        out_deg = np.asarray(g.out_deg)
        # dead ends have no successor; nodes with out-edges always do
        assert (sb[out_deg == 0] == -1).all()
        assert (sb[out_deg > 0] >= 0).all()

    def test_dbg9_requirement(self):
        codes = jnp.zeros((2, 12), jnp.uint8)
        kc, kv = kmer_window_codes(codes, 5)
        with pytest.raises(ValueError):
            biased_contigs_dense(kc, kv, jnp.ones(65536), 5, 32, 8)

    def test_cap_overflow_flag(self):
        # a cycle: repeats of a 12-mer make the graph cyclic through branches
        k = 9
        # tail flowing into a periodic cycle: the junction is a branch node
        # (in=2) so walks start there, and every cycle node has a successor,
        # so biased walks loop forever and must hit the cap
        s = "T" * 10 + "ACGTTGCATGCA" * 5
        reads = sliding(s, 12)
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        kc, kv = kmer_window_codes(codes, k)
        probs = jnp.ones(65536, jnp.float32)
        buf, lens, wv, ovf, nw = biased_contigs_dense(kc, kv, probs, k, 40, 32)
        # walks hit the cap (overflow) instead of hanging
        assert bool((np.asarray(ovf) & np.asarray(wv)).any())


def greedy_oracle(reads, k, probs, max_len):
    """String-level reference of the biased traversal: walks start from every
    (branch node, out-edge) pair and continue through branches along the
    highest-probability junction octamer (ties -> smallest base)."""
    from collections import defaultdict

    kmers = sorted({r[i : i + k] for r in reads for i in range(len(r) - k + 1)})
    out_edges = defaultdict(set)
    in_deg = defaultdict(int)
    nodes = set()
    for km in kmers:
        p, s = km[:-1], km[1:]
        out_edges[p].add(km[-1])
        in_deg[s] += 1
        nodes.update((p, s))

    def branch(n):
        od = len(out_edges.get(n, ()))
        return od > 0 and (in_deg.get(n, 0) != 1 or od != 1)

    def greedy_next(n):
        cands = out_edges.get(n, ())
        if not cands:
            return None
        return min(cands, key=lambda c: (-probs[kmer_code(n[-7:] + c)], c))

    contigs = set()
    for n in sorted(nodes):
        if not branch(n):
            continue
        for c in sorted(out_edges[n]):
            s = n + c
            while len(s) < max_len:
                c2 = greedy_next(s[-(k - 1):])
                if c2 is None:
                    break
                s += c2
            contigs.add(s)
    return sorted(contigs)


class TestBiasedSparseAndBigK:
    def _reads(self, seed, k):
        from genomeassembler_dev.sim.segments import plant_repeats, synthetic_genome

        rng = np.random.default_rng(seed)
        g = plant_repeats(synthetic_genome(seed, 400), rng,
                          n_events=3, motif_len=(k + 4, k + 20))
        return [g[i : i + k + 6] for i in range(0, 400 - (k + 6), 2)]

    def _probs(self, seed):
        rng = np.random.default_rng(seed + 99)
        return rng.random(65536).astype(np.float32) + 1e-3

    @pytest.mark.parametrize("seed,k", [(0, 9), (1, 10)])
    def test_sparse_matches_dense(self, seed, k):
        from genomeassembler_dev.dbg.biased import biased_contigs_sparse

        reads = self._reads(seed, k)
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        kc, kv = kmer_window_codes(codes, k)
        probs = jnp.asarray(self._probs(seed))
        a = biased_contigs_dense(kc, kv, probs, k, 500, 256)
        b = biased_contigs_sparse(kc, kv, probs, k, 500, 256, node_cap=512)
        got_a = contigs_of(*a[:4])
        got_b = contigs_of(*b[:4])
        assert got_a == got_b
        assert got_a == greedy_oracle(reads, k, np.asarray(probs), 500)

    @pytest.mark.parametrize("seed,k", [(2, 13), (3, 15)])
    def test_sparse_matches_oracle(self, seed, k):
        from genomeassembler_dev.dbg.biased import biased_contigs_sparse

        reads = self._reads(seed, k)
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        kc, kv = kmer_window_codes(codes, k)
        probs = jnp.asarray(self._probs(seed))
        out = biased_contigs_sparse(kc, kv, probs, k, 500, 256, node_cap=1024)
        assert contigs_of(*out[:4]) == greedy_oracle(
            reads, k, np.asarray(probs), 500)

    @pytest.mark.parametrize("seed,k", [(4, 17), (5, 21)])
    def test_big_k_matches_oracle(self, seed, k):
        from genomeassembler_dev.dbg.big_k import kmer_pair_codes
        from genomeassembler_dev.dbg.biased import biased_contigs_big_k

        reads = self._reads(seed, k)
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        hi, lo, kv = kmer_pair_codes(codes, k)
        probs = jnp.asarray(self._probs(seed))
        out = biased_contigs_big_k(hi, lo, kv, probs, k, 500, 256,
                                   node_cap=1024)
        assert contigs_of(*out[:4]) == greedy_oracle(
            reads, k, np.asarray(probs), 500)


class TestBiasedPipeline:
    def test_full_experiment_with_biased_traversal(self):
        from genomeassembler_dev.core.querytable import load_default_query_table
        from genomeassembler_dev.pipeline.assembler import Assembler
        from genomeassembler_dev.pipeline.config import ExperimentConfig
        from genomeassembler_dev.sim.segments import synthetic_genome

        cfg = ExperimentConfig(seq_len=300, read_len=12, coverage_target=15.0,
                               kmer=8, dbg_kmer=9, seed=1234, n_orderings=100,
                               traversal="biased")
        asm = Assembler(cfg, load_default_query_table())
        res = asm.run_experiment(synthetic_genome(21, 300))
        assert res.n_solutions > 0
        assert (res.columns["sequence_len"] >= 9).all()

    def test_biased_solutions_are_capped_maximal_assemblies(self):
        """Biased walks are maximal candidate assemblies: the solution set is
        the deduped, canonically-sorted walks truncated to the longest
        biased_max_solutions — the ordering-ensemble merge (a fragment
        joiner) is skipped (at 50 kb it OOM'd combinatorially)."""
        from genomeassembler_dev.core.querytable import load_default_query_table
        from genomeassembler_dev.pipeline.assembler import Assembler
        from genomeassembler_dev.pipeline.config import ExperimentConfig
        from genomeassembler_dev.sim.segments import (
            plant_repeats, synthetic_genome)
        from genomeassembler_dev.utils.timers import StageTimer

        cfg = ExperimentConfig(seq_len=400, read_len=12, coverage_target=20.0,
                               kmer=8, dbg_kmer=9, seed=1234,
                               traversal="biased", biased_max_solutions=5)
        asm = Assembler(cfg, load_default_query_table())
        g = plant_repeats(synthetic_genome(33, 400), np.random.default_rng(33),
                          n_events=4)
        import jax

        from genomeassembler_dev.core.encoding import encode_dna
        from genomeassembler_dev.sim.reads import generate_reads

        rs = generate_reads(jax.random.key(cfg.seed), encode_dna(g), asm.table,
                            cfg.read_len, cfg.coverage_target)
        timer = StageTimer(False)
        contigs = asm.contigs(rs.codes, rs.valid, timer)
        sols = asm.merge(contigs, timer)
        assert len(sols) <= 5
        want = sorted(set(contigs), key=lambda s: (-len(s), s))[:5]
        assert sols == want
