"""End-to-end pipeline tests: full experiment vs full spec pipeline."""

import numpy as np
import pytest
import jax

from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.pipeline.assembler import Assembler, RESULT_COLUMNS
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.pipeline import results as res_io
from genomeassembler_dev.sim.segments import synthetic_genome
from genomeassembler_dev.spec import reference_semantics as spec


@pytest.fixture(scope="module")
def table():
    return load_default_query_table()


SMALL = ExperimentConfig(
    seq_len=300, read_len=12, coverage_target=15.0, kmer=8, dbg_kmer=9,
    seed=1234, n_orderings=300,
)


class TestEndToEnd:
    @pytest.fixture(scope="class")
    def run(self, table):
        asm = Assembler(SMALL, table)
        segment = synthetic_genome(42, SMALL.seq_len)
        res = asm.run_experiment(segment)
        return asm, segment, res

    def test_columns_complete(self, run):
        _, _, res = run
        assert list(res.columns) == RESULT_COLUMNS
        assert res.n_solutions > 0

    def test_matches_full_spec_pipeline(self, run, table):
        """The whole device pipeline must agree with the string-level spec:
        same solution set, same scores, same KS/levenshtein."""
        asm, segment, res = run
        cfg = SMALL
        # rebuild the read set exactly as the assembler did
        from genomeassembler_dev.core.encoding import encode_dna, decode_dna
        from genomeassembler_dev.sim.reads import generate_reads

        rs = generate_reads(
            jax.random.key(cfg.seed), encode_dna(segment), table,
            cfg.read_len, cfg.coverage_target, cfg.kmer,
        )
        reads = [
            decode_dna(row) for row, ok in
            zip(np.asarray(rs.codes), np.asarray(rs.valid)) if ok
        ]
        kmers = [r[i : i + cfg.dbg_kmer] for r in reads
                 for i in range(cfg.read_len - cfg.dbg_kmer + 1)]
        contigs = spec.get_contig_set(kmers, cfg.dbg_kmer)
        sols = spec.assemble_solutions(
            spec.shuffled_orderings(contigs, cfg.seed, cfg.n_orderings), cfg.dbg_kmer
        )
        assert sorted(res.columns["sequence"]) == sorted(sols)

        sp = spec.calc_breakscore(sols, reads, segment, cfg.kmer, table)
        by_seq = {s: i for i, s in enumerate(sols)}
        for row, seq in enumerate(res.columns["sequence"])  :
            i = by_seq[seq]
            assert res.columns["kmer_breaks"][row] == sp["kmer_breaks"][i]
            np.testing.assert_allclose(
                res.columns["bp_score_true"][row], sp["bp_score"][i], rtol=2e-5
            )
            assert res.columns["lev_dist_vs_true"][row] == sp["lev_dist_vs_true"][i]
            # KS vs spec on the same track values
            track = np.asarray(rs.track)
            track_nz = track[track > 0]
            if sp["kmer_breaks"][i] > 0:
                expect_ks = spec.ks_2samp(sp["path_freq"][i].astype(np.float32), track_nz)
                got = res.columns["stat_test_KS_true"][row]
                assert abs(got - expect_ks) < 1e-4, (seq[:20], got, expect_ks)

    def test_row_order_is_bp_score_desc(self, run):
        _, _, res = run
        bp = res.columns["bp_score_true"]
        assert (np.diff(bp) <= 1e-9).all()

    def test_ks_columns_identical(self, run):
        # observed break frequencies don't involve the table, so the KS
        # statistic is the same for the true and random passes
        _, _, res = run
        np.testing.assert_array_equal(
            res.columns["stat_test_KS_true"], res.columns["stat_test_KS_random"]
        )

    def test_save_load_roundtrip(self, run, tmp_path_factory):
        _, _, res = run
        wd = str(tmp_path_factory.mktemp("wd"))
        path = res_io.save_result(wd, 1, SMALL, res)
        assert res_io.experiment_done(wd, 1, SMALL)
        cols = res_io.load_result_columns(path)
        assert cols["sequence"] == res.columns["sequence"]
        np.testing.assert_allclose(cols["bp_score_true"], res.columns["bp_score_true"], rtol=1e-12)
        # param string appears in the filename
        assert "SeqLen-300" in path and "IndustryModel-False" in path

    def test_stats(self, run):
        _, segment, res = run
        assert res.stats["nr_of_reads"] > 0
        assert abs(sum(res.stats["base_composition"]) - 1.0) < 1e-9
        assert res.stats["genome_seq"] == segment


class TestLargeGridRow:
    def test_read40_dbg15_matches_spec(self, table):
        """The study grid's largest row: read_len=40 (3 packed words per
        window), dbg_kmer=15 (sparse graph path)."""
        cfg = ExperimentConfig(seq_len=400, read_len=40, coverage_target=15.0,
                               kmer=8, dbg_kmer=15, seed=1234, n_orderings=100)
        asm = Assembler(cfg, table)
        segment = synthetic_genome(77, cfg.seq_len)
        res = asm.run_experiment(segment)
        assert res.n_solutions > 0

        from genomeassembler_dev.core.encoding import encode_dna, decode_dna
        from genomeassembler_dev.sim.reads import generate_reads

        rs = generate_reads(jax.random.key(cfg.seed), encode_dna(segment), table,
                            cfg.read_len, cfg.coverage_target, cfg.kmer)
        reads = [decode_dna(r) for r, ok in
                 zip(np.asarray(rs.codes), np.asarray(rs.valid)) if ok]
        kmers = [r[i : i + cfg.dbg_kmer] for r in reads
                 for i in range(cfg.read_len - cfg.dbg_kmer + 1)]
        contigs = spec.get_contig_set(kmers, cfg.dbg_kmer)
        sols = spec.assemble_solutions(
            spec.shuffled_orderings(contigs, cfg.seed, cfg.n_orderings),
            cfg.dbg_kmer,
        )
        assert sorted(res.columns["sequence"]) == sorted(sols)
        sp = spec.calc_breakscore(sols, reads, segment, cfg.kmer, table)
        by_seq = {s: i for i, s in enumerate(sols)}
        for row, seq in enumerate(res.columns["sequence"]):
            i = by_seq[seq]
            assert res.columns["kmer_breaks"][row] == sp["kmer_breaks"][i]
            np.testing.assert_allclose(res.columns["bp_score_true"][row],
                                       sp["bp_score"][i], rtol=2e-5)
            assert res.columns["lev_dist_vs_true"][row] == sp["lev_dist_vs_true"][i]


class TestCountOnly:
    def test_count_path(self, table):
        cfg = SMALL.with_(only_kmers_from_reads=True, kmer=4)
        asm = Assembler(cfg, table)
        res = asm.run_experiment(synthetic_genome(1, 300))
        assert res.columns["count"].shape == (256,)
        assert res.columns["count"].sum() > 0
        assert res.columns["prob"].shape == (256,)


class TestReadSetReplay:
    def test_replay_reproduces_run(self, table, tmp_path):
        """SURVEY §7.1 equality gate: a stored read set replayed through the
        pipeline reproduces the original run bit-for-bit."""
        from genomeassembler_dev.core.encoding import encode_dna
        from genomeassembler_dev.sim.reads import generate_reads
        from genomeassembler_dev.sim.reads_io import (
            load_read_set_npz, save_read_set_npz,
        )

        asm = Assembler(SMALL, table)
        segment = synthetic_genome(33, SMALL.seq_len)
        rs = generate_reads(jax.random.key(SMALL.seed), encode_dna(segment),
                            table, SMALL.read_len, SMALL.coverage_target)
        p = str(tmp_path / "rs.npz")
        save_read_set_npz(p, np.asarray(rs.codes), np.asarray(rs.valid),
                          np.asarray(rs.positions))

        original = asm.run_experiment(segment)
        replayed = asm.run_experiment(segment, read_set=load_read_set_npz(p))
        assert replayed.columns["sequence"] == original.columns["sequence"]
        np.testing.assert_array_equal(replayed.columns["bp_score_true"],
                                      original.columns["bp_score_true"])
        np.testing.assert_array_equal(replayed.columns["lev_dist_vs_true"],
                                      original.columns["lev_dist_vs_true"])
