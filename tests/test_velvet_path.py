"""Industry-standard (velvet) path semantics."""

import numpy as np
import pytest
import jax.numpy as jnp

from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.ops.ks import batched_ks_2samp_masked
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.pipeline.velvet import (
    VELVET_RESULT_COLUMNS,
    IndustryAssembler,
    covered_fraction,
)
from genomeassembler_dev.sim.segments import synthetic_genome
from genomeassembler_dev.spec import reference_semantics as spec


@pytest.fixture(scope="module")
def table():
    return load_default_query_table()


class TestCoveredFraction:
    def test_full_cover(self):
        assert covered_fraction(np.array([0]), np.array([1000]), 1000) == 100.0

    def test_partial(self):
        # [1, 500] covered of 1000
        f = covered_fraction(np.array([1]), np.array([499]), 1000)
        assert abs(f - 50.0) < 0.1

    def test_union_of_overlaps(self):
        f1 = covered_fraction(np.array([0, 200]), np.array([300, 300]), 1000)
        f2 = covered_fraction(np.array([0]), np.array([500]), 1000)
        assert abs(f1 - f2) < 0.2

    def test_empty(self):
        assert covered_fraction(np.array([]), np.array([]), 1000) == 0.0


class TestMaskedKS:
    def test_matches_unmasked_on_full_rows(self):
        rng = np.random.default_rng(0)
        x = rng.random((3, 50)).astype(np.float32)
        y = rng.random(30).astype(np.float32)
        full = batched_ks_2samp_masked(
            jnp.asarray(x), jnp.ones((3, 50), bool), jnp.asarray(y)
        )
        for i in range(3):
            expect = spec.ks_2samp(x[i], y)
            assert abs(float(full[i]) - expect) < 1e-6

    def test_masked_vs_trimmed(self):
        rng = np.random.default_rng(1)
        x = rng.random((1, 50)).astype(np.float32)
        valid = np.zeros((1, 50), bool)
        valid[0, :20] = True
        y = rng.random(30).astype(np.float32)
        got = float(batched_ks_2samp_masked(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(y))[0])
        expect = spec.ks_2samp(x[0, :20], y)
        assert abs(got - expect) < 1e-6

    def test_empty_row_nan(self):
        out = batched_ks_2samp_masked(
            jnp.zeros((1, 5)), jnp.zeros((1, 5), bool), jnp.arange(3.0)
        )
        assert np.isnan(float(out[0]))


class TestIndustryPath:
    def test_external_contigs_scored(self, table):
        cfg = ExperimentConfig(
            seq_len=300, read_len=12, coverage_target=12.0, kmer=8,
            dbg_kmer=9, seed=1234, industry_standard=True,
            velvet_n_orderings=200,
        )
        g = synthetic_genome(10, 300)
        # external "assembler output": true pieces + one junk contig
        contigs = [g[0:120], g[110:230], g[220:300], "ACGT" * 10]
        asm = IndustryAssembler(cfg, table)
        res = asm.run_external(g, contigs)
        assert list(res.columns) == VELVET_RESULT_COLUMNS
        # junk contig is filtered by startpos != -1 unless it merged into
        # a real one; every kept solution must occur in the true sequence
        for s, sp in zip(res.columns["sequence"], res.columns["path_prob_dist_startpos"]):
            assert g.find(s) == sp and sp != -1
        # HW distance of substrings of the truth is 0
        assert (res.columns["lev_dist_vs_true"] == 0).all()
        # coverage equals the union of the kept solutions' intervals
        expect_frac = covered_fraction(
            res.columns["path_prob_dist_startpos"],
            res.columns["sequence_len"], cfg.seq_len,
        )
        assert len(res.columns["contig_frac_len"]) > 0
        assert abs(res.columns["contig_frac_len"][0] - expect_frac) < 1e-9
        # bp_score ordering
        bp = res.columns["bp_score_true"]
        assert (np.diff(bp) <= 1e-9).all()

    def test_result_csv_roundtrip_keeps_velvet_columns(self, tmp_path, table):
        """save_result must persist the velvet path's own column set —
        including path_prob_dist_startpos (lib/BreakageScorer.cpp:343-353),
        which a RESULT_COLUMNS filter silently dropped."""
        from genomeassembler_dev.pipeline.results import (
            load_result_columns, save_result, solutions_path)

        cfg = ExperimentConfig(
            seq_len=300, read_len=12, coverage_target=12.0, kmer=8,
            dbg_kmer=9, seed=1234, industry_standard=True,
            velvet_n_orderings=200,
        )
        g = synthetic_genome(10, 300)
        contigs = [g[0:120], g[110:230], g[220:300]]
        asm = IndustryAssembler(cfg, table)
        res = asm.run_external(g, contigs)
        save_result(str(tmp_path), 0, cfg, res)
        back = load_result_columns(solutions_path(str(tmp_path), 0, cfg))
        assert list(back) == VELVET_RESULT_COLUMNS
        np.testing.assert_array_equal(
            np.asarray(back["path_prob_dist_startpos"], np.int64),
            np.asarray(res.columns["path_prob_dist_startpos"], np.int64),
        )

    def test_velvet_grid_k37_supported(self, table):
        """The reference's velvet grid runs dbg_kmer=37 (scripts/00_…:27-30).
        The velvet path never builds our dBG — k only sets the string merge
        overlap — so 37 must validate and merge there, while the own path
        keeps the 62-bit code limit."""
        cfg = ExperimentConfig(
            seq_len=400, read_len=40, coverage_target=10.0, kmer=8,
            dbg_kmer=37, seed=1234, industry_standard=True,
            velvet_n_orderings=100,
        ).validate()
        g = synthetic_genome(11, 400)
        contigs = [g[0:200], g[164:400]]  # 36-base (k-1) exact overlap
        asm = IndustryAssembler(cfg, table)
        res = asm.run_external(g, contigs)
        assert max(res.columns["sequence_len"]) == 400  # merged to the truth
        assert (res.columns["lev_dist_vs_true"] == 0).all()
        with pytest.raises(ValueError, match="62-bit"):
            ExperimentConfig(seq_len=400, read_len=40, dbg_kmer=37).validate()

    def test_velvet_ordering_config(self, table):
        # default: 20,000 orderings (BreakageScorer.cpp:86); explicit values
        # pass through — including an explicit 10,000, which the old
        # `n_orderings != 10000` sentinel could not express
        cfg = ExperimentConfig(industry_standard=True)
        assert (cfg.velvet_n_orderings or 20000) == 20000
        cfg = cfg.with_(velvet_n_orderings=10000)
        assert (cfg.velvet_n_orderings or 20000) == 10000


class TestVelvetSubprocess:
    def test_fake_binaries_exercise_adapter(self, tmp_path, table, monkeypatch):
        """Stub velveth/velvetg executables drive the real subprocess path:
        flag construction (lib/DeNovoAssembler.R:182-222) and contigs.fa
        parsing, without velvet itself."""
        import os
        import stat
        import textwrap

        bin_dir = tmp_path / "bin"
        bin_dir.mkdir()
        # velveth: record its argv for flag assertions
        velveth = bin_dir / "velveth"
        velveth.write_text(textwrap.dedent("""\
            #!/bin/sh
            echo "$@" > "$1/velveth_args.txt"
        """))
        # velvetg: record argv and emit a canned contigs.fa (multi-line
        # wrapped records, like real velvet output)
        velvetg = bin_dir / "velvetg"
        velvetg.write_text(textwrap.dedent("""\
            #!/bin/sh
            echo "$@" > "$1/velvetg_args.txt"
            cat > "$1/contigs.fa" <<'EOF'
            >NODE_1_length_24_cov_3.0
            ACGTACGTACGT
            ACGTACGTACGT
            >NODE_2_length_8_cov_2.0
            GGGGCCCC
            EOF
        """))
        for p in (velveth, velvetg):
            p.chmod(p.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")

        cfg = ExperimentConfig(seq_len=200, read_len=16, dbg_kmer=13,
                               industry_standard=True)
        asm = IndustryAssembler(cfg, table)
        assert IndustryAssembler.velvet_available()
        r1, r2 = str(tmp_path / "read_1.fa"), str(tmp_path / "read_2.fa")
        out_dir = str(tmp_path / "velvet_out")
        contigs = asm.run_velvet(r1, r2, out_dir)

        assert contigs == ["ACGTACGTACGTACGTACGTACGT", "GGGGCCCC"]
        h_args = (tmp_path / "velvet_out" / "velveth_args.txt").read_text().split()
        assert h_args == [out_dir, "13", "-shortPaired", "-fasta",
                          "-separate", r1, r2]
        g_args = (tmp_path / "velvet_out" / "velvetg_args.txt").read_text().split()
        assert g_args == [out_dir, "-exp_cov", "auto", "-cov_cutoff", "auto",
                          "-scaffolding", "yes"]


class TestReadsIO:
    def test_fasta_contract(self, tmp_path, table):
        import jax

        from genomeassembler_dev.core.encoding import encode_dna
        from genomeassembler_dev.sim.reads import generate_reads
        from genomeassembler_dev.sim.reads_io import (
            load_read_set_npz, save_read_fastas, save_read_set_npz,
        )
        from genomeassembler_dev.sim.segments import read_fasta

        cfg = ExperimentConfig(seq_len=200, read_len=12, coverage_target=5.0, seed=7)
        g = synthetic_genome(2, 200)
        rs = generate_reads(jax.random.key(7), encode_dna(g), table, 12, 5.0)
        codes, valid, pos = np.asarray(rs.codes), np.asarray(rs.valid), np.asarray(rs.positions)
        p1, p2, pr = save_read_fastas(str(tmp_path), 1, cfg, codes, valid, pos, g, "chr1_500")
        r1 = read_fasta(p1)
        r2 = read_fasta(p2)
        ref = read_fasta(pr)
        assert len(r1) == valid.sum() == len(r2)
        assert ref["seq-1"] == g
        # read_2 is the reverse complement of read_1
        k1 = sorted(r1)[0]
        k2 = k1[:-1] + "2"
        from genomeassembler_dev.core.encoding import encode_dna as enc, decode_dna, reverse_complement

        assert r2[k2] == decode_dna(reverse_complement(enc(r1[k1])))
        # names carry absolute 1-based coordinates
        assert k1.startswith("chr1_")

        npz = str(tmp_path / "rs.npz")
        save_read_set_npz(npz, codes, valid, pos)
        c2, v2, p2_ = load_read_set_npz(npz)
        np.testing.assert_array_equal(c2, codes)


class TestProbabilityProfile:
    def test_profile_matches_string_computation(self, table):
        """The device-gathered per-position octamer probability profile
        (BreakageScorer.cpp:199-215 semantics) matches a direct string-level
        computation."""
        import jax.numpy as jnp

        from genomeassembler_dev.core.encoding import encode_dna, kmer_code
        from genomeassembler_dev.ops.windows import kmer_window_codes
        from genomeassembler_dev.pipeline.assembler import pack_strings

        rng = np.random.default_rng(3)
        sols = ["".join(rng.choice(list("ACGT"), size=n)) for n in (20, 35, 50)]
        pmat, plens = pack_strings(sols)
        win8, win8_valid = kmer_window_codes(jnp.asarray(pmat), 8)
        prof = np.asarray(
            jnp.asarray(table.probs[8], jnp.float32)[jnp.minimum(win8, 65535)]
        )
        for i, s in enumerate(sols):
            for pos in range(len(s) - 7):
                expect = table.probs[8][kmer_code(s[pos : pos + 8])]
                assert abs(prof[i, pos] - expect) < 1e-9
