"""Study runners and CLI."""

import json
import os

import numpy as np
import pytest

from genomeassembler_dev import cli
from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.pipeline.experiments import (
    run_gc_study,
    run_kmer_count_study,
    run_own_study,
)
from genomeassembler_dev.sim.segments import synthetic_segment_store


@pytest.fixture(scope="module")
def table():
    return load_default_query_table()


BASE = ExperimentConfig(seq_len=250, coverage_target=12.0, kmer=8, seed=1234,
                        n_orderings=100)


class TestOwnStudy:
    def test_study_and_resume(self, tmp_path, table):
        wd = str(tmp_path)
        segs = synthetic_segment_store(3, 250, 2)
        grid = ((12, 9),)
        rep = run_own_study(wd, segs, base=BASE, grid=grid, total_iters=2, table=table)
        assert rep.n_experiments == 2 and rep.n_skipped == 0
        assert os.path.exists(rep.summary_path)
        assert os.path.exists(rep.all_path)
        # resume: nothing re-runs
        rep2 = run_own_study(wd, segs, base=BASE, grid=grid, total_iters=2, table=table)
        assert rep2.n_experiments == 0 and rep2.n_skipped == 2
        # summary has true and random rows
        import csv

        with open(rep.summary_path) as f:
            rows = list(csv.DictReader(f))
        assert {r["random_prob"] for r in rows} == {"True", "False"}
        assert len(rows) == 4  # 2 experiments x (true, random)
        # results_all carries the reference's column selection
        # (scripts/02_…:174-210) incl. both normalised scores
        with open(rep.all_path) as f:
            arows = list(csv.DictReader(f))
        assert arows, "results_all is empty"
        for c in ("sequence_len", "kmer_breaks",
                  "bp_score_norm_by_break_freqs_true",
                  "bp_score_norm_by_len_true", "bp_score_true",
                  "lev_dist_vs_true", "stat_test_KS_true"):
            assert c in arows[0], c
        # statistics include the top-5%-vs-rest contrast family
        from genomeassembler_dev.pipeline.experiments import study_statistics

        stats = study_statistics(rep.all_path)
        entry = stats["12:9"]
        assert "top_fraction" in entry
        assert "bp_score_norm_by_len_true" in entry["top_fraction"]

    def test_gc_study(self, tmp_path, table):
        wd = str(tmp_path)
        segs = synthetic_segment_store(3, 250, 2)
        cfg = BASE.with_(read_len=12, dbg_kmer=9)
        run_own_study(wd, segs, base=BASE, grid=((12, 9),), total_iters=2, table=table)
        out = run_gc_study(wd, segs, cfg, 2)
        import csv

        with open(out) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 2
        assert 0.2 < float(rows[0]["gc_fraction"]) < 0.8


class TestKmerCountStudy:
    def test_r2(self, tmp_path, table):
        segs = synthetic_segment_store(5, 250, 1)
        r2 = run_kmer_count_study(
            str(tmp_path), segs.seqs[0],
            base=BASE.with_(read_len=20), ks=(2, 4), table=table,
        )
        assert set(r2) == {2, 4}
        for v in r2.values():
            assert -1.0 <= v <= 1.0
        assert os.path.exists(os.path.join(str(tmp_path), "kmer_count_vs_prob.csv"))


class TestCLI:
    def test_run_command(self, tmp_path, capsys):
        cli.main([
            "run", "--workdir", str(tmp_path), "--synthetic",
            "--seq-len", "250", "--read-len", "12", "--coverage", "12",
            "--n-orderings", "100", "--total-iters", "2", "--ind", "1",
        ])
        out = json.loads(capsys.readouterr().out)
        assert out["solutions"] > 0
        assert os.path.exists(out["csv"])

    def test_study_own_command(self, tmp_path, capsys):
        cli.main([
            "study-own", "--workdir", str(tmp_path), "--synthetic",
            "--seq-len", "250", "--coverage", "12", "--n-orderings", "50",
            "--total-iters", "1", "--grid", "12:9",
        ])
        out = json.loads(capsys.readouterr().out)
        assert out["ran"] == 1


class TestTopFractionContrast:
    def test_reference_slice_semantics(self):
        """Matches R's slice_max(prop=.05)/slice_min(prop=.95) split
        (scripts/02_…:221-231): floor-sized groups from opposite ends of the
        ranking, Welch t-test between them."""
        from genomeassembler_dev.pipeline.experiments import top_fraction_contrast

        rng = np.random.default_rng(0)
        v = np.concatenate([rng.normal(0.0, 1.0, 95), rng.normal(10.0, 1.0, 5)])
        lev = np.where(v > 5, 1.0, 20.0)  # top group has LOW lev distance
        out = top_fraction_contrast(v, 0.05, companions={"lev": lev})
        assert out["n_top"] == 5 and out["n_rest"] == 95
        assert out["top_mean"] > 5 > out["rest_mean"]
        assert out["t_p"] < 1e-3
        assert out["lev"]["top_mean"] == 1.0
        assert out["lev"]["rest_mean"] > 15.0

    def test_nan_and_tiny_groups(self):
        from genomeassembler_dev.pipeline.experiments import top_fraction_contrast

        v = np.array([1.0, np.nan, 2.0, 3.0])
        out = top_fraction_contrast(v, 0.05)
        assert out["n"] == 3 and np.isnan(out["t_p"])


class TestVelvetCLI:
    def test_with_contigs_dir(self, tmp_path, capsys):
        from genomeassembler_dev.sim.segments import (
            synthetic_segment_store, write_fasta,
        )

        segs = synthetic_segment_store(19, 250, 2)
        cdir = tmp_path / "contigs"
        for i, seq in enumerate(segs.seqs, start=1):
            write_fasta(str(cdir / f"contigs_exp_{i}.fa"),
                        {"c1": seq[:140], "c2": seq[130:250]})
        # CLI uses its own synthetic store; pass the same seed/params
        cli.main([
            "study-velvet", "--workdir", str(tmp_path / "wd"),
            "--synthetic", "--seed", "19", "--seq-len", "250",
            "--coverage", "12", "--n-orderings", "100", "--total-iters", "2",
            "--grid", "12:9", "--contigs-dir", str(cdir),
        ])
        out = json.loads(capsys.readouterr().out)
        assert out["ran"] == 2
        # velvet aggregation parity: per-experiment KS summary rows
        # (scripts/00_…:55-120) and a real results_all (00_…:175-216)
        import csv

        with open(out["summary"]) as f:
            srows = list(csv.DictReader(f))
        ks = [r for r in srows if r["Key"] == "stat_test_KS"]
        assert len(ks) == 4  # 2 experiments x (true, random)
        with open(out["all"]) as f:
            arows = list(csv.DictReader(f))
        assert arows and "bp_score_norm_by_break_freqs_true" in arows[0]
        from genomeassembler_dev.pipeline.experiments import study_statistics

        stats = study_statistics(out["all"])
        assert "top_fraction" in stats["12:9"]


class TestConfigValidation:
    def test_invalid_kmer(self):
        import pytest as _pytest

        from genomeassembler_dev.pipeline.assembler import Assembler

        with _pytest.raises(ValueError, match="kmer"):
            Assembler(ExperimentConfig(kmer=5))

    def test_read_shorter_than_dbg(self):
        import pytest as _pytest

        with _pytest.raises(ValueError, match="read_len"):
            ExperimentConfig(read_len=8, dbg_kmer=9).validate()

    def test_dbg_limit(self):
        import pytest as _pytest

        with _pytest.raises(ValueError, match="dbg_kmer"):
            ExperimentConfig(read_len=40, dbg_kmer=32).validate()

    def test_valid_passes(self):
        cfg = ExperimentConfig(seq_len=300, read_len=12, dbg_kmer=9)
        assert cfg.validate() is cfg


class TestNewCLICommands:
    def test_fit_model(self, tmp_path, capsys):
        cli.main(["fit-model", "--platform", "cpu", "--steps", "30",
                  "--hidden", "32", "--out", str(tmp_path / "m.npz")])
        out = json.loads(capsys.readouterr().out)
        assert out["loss_last"] < out["loss_first"]
        assert os.path.exists(out["checkpoint"])

    @pytest.mark.slow
    def test_bench_scaling(self, capsys):
        cli.main(["bench-scaling", "--platform", "cpu", "--devices", "1,2",
                  "--segments-per-device", "2", "--seq-len", "200",
                  "--draws-per-segment", "32"])
        out = json.loads(capsys.readouterr().out)
        assert len(out) == 2 and out[0]["efficiency"] == 1.0
