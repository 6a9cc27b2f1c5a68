"""Auxiliary subsystems: statistics, plots, scaling harness, timers."""

import os

import numpy as np
import pytest

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.pipeline.experiments import (
    run_own_study,
    run_velvet_study,
    study_statistics,
)
from genomeassembler_dev.sim.segments import synthetic_genome, synthetic_segment_store
from genomeassembler_dev.utils.timers import StageTimer


@pytest.fixture(scope="module")
def table():
    return load_default_query_table()


BASE = ExperimentConfig(seq_len=250, coverage_target=12.0, kmer=8, seed=1234,
                        n_orderings=100)


def test_study_statistics(tmp_path, table):
    wd = str(tmp_path)
    segs = synthetic_segment_store(3, 250, 3)
    rep = run_own_study(wd, segs, base=BASE, grid=((12, 9),), total_iters=3, table=table)
    stats = study_statistics(rep.all_path)
    assert "12:9" in stats
    s = stats["12:9"]
    assert np.isfinite(s["spearman_rho"]) or s["n"] < 3
    assert s["n"] > 0


def test_velvet_study_with_own_contigs(tmp_path, table):
    """Velvet study shape driven by a contig_source callback (here: slices of
    the truth standing in for an external assembler's contigs.fa)."""
    wd = str(tmp_path)
    segs = synthetic_segment_store(4, 250, 2)

    def source(asm, segment, ind):
        return [segment[:120], segment[110:250]]

    rep = run_velvet_study(
        wd, segs, source, base=BASE.with_(seq_len=250), grid=((12, 9),),
        total_iters=2, table=table,
    )
    assert rep.n_experiments == 2
    assert os.path.exists(rep.summary_path)
    # resume works for the velvet path too
    rep2 = run_velvet_study(
        wd, segs, source, base=BASE.with_(seq_len=250), grid=((12, 9),),
        total_iters=2, table=table,
    )
    assert rep2.n_skipped == 2


def test_plots(tmp_path, table):
    pytest.importorskip("matplotlib")
    import jax

    from genomeassembler_dev.sim.reads import generate_reads
    from genomeassembler_dev.utils import plots

    g = synthetic_genome(1, 250)
    rs = generate_reads(jax.random.key(0), encode_dna(g), table, 12, 10.0)
    p1 = plots.plot_probability_track(np.asarray(rs.track), str(tmp_path / "track.png"))
    p2 = plots.plot_breakpoint_histogram(
        np.asarray(rs.positions), 250, str(tmp_path / "bp.png")
    )
    cols = {
        "lev_dist_vs_true": np.array([0, 5, 10, 20, 40, 80]),
        "bp_score_true": np.random.default_rng(0).random(6),
        "bp_score_norm_by_len_true": np.random.default_rng(1).random(6),
        "bp_score_norm_by_break_freqs_true": np.random.default_rng(2).random(6),
    }
    p3 = plots.plot_score_vs_levdist(cols, str(tmp_path / "box.png"))
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 1000


@pytest.mark.slow
def test_scaling_harness(table):
    from genomeassembler_dev.parallel.scaling import measure_scaling

    B, L = 8, 200
    genomes = np.stack([encode_dna(synthetic_genome(i, L)) for i in range(B)])
    pts = measure_scaling(genomes, table.probs[8], read_len=12,
                          n_draws_per_seg=32, device_counts=[1, 2], reps=1)
    assert pts[0].efficiency == 1.0
    assert pts[1].n_devices == 2 and pts[1].reads_per_s > 0


def test_stage_timer(capsys):
    t = StageTimer(verbose=True)
    with t.stage("Doing things"):
        pass
    out = capsys.readouterr().out
    assert "Doing things" in out and "DONE!" in out
    assert "Doing things" in t.times


def test_plots_without_matplotlib_fail_clearly(tmp_path, monkeypatch):
    import sys

    from genomeassembler_dev.utils import plots

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    with pytest.raises(RuntimeError, match="need matplotlib"):
        plots.plot_probability_track(np.zeros(10), str(tmp_path / "t.png"))


def test_main_path_does_not_import_matplotlib():
    import subprocess
    import sys

    code = ("import sys, genomeassembler_dev.pipeline.batch_runner, "
            "genomeassembler_dev.pipeline.velvet, genomeassembler_dev.cli; "
            "print('matplotlib' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "False"
