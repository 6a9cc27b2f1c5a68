"""Golden tests against the reference C++ kernels.

Fixtures in tests/golden/fixtures/ are produced by compiling the reference
sources (/root/reference/lib/DeNovoAssembler.cpp, BreakageScorer.cpp) with
shim headers and running them on recorded read sets — see
tests/golden/make_fixtures.py. These tests gate the executable spec and the
production backends on true reference outputs: a mis-read of the dBG walk
(cpp:85-206), the merge fixpoint (cpp:214-305), or the scorer (cpp:316-477)
fails here even if every spec-derived test still passes.

Comparison contract (documented in SURVEY §7.1):
  * contig sets, shuffle orderings, solution sets, kmer_breaks, lev_dist:
    exact;
  * double scores: allclose at rtol 1e-12 (the reference accumulates in gtl
    hash-map iteration order, so bit-equality across map implementations is
    not defined);
  * path_freq rows: sorted nonzero values (the reference emits hash-map
    element order, consumed only by an order-invariant KS test).
"""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import pytest

from genomeassembler_dev.core.encoding import encode_dna, kmer_codes_np
from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.merge import native
from genomeassembler_dev.merge.engine import assemble_solutions
from genomeassembler_dev.spec import reference_semantics as spec

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "golden", "fixtures")
FIXTURES = sorted(f[:-5] for f in os.listdir(FIXTURE_DIR) if f.endswith(".json"))
OWN = [f for f in FIXTURES if f.startswith("own")]
VELVET = [f for f in FIXTURES if f.startswith("velvet")]

TABLE = load_default_query_table()


def load(name: str) -> dict:
    with open(os.path.join(FIXTURE_DIR, f"{name}.json")) as f:
        return json.load(f)


def read_kmers_of(reads: list[str], k: int) -> list[str]:
    out = []
    for r in reads:
        out.extend(r[i : i + k] for i in range(len(r) - k + 1))
    return out


def path_freq_nonzero_sorted(path_freq: np.ndarray) -> list[list[float]]:
    out = []
    for row in path_freq:
        vals = row[np.isfinite(row) & (row != 0.0)]
        out.append(np.sort(vals))
    return out


@pytest.mark.parametrize("name", OWN)
class TestOwnGolden:
    def test_contig_set(self, name):
        fx = load(name)
        kmers = read_kmers_of(fx["reads"], fx["config"]["dbg_kmer"])
        ours = spec.get_contig_set(kmers, fx["config"]["dbg_kmer"])
        assert ours == fx["reference"]["contigs"]

    def test_shuffle_replay(self, name):
        fx = load(name)
        ref = fx["reference"]
        orderings = spec.shuffled_orderings(
            ref["contigs"], fx["config"]["seed"], 2
        )
        assert orderings[0] == ref["ordering0"]
        assert orderings[1] == ref["ordering1"]

    def test_solutions_native(self, name):
        if not native.available():
            pytest.skip("native engine not built")
        fx = load(name)
        ours = assemble_solutions(
            fx["reference"]["contigs"], fx["config"]["dbg_kmer"],
            fx["config"]["seed"], fx["reference"]["n_orderings"],
            backend="native",
        )
        assert sorted(ours) == sorted(fx["reference"]["solutions"])
        # length-descending like the reference (ties canonicalised our side)
        assert [len(s) for s in ours] == sorted(
            (len(s) for s in ours), reverse=True
        )

    def test_scores_spec(self, name):
        fx = load(name)
        ref = fx["reference"]
        # identity idx in the reference scorer: row order == input path order
        out = spec.calc_breakscore(
            ref["sequence"], fx["reads"], fx["segment"],
            fx["config"]["break_kmer"], TABLE,
        )
        assert out["sequence_len"] == ref["sequence_len"]
        np.testing.assert_allclose(out["bp_score"], ref["bp_score"],
                                   rtol=1e-12)
        np.testing.assert_allclose(
            out["bp_score_norm_by_break_freqs"],
            ref["bp_score_norm_by_break_freqs"], rtol=1e-12)
        np.testing.assert_allclose(out["bp_score_norm_by_len"],
                                   ref["bp_score_norm_by_len"], rtol=1e-12)
        np.testing.assert_array_equal(out["kmer_breaks"],
                                      np.asarray(ref["kmer_breaks"]))
        np.testing.assert_array_equal(out["lev_dist_vs_true"],
                                      np.asarray(ref["lev_dist_vs_true"]))
        ours_nz = path_freq_nonzero_sorted(out["path_freq"])
        assert len(ours_nz) == len(ref["path_freq_nonzero_sorted"])
        for mine, theirs in zip(ours_nz, ref["path_freq_nonzero_sorted"]):
            np.testing.assert_allclose(mine, np.sort(theirs), rtol=1e-12)

    def test_scores_device(self, name):
        """The production (JAX) breakscore against the reference fixture."""
        import jax.numpy as jnp

        from genomeassembler_dev.pipeline.assembler import (
            pack_strings, pad_reads)
        from genomeassembler_dev.score.breakscore import breakscore
        from genomeassembler_dev.sim.reads import dedup_reads

        fx = load(name)
        ref = fx["reference"]
        paths = ref["sequence"]
        pmat, plens = pack_strings(paths, s_multiple=8, l_multiple=128)
        codes = np.stack([encode_dna(r) for r in fx["reads"]])
        uniq, counts = dedup_reads(codes, np.ones(len(fx["reads"]), bool))
        rcodes, rcounts, rvalid = pad_reads(uniq, counts, 128)
        bs = breakscore(
            jnp.asarray(pmat), jnp.asarray(plens), jnp.asarray(rcodes),
            jnp.asarray(rcounts), jnp.asarray(rvalid),
            jnp.asarray(TABLE.combined, jnp.float32),
            break_kmer=fx["config"]["break_kmer"], read_chunk=128,
        )
        n = len(paths)
        # device scorer accumulates in f32; gate at f32 resolution
        np.testing.assert_allclose(np.asarray(bs.bp_score)[:n],
                                   ref["bp_score"], rtol=2e-5)
        np.testing.assert_array_equal(np.asarray(bs.kmer_breaks)[:n],
                                      np.asarray(ref["kmer_breaks"]))


@pytest.mark.parametrize("name", VELVET)
class TestVelvetGolden:
    def test_solutions(self, name):
        if not native.available():
            pytest.skip("native engine not built")
        fx = load(name)
        ours = assemble_solutions(
            fx["external_contigs"], fx["config"]["dbg_kmer"],
            fx["config"]["seed"], 20000, backend="native",
        )
        assert sorted(ours) == sorted(fx["reference"]["solutions"])

    def test_scores_and_profiles(self, name):
        fx = load(name)
        ref = fx["reference"]
        paths = ref["sequence"]
        # score columns share the own-path formulas (BreakageScorer.cpp
        # :231-321 == DeNovoAssembler.cpp:346-426); Levenshtein is HW
        out = spec.calc_breakscore(paths, fx["reads"], fx["segment"],
                                   fx["config"]["break_kmer"], TABLE)
        np.testing.assert_allclose(out["bp_score"], ref["bp_score"],
                                   rtol=1e-12)
        np.testing.assert_allclose(
            out["bp_score_norm_by_break_freqs"],
            ref["bp_score_norm_by_break_freqs"], rtol=1e-12)
        np.testing.assert_array_equal(out["kmer_breaks"],
                                      np.asarray(ref["kmer_breaks"]))
        lev_hw = [spec.levenshtein(p, fx["segment"], mode="HW") for p in paths]
        np.testing.assert_array_equal(lev_hw, ref["lev_dist_vs_true"])
        # rolling octamer probability profile (BreakageScorer.cpp:199-215)
        for i, p in enumerate(paths):
            prof = TABLE.probs[8][kmer_codes_np(encode_dna(p), 8)]
            np.testing.assert_allclose(prof, ref["path_prob_dist"][i],
                                       rtol=1e-12)
        # startpos is only written when a read matched (cpp:273-274);
        # value-initialised 0 otherwise — compare where defined
        startpos = np.asarray(ref["path_prob_dist_startpos"])
        breaks = np.asarray(ref["kmer_breaks"])
        want = np.array([fx["segment"].find(p) for p in paths])
        np.testing.assert_array_equal(startpos[breaks > 0], want[breaks > 0])


class TestFixtureFreshness:
    def test_harness_builds_and_reproduces(self):
        """Rebuild the harness from the reference sources and re-run one
        case: catches silent drift between committed fixtures and the
        reference tree (and proves the fixtures are reproducible here)."""
        harness_dir = os.path.join(os.path.dirname(__file__), "golden",
                                   "harness")
        if not os.path.isdir("/root/reference/lib"):
            pytest.skip("reference tree not present")
        r = subprocess.run(["make", "-C", harness_dir], capture_output=True)
        if r.returncode != 0:
            pytest.skip(f"harness build unavailable: {r.stderr[-200:]!r}")
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
        try:
            import make_fixtures as mf
        finally:
            sys.path.pop(0)
        bp_kmer, bp_prob = mf.table_lines()
        (name, mode, seq_len, read_len, dbg_kmer, sim_seed, cov) = mf.CASES[0]
        fx = mf.make_fixture(name, mode, seq_len, read_len, dbg_kmer,
                             sim_seed, cov, bp_kmer, bp_prob)
        committed = load(name)
        assert fx["reads"] == committed["reads"]
        assert fx["reference"]["contigs"] == committed["reference"]["contigs"]
        assert (fx["reference"]["solutions"]
                == committed["reference"]["solutions"])
        np.testing.assert_allclose(fx["reference"]["bp_score"],
                                   committed["reference"]["bp_score"],
                                   rtol=1e-12)
