"""Big-k (pair-code) de Bruijn graph vs spec."""

import numpy as np
import pytest
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.dbg.assemble import dedup_contigs
from genomeassembler_dev.dbg.big_k import contigs_big_k, kmer_pair_codes
from genomeassembler_dev.spec import reference_semantics as spec


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


class TestPairCodes:
    def test_matches_python_ints(self):
        rng = np.random.default_rng(0)
        s = rand_dna(rng, 60)
        for k in (17, 24, 31):
            hi, lo, valid = kmer_pair_codes(jnp.asarray(encode_dna(s)), k)
            assert bool(np.asarray(valid).all())
            for i in range(60 - k + 1):
                code = 0
                for ch in s[i : i + k]:
                    code = (code << 2) | "ACGT".index(ch)
                assert int(np.asarray(hi)[i]) == code >> 32, (k, i)
                assert int(np.asarray(lo)[i]) == code & 0xFFFFFFFF, (k, i)

    def test_invalid_base(self):
        s = "A" * 20 + "N" + "C" * 20
        hi, lo, valid = kmer_pair_codes(jnp.asarray(encode_dna(s)), 17)
        v = np.asarray(valid)
        assert not v[5] and not v[20]
        assert v[21:].all()


class TestBigKContigs:
    @pytest.mark.parametrize("seed,glen,rlen,k", [
        (0, 200, 20, 17), (1, 300, 40, 31), (2, 400, 40, 25),
    ])
    def test_matches_spec(self, seed, glen, rlen, k):
        rng = np.random.default_rng(seed)
        g = rand_dna(rng, glen)
        starts = sorted(set(rng.integers(0, glen - rlen + 1, size=glen).tolist())
                        | {0, glen - rlen})
        reads = [g[i : i + rlen] for i in starts]
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        hi, lo, valid = kmer_pair_codes(codes, k)
        buf, lens, wvalid, ovf, n_walks, n_nodes = contigs_big_k(
            hi, lo, valid, k, glen + k, 512
        )
        got = dedup_contigs(np.asarray(buf), np.asarray(lens),
                            np.asarray(wvalid), np.asarray(ovf))
        kmers = [r[i : i + k] for r in reads for i in range(rlen - k + 1)]
        expect = spec.get_contig_set(kmers, k)
        assert got == expect, (len(got), len(expect))


class TestEndToEndBigK:
    def test_full_pipeline_k31(self):
        """BASELINE config 1 shape: 150bp-class reads, k=31 assembly +
        breakage score, on a small segment."""
        import jax
        from genomeassembler_dev.core.querytable import load_default_query_table
        from genomeassembler_dev.pipeline.assembler import Assembler
        from genomeassembler_dev.pipeline.config import ExperimentConfig
        from genomeassembler_dev.sim.segments import synthetic_genome

        cfg = ExperimentConfig(seq_len=500, read_len=150, coverage_target=30.0,
                               kmer=8, dbg_kmer=31, seed=1234, n_orderings=100)
        asm = Assembler(cfg, load_default_query_table())
        res = asm.run_experiment(synthetic_genome(9, 500))
        assert res.n_solutions > 0
        # error-free high-coverage 150bp reads at k=31: nearly the whole
        # genome reconstructs (edges may be uncovered by sampled reads)
        lens = res.columns["sequence_len"]
        assert lens.max() >= 420
        best = int(np.argmax(lens))
        # the longest solution is a near-exact (sub)string of the truth
        assert res.columns["lev_dist_vs_true"][best] <= 500 - lens.max() + 5


class TestReExecution:
    """Jitted programs must not close over module-level jax Arrays: once the
    sparse walk had traced them, later programs got them as an extra hoisted
    parameter that jit's C++ dispatch path did not pass on re-execution
    ("supplied 3 buffers but compiled program expected 4")."""

    def test_big_k_runs_twice_after_the_sparse_path(self, tmp_path):
        # a fresh process: which programs see the constants depends on the
        # import order, so the scenario is replayed from a clean start
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = """
import numpy as np
from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.dbg.assemble import contigs_from_read_codes
from genomeassembler_dev.sim.segments import synthetic_genome
g = synthetic_genome(2, 300)
codes = np.stack([encode_dna(g[i:i + 40]) for i in range(0, 260, 5)])
ok = np.ones(len(codes), bool)
contigs_from_read_codes(codes, ok, 13, 600)
a = contigs_from_read_codes(codes, ok, 21, 600)
b = contigs_from_read_codes(codes, ok, 21, 600)
assert a == b and len(a) >= 1
print("OK")
"""
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
                   JAX_COMPILATION_CACHE_DIR=str(tmp_path))
        r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]

    def test_no_module_level_device_arrays(self):
        import importlib
        import pkgutil

        import jax

        import genomeassembler_dev as pkg

        found = []
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            mod = importlib.import_module(m.name)
            found += [f"{m.name}.{k}" for k, v in vars(mod).items()
                      if isinstance(v, jax.Array)]
        assert not found, found
