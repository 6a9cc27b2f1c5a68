"""Native engine vs spec oracle: orderings, merge fixpoint, contig builder."""

import numpy as np
import pytest

from genomeassembler_dev.merge import engine, native
from genomeassembler_dev.spec import reference_semantics as spec


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


needs_native = pytest.mark.skipif(not native.available(), reason="native engine unavailable")


@needs_native
class TestNativeMerge:
    @pytest.mark.parametrize("seed", [1234, 7, 99])
    def test_matches_spec_ensemble(self, seed):
        rng = np.random.default_rng(seed)
        g = rand_dna(rng, 150)
        k = 7
        reads = [g[i : i + 15] for i in range(0, 136, 3)] + [g[135:150]]
        kmers = [r[i : i + k] for r in reads for i in range(len(r) - k + 1)]
        contigs = spec.get_contig_set(kmers, k)
        n_ord = 200
        got = native.assemble_native(contigs, k, seed, n_ord, n_threads=2)
        expect = spec.assemble_solutions(spec.shuffled_orderings(contigs, seed, n_ord), k)
        assert got == expect

    def test_single_contig(self):
        got = native.assemble_native(["ACGTACGT"], 5, 1234, 10)
        assert got == ["ACGTACGT"]

    def test_thread_count_invariance(self):
        rng = np.random.default_rng(0)
        contigs = sorted({rand_dna(rng, int(rng.integers(8, 20))) for _ in range(12)})
        a = native.assemble_native(contigs, 7, 1234, 500, n_threads=1)
        b = native.assemble_native(contigs, 7, 1234, 500, n_threads=4)
        assert a == b

    def test_engine_dispatch(self):
        contigs = ["AACGT", "CGTTA"]
        a = engine.assemble_solutions(contigs, 4, 1234, 50, backend="native")
        b = engine.assemble_solutions(contigs, 4, 1234, 50, backend="spec")
        assert a == b


@needs_native
class TestNativeBaseline:
    def test_contigs_from_reads(self):
        rng = np.random.default_rng(1)
        g = rand_dna(rng, 100)
        rlen, k = 12, 7
        reads = [g[i : i + rlen] for i in range(0, len(g) - rlen + 1, 2)] + [g[-rlen:]]
        got = native.contigs_from_reads_native(reads, k)
        kmers = [r[i : i + k] for r in reads for i in range(rlen - k + 1)]
        assert got == spec.get_contig_set(kmers, k)

    def test_count_kmers(self):
        reads = ["ACGTACGT", "TTTTTTTT"]
        counts = native.count_kmers_native(reads, 4)
        from genomeassembler_dev.core.encoding import kmer_code

        expect = np.zeros(256, np.int64)
        for r in reads:
            for i in range(len(r) - 3):
                expect[kmer_code(r[i : i + 4])] += 1
        np.testing.assert_array_equal(counts, expect)


@needs_native
class TestNativeBreakscore:
    def test_matches_spec(self):
        from genomeassembler_dev.core.querytable import load_default_query_table

        table = load_default_query_table()
        rng = np.random.default_rng(5)
        true_g = rand_dna(rng, 120)
        paths = [true_g, true_g[10:90], rand_dna(rng, 60)]
        reads = []
        for _ in range(40):
            src = paths[int(rng.integers(0, len(paths)))]
            st = int(rng.integers(0, len(src) - 12 + 1))
            reads.append(src[st : st + 12])
        reads += reads[:8]
        scores, breaks = native.breakscore_native(paths, reads, table.combined)
        expect = spec.calc_breakscore(paths, reads, true_g, 8, table)
        np.testing.assert_allclose(scores, expect["bp_score"], rtol=1e-12)
        np.testing.assert_array_equal(breaks, expect["kmer_breaks"])


@needs_native
def test_short_contig_contract_consistent():
    """Contigs shorter than the overlap k are skipped identically by spec,
    native and device backends (the reference would crash on them)."""
    from genomeassembler_dev.merge.device import assemble_device

    contigs = sorted({"ACG", "CGTACGGA", "GATTACAAT", "TA"})
    k = 7
    sp = spec.assemble_solutions(spec.shuffled_orderings(contigs, 5, 40), k)
    na = native.assemble_native(contigs, k, 5, 40)
    de = assemble_device(contigs, k, 5, 40)
    assert sp == na == de
