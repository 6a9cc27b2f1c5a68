"""Property tests: invariants the pipeline must satisfy for any input
(SURVEY §4's designed-from-scratch test strategy, oracle class (b))."""

import numpy as np
import pytest

from genomeassembler_dev.core.querytable import QueryTable
from genomeassembler_dev.merge import native
from genomeassembler_dev.spec import reference_semantics as spec


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def sliding(s, k):
    return [s[i : i + k] for i in range(len(s) - k + 1)]


@pytest.mark.parametrize("seed", range(6))
def test_unbranched_genome_reconstructs(seed):
    """A genome whose dBG has no interior branches yields itself as the one
    contig (the fundamental unitig property)."""
    rng = np.random.default_rng(seed)
    k = 11  # long k on a short random genome: repeats are unlikely
    g = rand_dna(rng, 150)
    contigs = spec.get_contig_set(sliding(g, k), k)
    if len(contigs) == 1:
        assert contigs[0] == g


@pytest.mark.parametrize("seed", range(4))
def test_score_invariant_to_read_order(seed):
    rng = np.random.default_rng(seed)
    g = rand_dna(rng, 100)
    reads = [g[i : i + 12] for i in range(0, 89, 3)] + [rand_dna(rng, 12)] * 3
    table = QueryTable.uniform()
    a = spec.calc_breakscore([g], reads, g, 8, table)
    shuffled = list(reads)
    rng.shuffle(shuffled)
    b = spec.calc_breakscore([g], shuffled, g, 8, table)
    np.testing.assert_allclose(a["bp_score"], b["bp_score"], rtol=1e-12)
    np.testing.assert_array_equal(a["kmer_breaks"], b["kmer_breaks"])


@pytest.mark.parametrize("seed", range(4))
def test_contig_set_invariant_to_kmer_multiplicity_and_order(seed):
    rng = np.random.default_rng(seed)
    g = rand_dna(rng, 120)
    kmers = sliding(g, 7)
    base = spec.get_contig_set(kmers, 7)
    dup = kmers * 3
    rng.shuffle(dup)
    assert spec.get_contig_set(dup, 7) == base


@pytest.mark.parametrize("seed", range(4))
def test_merge_conserves_characters(seed):
    """Greedy merging trims exactly k overlap characters per join: total
    character count after a fixpoint pass = sum(len) - k * (#merges)."""
    rng = np.random.default_rng(seed)
    contigs = sorted({rand_dna(rng, int(rng.integers(9, 18))) for _ in range(8)})
    k = 9
    out = spec.merge_one_ordering(list(contigs), k)
    n_merges = len(contigs) - len(out)
    total_in = sum(len(c) for c in contigs)
    total_out = sum(len(c) for c in out)
    # each merge trims between 1 and k-1 characters
    assert total_in - total_out <= (k - 1) * n_merges
    assert total_in - total_out >= n_merges if n_merges else total_in == total_out


@pytest.mark.parametrize("seed", range(3))
def test_solutions_contain_all_contig_characters_sets(seed):
    """Every original contig appears as a substring of some solution in
    every ordering's result (merging only concatenates)."""
    rng = np.random.default_rng(seed)
    contigs = sorted({rand_dna(rng, int(rng.integers(9, 15))) for _ in range(6)})
    out = spec.merge_one_ordering(list(contigs), 9)
    for c in contigs:
        assert any(c in sol for sol in out), c


@pytest.mark.skipif(not native.available(), reason="native engine unavailable")
def test_native_ensemble_monotone_in_orderings():
    """More orderings can only grow the deduplicated solution set."""
    rng = np.random.default_rng(0)
    contigs = sorted({rand_dna(rng, int(rng.integers(9, 16))) for _ in range(7)})
    small = set(native.assemble_native(contigs, 9, 1234, 50))
    big = set(native.assemble_native(contigs, 9, 1234, 500))
    assert small <= big


def test_ks_statistic_bounds():
    rng = np.random.default_rng(1)
    for _ in range(10):
        x = rng.random(rng.integers(2, 40))
        y = rng.random(rng.integers(2, 40))
        d = spec.ks_2samp(x, y)
        assert 0.0 <= d <= 1.0


def test_levenshtein_metric_properties():
    rng = np.random.default_rng(2)
    strs = [rand_dna(rng, int(rng.integers(0, 15))) for _ in range(6)]
    for a in strs:
        assert spec.levenshtein(a, a) == 0
        for b in strs:
            ab = spec.levenshtein(a, b)
            assert ab == spec.levenshtein(b, a)  # symmetry
            for c in strs:
                assert ab <= spec.levenshtein(a, c) + spec.levenshtein(c, b)
