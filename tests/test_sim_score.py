"""Read simulator and device breakage scorer vs spec."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.core.querytable import TOTAL, QueryTable, load_default_query_table
from genomeassembler_dev.score.breakscore import breakscore
from genomeassembler_dev.sim import reads as sim_reads
from genomeassembler_dev.sim import segments as sim_segments
from genomeassembler_dev.spec import reference_semantics as spec


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.fixture(scope="module")
def table():
    return load_default_query_table()


class TestSegments:
    def test_fasta_roundtrip(self, tmp_path):
        seqs = {"a_1": "ACGTACGTACGT", "b_2": "TTTTGGGGCCCCAAAA"}
        p = str(tmp_path / "x.fasta")
        sim_segments.write_fasta(p, seqs, width=5)
        assert sim_segments.read_fasta(p) == seqs

    def test_sampling_contract(self):
        genome = {"chr1": sim_segments.synthetic_genome(0, 5000),
                  "chr2": sim_segments.synthetic_genome(1, 3000)}
        store = sim_segments.sample_segments(genome, 200, 50, seed=1234)
        assert 0 < len(store) <= 50
        # names encode chrom_start; sequences match the genome slice
        for name, seq in zip(store.names, store.seqs):
            chrom, start = name.rsplit("_", 1)
            start = int(start)
            assert genome[chrom][start - 1 : start - 1 + 200] == seq
        # deterministic
        store2 = sim_segments.sample_segments(genome, 200, 50, seed=1234)
        assert store.names == store2.names

    def test_sampling_drops_non_acgt_segments(self):
        # user FASTAs (--segments-fasta) can carry N runs / IUPAC codes;
        # sampled windows touching them must be dropped, not encoded as 255
        g = sim_segments.synthetic_genome(3, 2000)
        genome = {"chrN": g[:900] + "N" * 200 + g[1100:]}
        store = sim_segments.sample_segments(genome, 150, 400, seed=7)
        assert len(store) > 0
        for seq in store.seqs:
            assert set(seq) <= set("ACGT")

    def test_synthetic_store(self):
        store = sim_segments.synthetic_segment_store(7, 300, 5)
        assert len(store) == 5
        assert all(len(s) == 300 for s in store.seqs)

    def test_repeat_segments_branch_at_study_k(self):
        """Repeat-planted segments must produce multi-contig dBGs at the
        study's largest own-grid k (15) — uniform-random 1 kb sequences have
        no repeats there and the study degenerates to single solutions."""
        from genomeassembler_dev.spec import reference_semantics as spec

        store = sim_segments.synthetic_segment_store(1234, 1000, 4, repeats=True)
        store2 = sim_segments.synthetic_segment_store(1234, 1000, 4, repeats=True)
        assert store.seqs == store2.seqs  # deterministic
        assert all(len(s) == 1000 for s in store.seqs)
        for s in store.seqs:
            kmers = [s[i : i + 15] for i in range(len(s) - 14)]
            assert len(spec.get_contig_set(kmers, 15)) >= 3

    def test_plant_repeats_structures(self):
        """Each repeat class leaves its structural signature: tandem -> an
        adjacent self-repeat, inverted -> a reverse-complement occurrence,
        diverged -> near-identical (but non-exact) long substrings. Length is
        always preserved (fixed sampled-window contract)."""
        base = sim_segments.synthetic_genome(77, 1000)

        tan = sim_segments.plant_repeats(
            base, np.random.default_rng(1), structure=("tandem",))
        assert len(tan) == 1000
        assert any(
            tan[i : i + p] == tan[i + p : i + 2 * p]
            for p in range(20, 81)
            for i in range(0, 1000 - 2 * p)
        ), "no adjacent tandem copy found"

        inv = sim_segments.plant_repeats(
            base, np.random.default_rng(2), structure=("inverted",))
        assert len(inv) == 1000
        rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
        kset = {inv[i : i + 20] for i in range(981)}
        assert any(
            "".join(rc[b] for b in reversed(km)) in kset for km in kset
        ), "no reverse-complement 20-mer occurrence found"

        div = sim_segments.plant_repeats(
            base, np.random.default_rng(3), structure=("diverged",))
        assert len(div) == 1000
        W = 40
        wins = np.stack([encode_dna(div[i : i + W]) for i in range(961)])
        d = (wins[:, None, :] != wins[None, :, :]).sum(-1)
        # same-position / overlapping windows trivially match; require the
        # pair to be at least a window apart
        far = np.abs(np.arange(961)[:, None] - np.arange(961)[None, :]) >= W
        assert ((d >= 1) & (d <= 4) & far).any(), \
            "no near-identical diverged copy found"

    def test_tandem_cycle_handled_by_both_walkers(self):
        """A tandem repeat whose motif exceeds dbg_kmer creates a CYCLE in
        the dBG (the motif's k-mers chain back through the junction). The
        standard walker must terminate (walks stop at branch nodes on the
        cycle; any cap overshoot surfaces via the overflow flag / ladder,
        never a hang) and agree with the executable spec; the biased walker
        must cap the looping walk and flag overflow instead of hanging."""
        from genomeassembler_dev.dbg.assemble import contigs_from_read_codes
        from genomeassembler_dev.dbg.biased import biased_contigs_dense
        from genomeassembler_dev.ops.windows import kmer_window_codes

        k, rl = 9, 12
        seg = sim_segments.plant_repeats(
            sim_segments.synthetic_genome(5, 500),
            np.random.default_rng(5), n_events=3, motif_len=(24, 40),
            structure=("tandem",))
        assert len(seg) == 500
        reads = [seg[i : i + rl] for i in range(len(seg) - rl + 1)]
        kmers = {r[i : i + k] for r in reads for i in range(rl - k + 1)}

        # the graph really is cyclic: some node reaches itself
        succ = {km[:-1]: set() for km in kmers} | {km[1:]: set() for km in kmers}
        for km in kmers:
            succ[km[:-1]].add(km[1:])

        def reaches_self(start):
            seen, stack = set(), list(succ[start])
            while stack:
                n = stack.pop()
                if n == start:
                    return True
                if n in seen:
                    continue
                seen.add(n)
                stack.extend(succ[n])
            return False

        assert any(reaches_self(n) for n in succ), "tandem graph not cyclic"

        codes = np.stack([encode_dna(r) for r in reads])
        valid = np.ones(len(reads), bool)
        got = contigs_from_read_codes(codes, valid, k, 2 * len(seg))
        want = spec.get_contig_set(sorted(kmers), k)
        assert got == want

        kc, kv = kmer_window_codes(jnp.asarray(codes), k)
        probs = jnp.ones(4 ** 8, jnp.float32)
        buf, lens, wv, ovf, nw = biased_contigs_dense(
            kc, kv, probs, k, 128, 256)
        assert int(nw) >= 1  # terminated with walks; cap loops flagged
        assert not bool((np.asarray(lens) > 128).any())


class TestReadSim:
    def test_shapes_and_bounds(self, table):
        g = sim_segments.synthetic_genome(3, 500)
        codes = encode_dna(g)
        rs = sim_reads.generate_reads(jax.random.key(0), codes, table, 12, 10.0)
        n = sim_reads.n_draws_for(10.0, 500, 12)
        assert rs.codes.shape == (n, 12)
        pos = np.asarray(rs.positions)
        valid = np.asarray(rs.valid)
        assert ((pos >= 0) & (pos <= 500 - 8)).all()
        assert ((pos[valid] + 12) <= 500).all()
        # reads match the genome at their positions
        for i in np.nonzero(valid)[0][:20]:
            assert g[pos[i] : pos[i] + 12] == "".join("ACGT"[c] for c in np.asarray(rs.codes)[i])

    def test_track_matches_table(self, table):
        g = "ACGTACGTACGTACGT"
        codes = jnp.asarray(encode_dna(g))
        track = sim_reads.probability_track(codes, jnp.asarray(table.probs[8], jnp.float32), 8)
        expect = [table.probs[8][spec.kmer_code(g[i : i + 8])] for i in range(len(g) - 7)]
        np.testing.assert_allclose(np.asarray(track), expect, rtol=1e-6)

    def test_weighting_bias(self, table):
        # positions with zeroed probability are never drawn
        g = sim_segments.synthetic_genome(4, 300)
        codes = jnp.asarray(encode_dna(g))
        probs = np.zeros(65536, np.float32)
        # only allow the octamer at position 100
        from genomeassembler_dev.core.encoding import kmer_code as kc

        probs[kc(g[100:108])] = 1.0
        rs = sim_reads.simulate_reads(jax.random.key(1), codes, jnp.asarray(probs), 12, 256)
        drawn = set(np.asarray(rs.positions).tolist())
        allowed = {i for i in range(293) if g[i : i + 8] == g[100:108]}
        assert drawn <= allowed

    def test_determinism(self, table):
        g = sim_segments.synthetic_genome(5, 400)
        codes = encode_dna(g)
        a = sim_reads.generate_reads(jax.random.key(9), codes, table, 14, 5.0)
        b = sim_reads.generate_reads(jax.random.key(9), codes, table, 14, 5.0)
        np.testing.assert_array_equal(np.asarray(a.codes), np.asarray(b.codes))

    def test_dedup_reads(self):
        codes = np.array([[0, 1], [0, 1], [2, 3], [0, 1]], np.uint8)
        valid = np.array([True, True, True, False])
        uniq, counts = sim_reads.dedup_reads(codes, valid)
        assert uniq.tolist() == [[0, 1], [2, 3]]
        assert counts.tolist() == [2, 1]


class TestBreakscoreDevice:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_vs_spec(self, seed, table):
        rng = np.random.default_rng(seed)
        true_g = rand_dna(rng, 120)
        # solutions: substrings + mutated variants
        sols = [true_g,
                true_g[10:90],
                rand_dna(rng, 60),
                true_g[:40] + rand_dna(rng, 10)]
        read_len = 12
        reads = []
        for _ in range(60):
            src = sols[int(rng.integers(0, len(sols)))]
            st = int(rng.integers(0, len(src) - read_len + 1))
            reads.append(src[st : st + read_len])
        reads += reads[:10]  # duplicates

        expect = spec.calc_breakscore(sols, reads, true_g, 8, table)

        L = max(len(s) for s in sols)
        pmat = np.full((len(sols), L), 255, np.uint8)
        plen = np.array([len(s) for s in sols], np.int32)
        for i, s in enumerate(sols):
            pmat[i, : len(s)] = encode_dna(s)
        from genomeassembler_dev.sim.reads import dedup_reads

        rcodes = np.stack([encode_dna(r) for r in reads])
        uniq, counts = dedup_reads(rcodes, np.ones(len(reads), bool))
        out = breakscore(
            jnp.asarray(pmat), jnp.asarray(plen), jnp.asarray(uniq),
            jnp.asarray(counts), jnp.ones(len(uniq), bool),
            jnp.asarray(table.combined, jnp.float32),
        )
        np.testing.assert_array_equal(np.asarray(out.kmer_breaks), expect["kmer_breaks"])
        np.testing.assert_allclose(np.asarray(out.bp_score), expect["bp_score"], rtol=2e-5)
        np.testing.assert_allclose(
            np.asarray(out.bp_score_norm_by_break_freqs),
            expect["bp_score_norm_by_break_freqs"], rtol=2e-5,
        )
        np.testing.assert_allclose(
            np.asarray(out.bp_score_norm_by_len), expect["bp_score_norm_by_len"], rtol=2e-5
        )
        pf = np.asarray(out.path_freq)
        for i in range(len(sols)):
            if expect["kmer_breaks"][i] == 0:
                assert np.isnan(pf[i]).all()
            else:
                np.testing.assert_allclose(pf[i], expect["path_freq"][i], atol=1e-6)

    def test_uniform_table(self, table):
        # with the uniform table, bp_score = total_breaks / TOTAL
        rng = np.random.default_rng(3)
        g = rand_dna(rng, 80)
        reads = [g[i : i + 12] for i in (0, 5, 40)]
        uniq = np.stack([encode_dna(r) for r in reads])
        pmat = jnp.asarray(encode_dna(g))[None, :]
        out = breakscore(
            pmat, jnp.asarray([80], np.int32), jnp.asarray(uniq),
            jnp.asarray([1, 1, 1], np.int32), jnp.ones(3, bool),
            jnp.asarray(QueryTable.uniform().combined, jnp.float32),
        )
        assert np.isclose(float(out.bp_score[0]), 3 / TOTAL, rtol=1e-5)


def test_dedup_drops_invalid_base_reads():
    from genomeassembler_dev.sim.reads import dedup_reads

    codes = np.array([[0, 1, 2], [0, 255, 2], [0, 1, 2]], np.uint8)
    valid = np.ones(3, bool)
    uniq, counts = dedup_reads(codes, valid)
    assert uniq.tolist() == [[0, 1, 2]]
    assert counts.tolist() == [2]
