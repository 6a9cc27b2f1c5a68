"""Device ops vs spec oracle."""

import numpy as np
import pytest
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import encode_dna, kmer_code, kmer_codes_np
from genomeassembler_dev.ops.edit_distance import batched_levenshtein
from genomeassembler_dev.ops.histogram import count_kmers, count_kmers_batched
from genomeassembler_dev.ops.ks import batched_ks_2samp
from genomeassembler_dev.ops.match import find_first_match
from genomeassembler_dev.ops.windows import kmer_window_codes, pack_words
from genomeassembler_dev.spec import reference_semantics as spec


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


class TestWindows:
    def test_matches_numpy(self):
        s = "ACGTTGCATTGCAAGT"
        codes = jnp.asarray(encode_dna(s))
        for k in (2, 5, 8, 15):
            out, valid = kmer_window_codes(codes, k)
            np.testing.assert_array_equal(np.asarray(out), kmer_codes_np(encode_dna(s), k))
            assert bool(np.asarray(valid).all())

    def test_invalid_propagates(self):
        codes = jnp.asarray(encode_dna("ACNTACGT"))
        out, valid = kmer_window_codes(codes, 3)
        assert np.asarray(valid).tolist() == [False, False, False, True, True, True]

    def test_pack_words_matches_host(self):
        from genomeassembler_dev.core.encoding import pack_words_np

        rng = np.random.default_rng(0)
        for L in (5, 16, 17, 40):
            codes = rng.integers(0, 4, size=(3, L)).astype(np.uint8)
            np.testing.assert_array_equal(
                np.asarray(pack_words(jnp.asarray(codes))), pack_words_np(codes)
            )


class TestHistogram:
    def test_count(self):
        codes = jnp.asarray([0, 1, 1, 5, 2], dtype=jnp.int32)
        valid = jnp.asarray([True, True, True, True, False])
        out = np.asarray(count_kmers(codes, valid, 6))
        assert out.tolist() == [1, 2, 0, 0, 0, 1]

    def test_batched(self):
        codes = jnp.asarray([[0, 1], [1, 1]], dtype=jnp.int32)
        valid = jnp.ones((2, 2), bool)
        out = np.asarray(count_kmers_batched(codes, valid, 3))
        assert out.tolist() == [[1, 1, 0], [0, 2, 0]]


class TestEditDistance:
    @pytest.mark.parametrize("mode", ["NW", "HW"])
    def test_vs_spec_random(self, mode):
        rng = np.random.default_rng(3)
        target = rand_dna(rng, 60)
        queries = [rand_dna(rng, int(rng.integers(1, 80))) for _ in range(12)]
        M = max(len(q) for q in queries)
        qmat = np.zeros((len(queries), M), np.uint8)
        qlen = np.array([len(q) for q in queries], np.int32)
        for i, q in enumerate(queries):
            qmat[i, : len(q)] = encode_dna(q)
        out = np.asarray(
            batched_levenshtein(jnp.asarray(qmat), jnp.asarray(qlen),
                                jnp.asarray(encode_dna(target)), mode=mode)
        )
        expect = [spec.levenshtein(q, target, mode=mode) for q in queries]
        assert out.tolist() == expect

    def test_padded_target(self):
        rng = np.random.default_rng(4)
        target = rand_dna(rng, 30)
        q = rand_dna(rng, 25)
        tpad = np.zeros(50, np.uint8)
        tpad[:30] = encode_dna(target)
        out = batched_levenshtein(
            jnp.asarray(encode_dna(q))[None, :],
            jnp.asarray([25], dtype=jnp.int32),
            jnp.asarray(tpad),
            target_len=30,
        )
        assert int(out[0]) == spec.levenshtein(q, target, mode="NW")


class TestMatch:
    def test_vs_str_find(self):
        rng = np.random.default_rng(5)
        paths = [rand_dna(rng, int(rng.integers(30, 80))) for _ in range(6)]
        # reads: some substrings of paths, some random
        read_len = 12
        reads = []
        for _ in range(20):
            if rng.random() < 0.6:
                p = paths[int(rng.integers(len(paths)))]
                start = int(rng.integers(0, len(p) - read_len + 1))
                reads.append(p[start : start + read_len])
            else:
                reads.append(rand_dna(rng, read_len))
        L = max(len(p) for p in paths)
        pmat = np.full((len(paths), L), 255, np.uint8)
        plen = np.array([len(p) for p in paths], np.int32)
        for i, p in enumerate(paths):
            pmat[i, : len(p)] = encode_dna(p)
        rmat = np.stack([encode_dna(r) for r in reads])
        found, first = find_first_match(
            jnp.asarray(pmat), jnp.asarray(plen), jnp.asarray(rmat),
            jnp.ones(len(reads), bool), read_chunk=8,
        )
        found, first = np.asarray(found), np.asarray(first)
        for i, p in enumerate(paths):
            for j, r in enumerate(reads):
                pos = p.find(r)
                assert found[i, j] == (pos != -1), (i, j)
                if pos != -1:
                    assert first[i, j] == pos, (i, j, pos, first[i, j])

    def test_long_reads_multiword(self):
        rng = np.random.default_rng(6)
        p = rand_dna(rng, 120)
        reads = [p[10:50], p[77:117], rand_dna(rng, 40)]  # 40-mers: 3 words
        pmat = jnp.asarray(encode_dna(p))[None, :]
        rmat = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        found, first = find_first_match(
            pmat, jnp.asarray([120], dtype=jnp.int32), rmat, jnp.ones(3, bool)
        )
        assert np.asarray(found)[0].tolist() == [True, True, p.find(reads[2]) != -1]
        assert int(first[0, 0]) == p.find(reads[0])
        assert int(first[0, 1]) == 77 or p.find(reads[1]) == int(first[0, 1])

    def test_sorted_equals_grid(self):
        """find_first_match_sorted == find_first_match on adversarial inputs:
        padded paths, duplicate reads, invalid read slots, and all-T reads /
        windows (whose packed word collides with the 0xFFFFFFFF pad-window
        sentinel in _window_words)."""
        from genomeassembler_dev.ops.match import find_first_match_sorted

        rng = np.random.default_rng(11)
        for read_len in (12, 16, 40):  # 1 word w/ slack, exact word, 3 words
            paths = [rand_dna(rng, int(rng.integers(50, 120))) for _ in range(5)]
            # plant an all-T stretch so some windows are all-T
            paths[0] = paths[0][:10] + "T" * 30 + paths[0][40:]
            reads = []
            for _ in range(24):
                r = rng.random()
                if r < 0.5:
                    p = paths[int(rng.integers(len(paths)))]
                    start = int(rng.integers(0, len(p) - read_len + 1))
                    reads.append(p[start : start + read_len])
                elif r < 0.7:
                    reads.append("T" * read_len)  # all-T read
                else:
                    reads.append(rand_dna(rng, read_len))
            reads += reads[:4]  # duplicates
            L = max(len(p) for p in paths) + 17  # pad beyond longest path
            pmat = np.full((len(paths), L), 255, np.uint8)
            plen = np.array([len(p) for p in paths], np.int32)
            for i, p in enumerate(paths):
                pmat[i, : len(p)] = encode_dna(p)
            rmat = np.stack([encode_dna(r) for r in reads])
            rvalid = np.ones(len(reads), bool)
            rvalid[3] = rvalid[10] = False  # invalid slots interleaved
            args = (jnp.asarray(pmat), jnp.asarray(plen), jnp.asarray(rmat),
                    jnp.asarray(rvalid))
            f_g, p_g = (np.asarray(x) for x in find_first_match(*args))
            f_s, p_s = (np.asarray(x) for x in find_first_match_sorted(*args))
            np.testing.assert_array_equal(f_s, f_g, err_msg=f"rl={read_len}")
            np.testing.assert_array_equal(
                np.where(f_s, p_s, 0), np.where(f_g, p_g, 0),
                err_msg=f"rl={read_len}")
            # cross-check a few against str.find
            for i, p in enumerate(paths):
                for j, r in enumerate(reads):
                    want = p.find(r) if rvalid[j] else -1
                    assert f_s[i, j] == (want != -1)
                    if want != -1:
                        assert p_s[i, j] == want


class TestKS:
    def test_vs_spec(self):
        rng = np.random.default_rng(7)
        y = rng.random(97)
        xs = rng.random((5, 200))
        xs[1, :150] = 0.0  # heavy ties like real path_freq rows
        out = np.asarray(batched_ks_2samp(jnp.asarray(xs, dtype=jnp.float32), jnp.asarray(y, dtype=jnp.float32)))
        for i in range(xs.shape[0]):
            expect = spec.ks_2samp(xs[i].astype(np.float32), y.astype(np.float32))
            assert abs(out[i] - expect) < 1e-6, i

    def test_nan_row(self):
        xs = jnp.asarray(np.full((1, 10), np.nan), dtype=jnp.float32)
        y = jnp.asarray(np.arange(5), dtype=jnp.float32)
        assert np.isnan(np.asarray(batched_ks_2samp(xs, y))[0])


class TestDbgDevice:
    # k=5,7,9 exercise the dense path; k=11,13 the sparse path
    @pytest.mark.parametrize(
        "seed,glen,rlen,k",
        [(0, 40, 8, 5), (1, 120, 12, 7), (2, 200, 12, 9),
         (3, 300, 15, 11), (4, 400, 16, 13)],
    )
    def test_contigs_match_spec(self, seed, glen, rlen, k):
        from genomeassembler_dev.dbg.assemble import DENSE_MAX_K, contigs_from_read_codes

        rng = np.random.default_rng(seed)
        g = rand_dna(rng, glen)
        starts = sorted(set(rng.integers(0, glen - rlen + 1, size=glen).tolist()) | {0, glen - rlen})
        reads = [g[i : i + rlen] for i in starts]
        read_codes = np.stack([encode_dna(r) for r in reads])
        got = contigs_from_read_codes(read_codes, np.ones(len(reads), bool), k, glen + k)
        kmers = [r[i : i + k] for r in reads for i in range(rlen - k + 1)]
        expect = spec.get_contig_set(kmers, k)
        assert got == expect

    @pytest.mark.parametrize("seed", [0, 5, 9])
    def test_dense_sparse_agree(self, seed):
        from genomeassembler_dev.dbg.dense import contigs_dense
        from genomeassembler_dev.dbg.graph import contigs_sparse
        from genomeassembler_dev.dbg.assemble import dedup_contigs
        import jax.numpy as jnp
        from genomeassembler_dev.ops.windows import kmer_window_codes

        rng = np.random.default_rng(seed)
        g = rand_dna(rng, 250)
        reads = [g[i : i + 14] for i in range(0, 236, 3)] + [g[-14:]]
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        k = 9
        kc, kv = kmer_window_codes(codes, k)
        outs = []
        for fn in (contigs_dense, contigs_sparse):
            buf, lens, valid, ov, nt, nn = fn(kc, kv, k, 300, 512)
            outs.append(dedup_contigs(np.asarray(buf), np.asarray(lens),
                                      np.asarray(valid), np.asarray(ov)))
        assert outs[0] == outs[1]

    def test_walk_while_loop_agrees(self):
        # the legacy while_loop walk stays as a second implementation;
        # cross-check it against the doubling walk
        import jax.numpy as jnp
        from genomeassembler_dev.dbg.graph import build_dbg
        from genomeassembler_dev.dbg.traverse import walk_contigs
        from genomeassembler_dev.dbg.assemble import dedup_contigs, contigs_from_read_codes
        from genomeassembler_dev.ops.windows import kmer_window_codes

        rng = np.random.default_rng(11)
        g = rand_dna(rng, 150)
        reads = [g[i : i + 12] for i in range(0, 139, 2)] + [g[-12:]]
        codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
        k = 7
        kc, kv = kmer_window_codes(codes, k)
        gph = build_dbg(kc.reshape(-1), kv.reshape(-1), k)
        buf, lens, wv, ov, _ = walk_contigs(gph, 200)
        legacy = dedup_contigs(np.asarray(buf), np.asarray(lens), np.asarray(wv), np.asarray(ov))
        new = contigs_from_read_codes(
            np.stack([encode_dna(r) for r in reads]), np.ones(len(reads), bool), k, 200
        )
        assert legacy == new


class TestDedupMXU:
    def test_bincount_weighted_matches_numpy(self):
        from genomeassembler_dev.ops.mxu import bincount_mxu

        rng = np.random.default_rng(3)
        idx = rng.integers(0, 64, 500)
        valid = rng.random(500) < 0.9
        w = rng.integers(0, 70000, 500)  # exercises all three 8-bit limbs
        got = np.asarray(bincount_mxu(jnp.asarray(idx.astype(np.int32)),
                                      jnp.asarray(valid), 64,
                                      jnp.asarray(w.astype(np.int32))))
        want = np.bincount(idx[valid], weights=w[valid], minlength=64)
        np.testing.assert_array_equal(got, want)

    def test_compact_by_rank_matches_sort(self):
        from genomeassembler_dev.ops.mxu import compact_by_rank_mxu

        rng = np.random.default_rng(4)
        mask = rng.random(4096) < 0.1
        vals = rng.integers(0, 2**20, 4096).astype(np.int32)
        limbs = tuple(jnp.asarray((vals >> s) & 255) for s in (0, 8, 16))
        outs, n = compact_by_rank_mxu(jnp.asarray(mask), limbs, 512)
        got = sum(np.asarray(c) << (8 * i) for i, c in enumerate(outs))
        want = vals[mask]
        assert int(n) == want.size
        np.testing.assert_array_equal(got[: want.size], want)
        assert (got[want.size:] == 0).all()

    def test_node_table_sorted_matches_dense(self):
        """The sort-scan node-table builder (one sort + rank scatter over 2N
        edge items) must produce the identical compacted (ids, nibbles,
        count) triple as the 4^k presence-bitmap builder for every k it can
        dispatch to."""
        from genomeassembler_dev.dbg.dense import (
            _node_table_dense, _node_table_sorted)

        rng = np.random.default_rng(11)
        for k in (5, 9, 10):
            for _ in range(3):
                n = int(rng.integers(50, 400))
                codes = jnp.asarray(rng.integers(0, 4**k, n).astype(np.int32))
                valid = jnp.asarray(rng.random(n) < 0.9)
                a = _node_table_dense(codes, valid, k, 256)
                b = _node_table_sorted(codes, valid, k, 256)
                assert int(a[2]) == int(b[2])
                m = min(int(a[2]), 256)
                np.testing.assert_array_equal(
                    np.asarray(a[0])[:m], np.asarray(b[0])[:m])
                np.testing.assert_array_equal(
                    np.asarray(a[1])[:m], np.asarray(b[1])[:m])

    def test_scatter_by_rank_accumulates(self):
        from genomeassembler_dev.ops.mxu import scatter_by_rank_mxu

        rng = np.random.default_rng(12)
        rank = rng.integers(0, 64, 500).astype(np.int32)
        mask = rng.random(500) < 0.8
        w = rng.integers(0, 4, 500).astype(np.int32)  # sums stay < 256
        (got,) = scatter_by_rank_mxu(
            jnp.asarray(rank), jnp.asarray(mask), (jnp.asarray(w),), 64)
        want = np.bincount(rank[mask], weights=w[mask], minlength=64)
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_dedup_with_counts_matches_numpy(self):
        from genomeassembler_dev.ops.dedup import (
            dedup_with_counts, pack_read_codes, unpack_kmer_windows)

        rng = np.random.default_rng(5)
        reads = rng.integers(0, 4, (300, 12)).astype(np.uint8)
        reads[::7] = reads[3]  # force duplicates
        valid = rng.random(300) < 0.9
        packed = pack_read_codes(jnp.asarray(reads), jnp.asarray(valid))
        codes, counts, n = dedup_with_counts(packed, 512)
        uq, cnt = np.unique(np.asarray(pack_read_codes(
            jnp.asarray(reads), jnp.asarray(valid)))[valid], return_counts=True)
        assert int(n) == uq.size
        np.testing.assert_array_equal(np.asarray(codes)[: uq.size], uq)
        np.testing.assert_array_equal(np.asarray(counts)[: uq.size], cnt)

        # window codes from packed reads == window codes from base arrays
        from genomeassembler_dev.ops.windows import kmer_window_codes
        w_direct, _ = kmer_window_codes(jnp.asarray(reads), 8)
        w_packed = unpack_kmer_windows(pack_read_codes(
            jnp.asarray(reads), jnp.ones(300, bool)), 12, 8)
        np.testing.assert_array_equal(np.asarray(w_direct), np.asarray(w_packed))

    def test_pack_read_codes_rejects_non_acgt(self):
        # an N (code 255) anywhere in the read must invalidate the whole
        # read — masking with & 3 would silently alias it to T
        from genomeassembler_dev.ops.dedup import _SENTINEL, pack_read_codes

        reads = np.zeros((3, 12), np.uint8)
        reads[1, 9] = 255  # N past the first octamer
        reads[2, 0] = 4
        packed = np.asarray(pack_read_codes(
            jnp.asarray(reads), jnp.ones(3, bool)))
        assert packed[0] == 0
        assert packed[1] == int(_SENTINEL) and packed[2] == int(_SENTINEL)

    def test_weighted_count_equals_expanded_count(self):
        # counting distinct reads' windows weighted by multiplicity must
        # equal counting every read's windows (the bench-path contract)
        from genomeassembler_dev.ops.dedup import (
            dedup_with_counts, pack_read_codes, unpack_kmer_windows)
        from genomeassembler_dev.ops.mxu import bincount_mxu, count_kmers_mxu

        rng = np.random.default_rng(6)
        reads = rng.integers(0, 4, (400, 12)).astype(np.uint8)
        reads[::3] = reads[5]
        valid = jnp.ones(400, bool)
        full, fv = kmer_window_codes(jnp.asarray(reads), 8)
        want = np.asarray(count_kmers_mxu(full.reshape(-1), fv.reshape(-1), 8))

        packed = pack_read_codes(jnp.asarray(reads), valid)
        codes, counts, n = dedup_with_counts(packed, 512)
        wins = unpack_kmer_windows(codes, 12, 8)  # [512, 5]
        ok = (jnp.arange(512) < n)[:, None] & jnp.ones((1, 5), bool)
        got = np.asarray(bincount_mxu(
            wins.reshape(-1), ok.reshape(-1), 4**8,
            jnp.broadcast_to(counts[:, None], (512, 5)).reshape(-1)))
        np.testing.assert_array_equal(got, want)
