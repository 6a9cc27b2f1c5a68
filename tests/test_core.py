import numpy as np
import pytest

from genomeassembler_dev.core import encoding as enc
from genomeassembler_dev.core import kmers, querytable


class TestEncoding:
    def test_roundtrip(self):
        s = "ACGTACGTTTGACA"
        assert enc.decode_dna(enc.encode_dna(s)) == s

    def test_invalid_marked(self):
        codes = enc.encode_dna("ACNGT")
        assert codes[2] == enc.INVALID
        with pytest.raises(ValueError):
            enc.decode_dna(codes)

    def test_kmer_code_lexicographic(self):
        # numeric order == lexicographic order
        ks = ["AAA", "AAC", "ACA", "CAA", "TTT"]
        vals = [enc.kmer_code(k) for k in ks]
        assert vals == sorted(vals)
        assert vals[0] == 0 and vals[-1] == 63

    def test_code_to_kmer_roundtrip(self):
        for s in ["A", "ACGT", "TTTTTTTT", "GATTACA"]:
            assert enc.code_to_kmer(enc.kmer_code(s), len(s)) == s

    def test_kmer_codes_np(self):
        codes = enc.encode_dna("ACGTA")
        out = enc.kmer_codes_np(codes, 3)
        expect = [enc.kmer_code(x) for x in ["ACG", "CGT", "GTA"]]
        assert out.tolist() == expect

    def test_kmer_codes_np_invalid_window(self):
        codes = enc.encode_dna("ACNTAG")
        out = enc.kmer_codes_np(codes, 3)
        # windows covering the N are -1; the final window TAG is valid
        assert out.tolist() == [-1, -1, -1, enc.kmer_code("TAG")]

    def test_reverse_complement(self):
        codes = enc.encode_dna("AACGT")
        assert enc.decode_dna(enc.reverse_complement(codes)) == "ACGTT"

    def test_pack_words(self):
        codes = enc.encode_dna("A" * 15 + "C")  # one word exactly
        w = enc.pack_words_np(codes)
        assert w.shape == (1,) and w[0] == 1
        codes17 = enc.encode_dna("A" * 16 + "T")
        w2 = enc.pack_words_np(codes17)
        # second word: T then 15 zero-pad chars -> 3 << 30
        assert w2.shape == (2,) and w2[0] == 0 and w2[1] == np.uint32(3 << 30)

    def test_prefix_suffix(self):
        k = 5
        code = enc.kmer_code("ACGTT")
        assert kmers.prefix_code(code, k) == enc.kmer_code("ACGT")
        assert kmers.suffix_code(code, k) == enc.kmer_code("CGTT")
        assert kmers.last_base(code) == enc.kmer_code("T")
        assert kmers.leading_code(code, k, 2) == enc.kmer_code("AC")
        assert kmers.trailing_code(code, 3) == enc.kmer_code("GTT")


class TestQueryTable:
    @pytest.fixture(scope="class")
    def table(self):
        return querytable.load_default_query_table()

    def test_normalisation(self, table):
        assert np.isclose(table.combined.sum(), 1.0)
        assert table.combined.shape == (querytable.TOTAL,)

    def test_offsets(self):
        sizes = [querytable.SIZES[k] for k in querytable.KS]
        offs = [querytable.OFFSETS[k] for k in querytable.KS]
        assert offs == [0, 16, 272, 4368]
        assert offs[-1] + sizes[-1] == querytable.TOTAL

    def test_lookup_known_value(self, table):
        # AAAAAAAA has raw value 1.26319886306088 in the reference asset;
        # after joint normalisation it is raw / total_raw_sum.
        code = 0
        p = table.probs[8][code]
        assert 0 < p < 1
        assert np.isclose(p, table.combined[querytable.OFFSETS[8] + code])

    def test_uniform(self):
        t = querytable.QueryTable.uniform()
        assert np.allclose(t.combined, 1.0 / querytable.TOTAL)
        assert np.isclose(t.combined.sum(), 1.0)

    def test_all_positive(self, table):
        assert (table.combined > 0).all()
