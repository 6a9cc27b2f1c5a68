"""On-card correctness lane: device-compiled programs vs the native engine
and the spec. Run on a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda pytest tests/ -q -m gpu

Elsewhere every test skips (the `gpu_only` fixture decides at run time).
chip_smoke.py runs the same comparisons at the study's real shapes.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.sim.segments import synthetic_genome
from genomeassembler_dev.spec import reference_semantics as spec

pytestmark = pytest.mark.gpu

G = synthetic_genome(42, 400)


def test_dense_dbg_walk_matches_native_and_spec(gpu_only):
    from genomeassembler_dev.dbg.assemble import contigs_from_read_codes
    from genomeassembler_dev.merge import native

    reads = [G[i : i + 12] for i in range(0, 388, 3)]
    codes = np.stack([encode_dna(r) for r in reads])
    got = contigs_from_read_codes(codes, np.ones(len(reads), bool), 9, 800)
    assert native.available()
    assert got == native.contigs_from_reads_native(reads, 9)
    assert got == spec.get_contig_set(
        [r[i : i + 9] for r in reads for i in range(len(r) - 8)], 9)


def test_levenshtein_matches_spec(gpu_only):
    from genomeassembler_dev.ops.edit_distance import batched_levenshtein_auto

    tgt = synthetic_genome(7, 700)
    qs = [synthetic_genome(100 + i, 300) for i in range(8)] + [tgt[50:350]]
    qm = np.zeros((len(qs), 300), np.uint8)
    for i, q in enumerate(qs):
        qm[i] = encode_dna(q)
    ql = np.full(len(qs), 300, np.int32)
    for mode in ("NW", "HW"):
        got = np.asarray(batched_levenshtein_auto(
            jnp.asarray(qm), jnp.asarray(ql), jnp.asarray(encode_dna(tgt)),
            mode=mode))
        assert got.tolist() == [spec.levenshtein(q, tgt, mode=mode) for q in qs]


def test_breakscore_matches_spec(gpu_only):
    from genomeassembler_dev.pipeline.assembler import pack_strings, pad_reads
    from genomeassembler_dev.score.breakscore import breakscore
    from genomeassembler_dev.sim.reads import dedup_reads

    table = load_default_query_table()
    paths = [G, G[:250], G[100:]]
    reads = [G[i : i + 12] for i in range(0, 380, 7)]
    pm, pl = pack_strings(paths, s_multiple=8, l_multiple=128)
    uq, ct = dedup_reads(np.stack([encode_dna(r) for r in reads]),
                         np.ones(len(reads), bool))
    rc, rn, rv = pad_reads(uq, ct, 128)
    bs = breakscore(jnp.asarray(pm), jnp.asarray(pl), jnp.asarray(rc),
                    jnp.asarray(rn), jnp.asarray(rv),
                    jnp.asarray(table.combined, jnp.float32))
    want = spec.calc_breakscore(paths, reads, G, 8, table)
    np.testing.assert_allclose(np.asarray(bs.bp_score)[:3], want["bp_score"],
                               rtol=2e-5)
    np.testing.assert_array_equal(np.asarray(bs.kmer_breaks)[:3],
                                  want["kmer_breaks"])


def test_biased_traversal_walks_only_read_kmers(gpu_only):
    from genomeassembler_dev.dbg.assemble import dedup_contigs
    from genomeassembler_dev.dbg.biased import biased_contigs_sparse
    from genomeassembler_dev.ops.windows import kmer_window_codes

    k = 13
    reads = [G[j : j + 20] for j in range(0, 380, 2)]
    kc, kv = kmer_window_codes(
        jnp.asarray(np.stack([encode_dna(r) for r in reads])), k)
    probs8 = jnp.asarray(load_default_query_table().probs[8], jnp.float32)
    out = biased_contigs_sparse(kc, kv, probs8, k, 500, 64, node_cap=512)
    got = dedup_contigs(np.asarray(out[0]), np.asarray(out[1]),
                        np.asarray(out[2]), np.asarray(out[3]) & False)
    kset = {r[i : i + k] for r in reads for i in range(20 - k + 1)}
    assert got and all(c[i : i + k] in kset
                       for c in got for i in range(len(c) - k + 1))
