"""Ring (sequence-parallel) Levenshtein vs spec on the virtual mesh."""

import numpy as np
import pytest
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.ops.edit_distance_ring import make_ring_levenshtein
from genomeassembler_dev.parallel.mesh import make_mesh
from genomeassembler_dev.spec import reference_semantics as spec

# shard_map wavefront sweeps over the virtual mesh take tens of seconds per
# parametrization; the full matrix is full-lane only. test_ring_fast_smoke
# below keeps one ring compile+match in the fast lane.


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def test_ring_fast_smoke():
    """Fast-lane representative: one 2-shard NW ring vs spec on tiny shapes."""
    mesh = make_mesh(seg=1, read=2, tp=1)
    fn = make_ring_levenshtein(mesh, axis="read", mode="NW")
    rng = np.random.default_rng(3)
    target = rand_dna(rng, 40)
    M = 64 * 2
    queries = [rand_dna(rng, 25), target[:30], target]
    qmat = np.zeros((len(queries), M), np.uint8)
    qlen = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        qmat[i, : len(q)] = encode_dna(q)
    out = np.asarray(fn(jnp.asarray(qmat), jnp.asarray(qlen),
                        jnp.asarray(encode_dna(target))))
    assert out.tolist() == [spec.levenshtein(q, target, mode="NW")
                            for q in queries]


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["NW", "HW"])
@pytest.mark.parametrize("n_shard", [2, 4])
def test_matches_spec(mode, n_shard):
    mesh = make_mesh(seg=1, read=n_shard, tp=1)
    fn = make_ring_levenshtein(mesh, axis="read", mode=mode)
    rng = np.random.default_rng(0)
    target = rand_dna(rng, 75)
    M = 64 * n_shard  # shardable padded query length
    queries = [rand_dna(rng, int(rng.integers(1, M + 1))) for _ in range(6)]
    queries += [target[:50], target]
    qmat = np.zeros((len(queries), M), np.uint8)
    qlen = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        qmat[i, : len(q)] = encode_dna(q)
    out = np.asarray(fn(jnp.asarray(qmat), jnp.asarray(qlen),
                        jnp.asarray(encode_dna(target))))
    expect = [spec.levenshtein(q, target, mode=mode) for q in queries]
    assert out.tolist() == expect


@pytest.mark.slow
def test_matches_single_device_kernel():
    from genomeassembler_dev.ops.edit_distance import batched_levenshtein

    mesh = make_mesh(seg=1, read=8, tp=1)
    fn = make_ring_levenshtein(mesh, axis="read", mode="NW")
    rng = np.random.default_rng(1)
    target = rand_dna(rng, 200)
    M = 8 * 64
    qmat = rng.integers(0, 4, size=(5, M)).astype(np.uint8)
    qlen = rng.integers(M // 2, M + 1, size=5).astype(np.int32)
    ring = np.asarray(fn(jnp.asarray(qmat), jnp.asarray(qlen),
                         jnp.asarray(encode_dna(target))))
    single = np.asarray(batched_levenshtein(
        jnp.asarray(qmat), jnp.asarray(qlen), jnp.asarray(encode_dna(target))
    ))
    np.testing.assert_array_equal(ring, single)


@pytest.mark.slow
class TestMyersRing:
    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("n_shard", [2, 4])
    def test_matches_spec(self, mode, n_shard):
        from genomeassembler_dev.ops.edit_distance_ring import (
            make_ring_levenshtein_myers,
        )

        mesh = make_mesh(seg=1, read=n_shard, tp=1)
        fn = make_ring_levenshtein_myers(mesh, axis="read", mode=mode)
        rng = np.random.default_rng(0)
        target = rand_dna(rng, 75)
        M = 64 * n_shard
        queries = [rand_dna(rng, int(rng.integers(1, M + 1))) for _ in range(6)]
        queries += [target[:50], target, ""]
        qmat = np.zeros((len(queries), M), np.uint8)
        qlen = np.array([len(q) for q in queries], np.int32)
        for i, q in enumerate(queries):
            if q:
                qmat[i, : len(q)] = encode_dna(q)
        out = np.asarray(fn(jnp.asarray(qmat), jnp.asarray(qlen),
                            jnp.asarray(encode_dna(target))))
        expect = [spec.levenshtein(q, target, mode=mode) for q in queries]
        assert out.tolist() == expect

    def test_matches_prefix_min_ring(self):
        from genomeassembler_dev.ops.edit_distance_ring import (
            make_ring_levenshtein, make_ring_levenshtein_myers,
        )

        mesh = make_mesh(seg=1, read=8, tp=1)
        rng = np.random.default_rng(1)
        target = rand_dna(rng, 200)
        M = 8 * 64
        qmat = rng.integers(0, 4, size=(5, M)).astype(np.uint8)
        qlen = rng.integers(M // 2, M + 1, size=5).astype(np.int32)
        for mode in ("NW", "HW"):
            a = np.asarray(make_ring_levenshtein(mesh, "read", mode)(
                jnp.asarray(qmat), jnp.asarray(qlen),
                jnp.asarray(encode_dna(target))))
            b = np.asarray(make_ring_levenshtein_myers(mesh, "read", mode)(
                jnp.asarray(qmat), jnp.asarray(qlen),
                jnp.asarray(encode_dna(target))))
            np.testing.assert_array_equal(a, b)
