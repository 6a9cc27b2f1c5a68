"""Myers bit-vector Levenshtein: the plain-XLA version vs the spec, the
dispatch that picks the one implementation per backend, the CUDA kernel's
launch shapes (CPU), and the CUDA kernel itself (GPU lane)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.ops import edit_distance as ed
from genomeassembler_dev.ops.edit_distance import batched_levenshtein_myers
from genomeassembler_dev.ops.myers_cuda import MAX_QUERY_LEN, launch_config
from genomeassembler_dev.spec import reference_semantics as spec


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def pack(queries):
    M = max(1, max(len(q) for q in queries))
    qmat = np.zeros((len(queries), M), np.uint8)
    qlen = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        if q:
            qmat[i, : len(q)] = encode_dna(q)
    return jnp.asarray(qmat), jnp.asarray(qlen)


class TestMyersLevenshtein:
    @pytest.mark.parametrize("mode", ["NW", "HW"])
    def test_vs_spec(self, mode):
        rng = np.random.default_rng(0)
        target = rand_dna(rng, 90)
        queries = [rand_dna(rng, int(rng.integers(1, 120))) for _ in range(9)]
        queries += [target, target[10:40]]
        out = np.asarray(batched_levenshtein_myers(
            *pack(queries), jnp.asarray(encode_dna(target)), mode=mode))
        expect = [spec.levenshtein(q, target, mode=mode) for q in queries]
        assert out.tolist() == expect

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    def test_multiword_and_empty(self, mode):
        # query spanning several 32-bit words + empty-query edge case
        rng = np.random.default_rng(1)
        target = rand_dna(rng, 150)
        queries = [rand_dna(rng, 200), target + "ACGT" * 10, ""]
        out = np.asarray(batched_levenshtein_myers(
            *pack(queries), jnp.asarray(encode_dna(target)), mode=mode))
        expect = [spec.levenshtein(q, target, mode=mode) for q in queries]
        assert out.tolist() == expect


_TARGET = "".join(np.random.default_rng(2).choice(list("ACGT"), size=70))
_CASES = {
    "single-word": ["ACGTTGCA", _TARGET[3:30], _TARGET[:32]],
    "multi-word": [_TARGET[5:69], _TARGET + "ACGT" * 12,
                   "".join(np.random.default_rng(3).choice(list("ACGT"), 97))],
    "empty": ["", _TARGET[:1]],
    "longer-than-target": [_TARGET * 3, _TARGET[::-1] + _TARGET],
}


@pytest.mark.parametrize("mode", ["NW", "HW"])
@pytest.mark.parametrize("case", list(_CASES))
def test_plain_myers_vs_spec(case, mode):
    queries = _CASES[case]
    out = np.asarray(batched_levenshtein_myers(
        *pack(queries), jnp.asarray(encode_dna(_TARGET)), mode=mode))
    assert out.tolist() == [spec.levenshtein(q, _TARGET, mode=mode)
                            for q in queries]


def test_plain_myers_matches_prefix_min_under_vmap():
    """The batched runner vmaps the implementation over a group of
    segments, each with its own target."""
    rng = np.random.default_rng(4)
    targets = [rand_dna(rng, 60) for _ in range(3)]
    q, ql = pack([rand_dna(rng, int(n)) for n in rng.integers(0, 90, 5)])
    qs = jnp.stack([q] * 3)
    qls = jnp.stack([ql] * 3)
    ts = jnp.asarray(np.stack([encode_dna(t) for t in targets]))
    got = jax.vmap(lambda a, b, t: batched_levenshtein_myers(a, b, t))(qs, qls, ts)
    want = jax.vmap(lambda a, b, t: ed.batched_levenshtein(a, b, t))(qs, qls, ts)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_auto_and_sharded_runner_pick_the_same_implementation(monkeypatch):
    """batched_levenshtein_auto and the batched runner's mesh-sharded stage
    both route through levenshtein_impl() — one implementation per backend."""
    from jax.sharding import Mesh

    from genomeassembler_dev.pipeline import batch_runner

    calls = []

    def fake(queries, query_lens, target, mode="NW"):
        calls.append(mode)
        return batched_levenshtein_myers(queries, query_lens, target, mode=mode)

    monkeypatch.setattr(ed, "levenshtein_impl", lambda: fake)
    batch_runner._lev_jit.cache_clear()
    try:
        q, ql = pack(["ACGTAC", "GGT"])
        t = jnp.asarray(encode_dna("ACGTTAC"))
        a = np.asarray(ed.batched_levenshtein_auto(q, ql, t, mode="NW"))
        assert calls == ["NW"]
        mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1, 1),
                    ("seg", "read", "tp"))
        b = np.asarray(batch_runner._lev_jit(mesh)(
            jnp.stack([q, q]), jnp.stack([ql, ql]), jnp.stack([t, t])))
        assert calls == ["NW", "NW"]
        np.testing.assert_array_equal(b, np.stack([a, a]))
    finally:
        batch_runner._lev_jit.cache_clear()


def test_default_implementation_per_backend():
    impl = ed.levenshtein_impl()
    if jax.default_backend() == "gpu":
        from genomeassembler_dev.ops.myers_cuda import batched_levenshtein_cuda

        assert impl is batched_levenshtein_cuda
    else:
        assert impl is batched_levenshtein_myers


@pytest.mark.parametrize("width, expect", [
    (0, (1, 32)), (1, (1, 32)), (32, (1, 32)), (1024, (1, 32)),
    (1025, (1, 64)), (2048, (1, 64)), (32768, (1, 1024)),
    (32769, (2, 544)), (50000, (2, 800)), (100000, (4, 800)),
    (MAX_QUERY_LEN, (4, 1024)),
])
def test_cuda_launch_config(width, expect):
    wpt, threads = launch_config(width)
    assert (wpt, threads) == expect
    # the block holds every word of the widest query, in whole warps
    assert threads % 32 == 0 and threads * wpt * 32 >= width


def test_cuda_launch_config_rejects_too_wide():
    with pytest.raises(ValueError, match="exceeds"):
        launch_config(MAX_QUERY_LEN + 1)


@pytest.mark.gpu
class TestCudaKernel:
    """The compiled kernel on the card (JAX_PLATFORMS=cuda pytest -m gpu)."""

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", list(_CASES))
    def test_vs_spec(self, gpu_only, case, mode):
        from genomeassembler_dev.ops.myers_cuda import batched_levenshtein_cuda

        queries = _CASES[case]
        out = np.asarray(batched_levenshtein_cuda(
            *pack(queries), jnp.asarray(encode_dna(_TARGET)), mode=mode))
        assert out.tolist() == [spec.levenshtein(q, _TARGET, mode=mode)
                                for q in queries]

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("width", [1000, 2100, 40000, 100000])
    def test_vs_prefix_min(self, gpu_only, mode, width):
        from genomeassembler_dev.ops.myers_cuda import batched_levenshtein_cuda

        rng = np.random.default_rng(width)
        t = jnp.asarray(rng.integers(0, 4, 3000).astype(np.uint8))
        q = jnp.asarray(rng.integers(0, 4, (4, width)).astype(np.uint8))
        ql = jnp.asarray([width, width // 2, 1, 0], jnp.int32)
        got = batched_levenshtein_cuda(q, ql, t, mode=mode)
        want = ed.batched_levenshtein(q, ql, t, mode=mode)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_vmap_pairs_each_group_with_its_target(self, gpu_only):
        from genomeassembler_dev.ops.myers_cuda import batched_levenshtein_cuda

        rng = np.random.default_rng(5)
        qs = jnp.asarray(rng.integers(0, 4, (3, 6, 200)).astype(np.uint8))
        qls = jnp.asarray(rng.integers(0, 201, (3, 6)).astype(np.int32))
        ts = jnp.asarray(rng.integers(0, 4, (3, 150)).astype(np.uint8))
        got = jax.vmap(batched_levenshtein_cuda)(qs, qls, ts)
        want = jax.vmap(ed.batched_levenshtein)(qs, qls, ts)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
