"""Golden tests for the mt19937 / std::shuffle replay against the platform
libstdc++, compiled with g++ on the fly. This is the same toolchain family the
reference's Rcpp build uses on Linux, so matching orderings here means matching
the reference binary's contig shuffles."""

import shutil
import subprocess
import tempfile
import os

import numpy as np
import pytest

from genomeassembler_dev.core.rng import (
    MT19937,
    UniformIntDistribution,
    _mt_refill_exact,
    shuffle_orderings,
    std_shuffle,
)

HAVE_GXX = shutil.which("g++") is not None

PROBE = r"""
#include <cstdio>
#include <random>
#include <vector>
#include <algorithm>
#include <numeric>
#include <cstdlib>

int main(int argc, char** argv) {
    unsigned seed = std::atoi(argv[1]);
    int mode = std::atoi(argv[2]);
    std::mt19937 eng(seed);
    if (mode == 0) {                     // raw engine outputs
        int n = std::atoi(argv[3]);
        for (int i = 0; i < n; i++) std::printf("%u\n", (unsigned)eng());
    } else if (mode == 1) {              // uniform_int_distribution draws
        int n = std::atoi(argv[3]);
        long b = std::atol(argv[4]);
        std::uniform_int_distribution<unsigned long> d(0, b);
        for (int i = 0; i < n; i++) std::printf("%lu\n", d(eng));
    } else {                             // sequential shuffles, shared engine
        int n = std::atoi(argv[3]);
        int reps = std::atoi(argv[4]);
        for (int r = 0; r < reps; r++) {
            std::vector<int> v(n);
            std::iota(v.begin(), v.end(), 0);
            std::shuffle(v.begin(), v.end(), eng);
            for (int i = 0; i < n; i++) std::printf("%d%c", v[i], i+1==n?'\n':' ');
        }
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def probe_bin():
    if not HAVE_GXX:
        pytest.skip("g++ unavailable")
    d = tempfile.mkdtemp(prefix="rngprobe")
    src = os.path.join(d, "probe.cpp")
    binp = os.path.join(d, "probe")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run(["g++", "-O2", "-o", binp, src], check=True)
    yield binp
    shutil.rmtree(d, ignore_errors=True)


def run_probe(probe_bin, *args):
    out = subprocess.run(
        [probe_bin] + [str(a) for a in args], check=True, capture_output=True, text=True
    )
    return out.stdout.strip().splitlines()


def test_refill_matches_sequential_reference():
    eng = MT19937(1234)
    state0 = eng._state.copy()
    expect = _mt_refill_exact(state0)
    eng._refill()
    assert np.array_equal(eng._state, expect)


@pytest.mark.parametrize("seed", [1234, 0, 5489, 987654321])
def test_engine_outputs(probe_bin, seed):
    golden = [int(x) for x in run_probe(probe_bin, seed, 0, 1500)]
    eng = MT19937(seed)
    ours = [eng.next_u32() for _ in range(1500)]
    assert ours == golden


@pytest.mark.parametrize("b", [1, 2, 9, 41, 9999, 123456789, 2**31, 2**32 - 2])
def test_uniform_int_distribution(probe_bin, b):
    golden = [int(x) for x in run_probe(probe_bin, 1234, 1, 200, b)]
    eng = MT19937(1234)
    ours = [UniformIntDistribution.draw(eng, b) for _ in range(200)]
    assert ours == golden


@pytest.mark.parametrize("n,reps", [(1, 3), (2, 5), (3, 5), (7, 20), (8, 20), (41, 10), (100, 5)])
def test_std_shuffle(probe_bin, n, reps):
    golden = [[int(x) for x in line.split()] for line in run_probe(probe_bin, 1234, 2, n, reps)]
    ours = shuffle_orderings(n, reps, 1234)
    assert ours.tolist() == golden


def test_shuffle_orderings_shape():
    perms = shuffle_orderings(10, 50, 7)
    assert perms.shape == (50, 10)
    for row in perms:
        assert sorted(row.tolist()) == list(range(10))


def test_std_shuffle_list_inplace():
    eng = MT19937(42)
    v = list(range(5))
    std_shuffle(v, eng)
    assert sorted(v) == list(range(5))
