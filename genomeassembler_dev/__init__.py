"""genomeassembler_dev — a de novo genome assembly framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
SahakyanLab/GenomeAssembler_dev (reference layout: lib/GenerateReads.R,
lib/DeNovoAssembler.R, lib/DeNovoAssembler.cpp, lib/BreakageScorer.cpp):

* simulate ultrasonication-biased NGS reads from genome segments, weighted by
  per-position octamer breakage probability (ref: lib/GenerateReads.R:235-484),
* assemble reads into contigs with a weighted de Bruijn graph
  (ref: lib/DeNovoAssembler.cpp:85-206),
* merge shuffled contig orderings greedily into candidate solutions
  (ref: lib/DeNovoAssembler.cpp:214-305),
* score every solution by breakage probability, Kolmogorov-Smirnov statistic
  and Levenshtein distance (ref: lib/DeNovoAssembler.cpp:316-477,
  lib/DeNovoAssembler.R:318-479).

Unlike the reference (single-threaded R + Rcpp/C++17), the compute path here is
2-bit-packed integer k-mer math on the accelerator (an NVIDIA H100): dense
QueryTable lookups, sort/segment de Bruijn graph construction, batched
exact-match scoring, and a Myers bit-vector edit distance (a CUDA kernel),
with jax.sharding meshes for multi-device scale-out. The branchy
per-ordering merge fixpoint runs in a multithreaded C++ native engine (also
the single-core baseline for benchmarks).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compile cache. JAX reads JAX_COMPILATION_CACHE_DIR itself; when
# it is unset the cache lives at a fixed path inside the checkout (the path
# is part of the cache key, so it must not move between runs).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from genomeassembler_dev.core import encoding, kmers, querytable  # noqa: F401
