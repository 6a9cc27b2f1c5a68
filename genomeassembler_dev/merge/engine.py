"""Solution assembly: shuffled ordering ensemble -> merged, deduplicated,
canonically sorted solution list.

Semantics follow the reference exactly (10,000 orderings own path, 20,000
velvet path; lib/DeNovoAssembler.cpp:194-305, lib/BreakageScorer.cpp:79-174)
with one documented divergence: the reference's final length sort is
std::sort (unstable), so its equal-length tie order is unspecified; we order
ties lexicographically. The solution *set* is bit-identical.

Backend dispatch ("auto") follows the native/device crossover measured on
the design's first accelerator (the threaded native engine below ~64
contigs, the one-jit device ensemble above; untuned for the H100, ROADMAP
S5), so auto picks the device path on an accelerator backend at large
contig counts and native otherwise. Without the native engine auto falls
back to the spec merge and says so on stderr.
"""

from __future__ import annotations

import sys

from genomeassembler_dev.merge import native
from genomeassembler_dev.spec import reference_semantics as spec

_warned_spec = False


def preferred_backend(
    n_contigs: int,
    n_orderings: int,
    native_ok: bool,
    accelerator_ok: bool,
) -> str:
    """Crossover backend choice: device at C >= 128 for any ordering count,
    and already at C >= 64 for the production 10k-ordering ensemble; below
    that the native threaded engine."""
    device_wins = n_contigs >= 128 or (n_contigs >= 64 and n_orderings >= 10000)
    if accelerator_ok and device_wins:
        return "device"
    if native_ok:
        return "native"
    return "device" if accelerator_ok and n_contigs >= 32 else "spec"


def _accelerator_ok() -> bool:
    try:
        import jax

        return jax.default_backend() != "cpu"
    except Exception:
        return False


def assemble_solutions(
    contigs: list[str],
    dbg_kmer: int,
    seed: int,
    n_orderings: int = 10000,
    backend: str = "auto",
    n_threads: int | None = None,
) -> list[str]:
    """Merge the shuffled ordering ensemble of `contigs` into solutions,
    sorted by (-length, lexicographic)."""
    global _warned_spec
    if backend == "auto":
        backend = preferred_backend(
            len(contigs), n_orderings, native.available(), _accelerator_ok()
        )
        if backend == "spec" and not _warned_spec:
            _warned_spec = True
            print(f"merge: native engine unavailable ({native.load_error}); "
                  "using the pure-Python spec merge", file=sys.stderr)
    if backend == "native":
        return native.assemble_native(contigs, dbg_kmer, seed, n_orderings, n_threads)
    if backend == "device":
        from genomeassembler_dev.merge.device import assemble_device

        return assemble_device(contigs, dbg_kmer, seed, n_orderings)
    if backend == "spec":
        orderings = spec.shuffled_orderings(contigs, seed, n_orderings)
        return spec.assemble_solutions(orderings, dbg_kmer)
    raise ValueError(f"unknown backend {backend!r}")
