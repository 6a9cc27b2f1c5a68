"""Executable specification of the reference pipeline semantics.

Pure-Python, string-level implementations of the reference's C++ kernels,
written directly from their documented behaviour (SURVEY.md §2-3, with
file:line citations in each function). These are the oracles that the
JAX and native C++ implementations are tested against; they are not used
on the production path.
"""

from genomeassembler_dev.spec.reference_semantics import (  # noqa: F401
    assemble_solutions,
    calc_breakscore,
    get_contig_set,
    ks_2samp,
    levenshtein,
    merge_one_ordering,
)
