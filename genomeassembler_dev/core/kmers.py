"""Integer k-mer math shared by host and device code.

All k <= 15 k-mers fit an int32 (2k bits); k <= 16 fits uint32. The dBG uses
dbg_kmer in 9..15 and breakage k-mers are 2..8, so int32 covers everything
(JAX runs without x64 by default).
"""

from __future__ import annotations

import numpy as np


def prefix_code(codes, k: int):
    """First (k-1)-mer of each k-mer code (ref: lib/DeNovoAssembler.cpp:99)."""
    return codes >> 2


def suffix_code(codes, k: int):
    """Last (k-1)-mer of each k-mer code (ref: lib/DeNovoAssembler.cpp:100)."""
    return codes & ((1 << (2 * (k - 1))) - 1)


def last_base(codes):
    """Final character of a k-mer code (ref: lib/DeNovoAssembler.cpp:183)."""
    return codes & 3


def leading_code(codes, k: int, j: int):
    """First j characters of each k-mer code (big-endian truncation)."""
    return codes >> (2 * (k - j))


def trailing_code(codes, j: int):
    """Last j characters of each k-mer code."""
    return codes & ((1 << (2 * j)) - 1)


def unique_sorted(codes: np.ndarray) -> np.ndarray:
    """Host sort+unique, the canonical dedup of the reference
    (ref: lib/DeNovoAssembler.cpp:62-71)."""
    return np.unique(np.asarray(codes))
