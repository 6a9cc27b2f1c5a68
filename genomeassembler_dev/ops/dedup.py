"""On-device read dedup with multiplicities, for short packed reads.

The reference dedups reads into a read -> count hash map before scoring
(lib/DeNovoAssembler.cpp:333-337); the same dedup pays off much earlier on
the device: per-segment read sets are heavily duplicated (coverage 40x of a
short segment), and every downstream histogram / graph build scales with the
number of *distinct* reads. A read of length <= 15 packs into one int32
(2 bits/base), so dedup is: sort the packed codes, mark group starts, count
group sizes with a one-hot matmul bincount over group ranks, and compact the
distinct codes with the rank-histogram compaction — no hash maps, no
scatters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from genomeassembler_dev.ops.mxu import bincount_mxu, compact_by_rank_mxu

# plain int, NOT a jnp scalar: this module can be imported lazily from
# inside a jit trace (pipeline/batch_runner), where jnp constant creation
# would be staged and leak a tracer into module state
_SENTINEL = 2**30


def pack_read_codes(codes: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Pack base codes [..., N, R] (R <= 15) big-endian into int32 [..., N].

    Invalid reads (valid False) map to a sentinel that sorts after every
    packed read. Reads containing non-ACGT codes (> 3) are treated as
    invalid here — masking them with `& 3` would silently alias N to T."""
    R = codes.shape[-1]
    if R > 15:
        raise ValueError(f"read length {R} > 15 does not fit an int32 pack")
    shifts = jnp.arange(R - 1, -1, -1, dtype=jnp.int32) * 2
    packed = ((codes.astype(jnp.int32) & 3) << shifts).sum(axis=-1)
    valid = valid & (codes <= 3).all(axis=-1)
    return jnp.where(valid, packed, _SENTINEL)


def unpack_kmer_windows(packed: jnp.ndarray, read_len: int, k: int):
    """All k-length window codes of packed reads: [..., U] -> [..., U, W].

    Equivalent to ops.windows.kmer_window_codes on the unpacked bases, but
    O(W) shifts on one word instead of O(k*W) byte ops."""
    W = read_len - k + 1
    if W <= 0:
        raise ValueError(f"read length {read_len} shorter than k={k}")
    mask = jnp.int32((1 << (2 * k)) - 1)
    shifts = jnp.arange(W - 1, -1, -1, dtype=jnp.int32) * 2
    return (packed[..., None] >> shifts) & mask


@partial(jax.jit, static_argnames=("cap",))
def dedup_with_counts(packed: jnp.ndarray, cap: int):
    """Distinct packed reads (ascending) with multiplicities.

    packed: [N] int32 (sentinel-padded, see pack_read_codes). cap: power of
    two >= expected distinct count. Returns (codes [cap] int32 ascending
    0-padded, counts [cap] int32, n_unique) — entries past min(n_unique, cap)
    are zero; callers must check n_unique <= cap and retry larger if not.
    """
    s = jnp.sort(packed)
    ok = s < _SENTINEL
    uniq = ok & jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    # group index of every element = rank of its group start
    grp = (jnp.cumsum(uniq) - 1).astype(jnp.int32)
    counts = bincount_mxu(grp, ok, cap).astype(jnp.int32)
    limbs = tuple((s >> sh) & 255 for sh in range(0, 32, 8))
    compacted, n_unique = compact_by_rank_mxu(uniq, limbs, cap)
    codes = sum(c << (8 * i) for i, c in enumerate(compacted))
    return codes, counts, n_unique
