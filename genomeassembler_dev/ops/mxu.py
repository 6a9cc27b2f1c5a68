"""Matmul-formulated irregular ops: histograms and gathers as matmuls.

The design comes from an accelerator whose scatter and gather ran
near-scalar while its matrix unit was fast (the `_mxu` suffix names that
matrix unit). Two classic reformulations make the framework's irregular ops
matmul-shaped:

  * histogram: split the bin index into (hi, lo) halves; then
        counts[hi, lo] = sum_i onehot_hi[i, hi] * onehot_lo[i, lo]
                       = onehot_hi^T @ onehot_lo
    — one [H, N] @ [N, L] matmul gives all 4^k bins. Exact in f32
    accumulation (counts are small integers).

  * permutation gather (for pointer-doubling on compacted node arrays):
        out[i, :] = vals[idx[i], :]  ==  onehot(idx) @ vals
    — an [M, M] @ [M, C] matmul. Exact for integer-valued f32 vals < 2^24.

Both build one-hots by iota comparison (cheap elementwise work) and put the
O(N*M) inner product on the matrix unit. Every operand is bf16-exact (0/1
one-hots, 8-bit limbs) with f32 accumulation, so no float32 contraction runs
in TF32 on the GPU. Whether these beat XLA's native scatter, gather and sort
on the H100 is not measured yet (ROADMAP S4).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _split_bits(total_bits: int) -> tuple[int, int]:
    hi = total_bits // 2
    return total_bits - hi, hi  # (hi_bits, lo_bits), hi >= lo


@partial(jax.jit, static_argnames=("nbins", "weight_bits"))
def bincount_mxu(
    idx: jnp.ndarray, valid: jnp.ndarray, nbins: int,
    weights: jnp.ndarray | None = None, weight_bits: int = 24,
) -> jnp.ndarray:
    """(Weighted) histogram over nbins power-of-two bins via one-hot matmul.

    idx: [..., N] int32 in [0, nbins); valid: same shape bool; weights
    (optional): same shape, non-negative integers < 2^weight_bits (each
    8-bit limb costs one matmul pass — pass a tight weight_bits when the
    caller knows the bound, e.g. 16 for per-segment read multiplicities).
    This is the one-hot matmul reformulation of a scatter-add (module
    docstring). Returns [..., nbins] float32 counts / weight sums
    (exact integers — 8-bit limbs keep every matmul input bf16-exact).
    """
    bits = nbins.bit_length() - 1
    assert (1 << bits) == nbins, "nbins must be a power of two"
    hi_bits, lo_bits = _split_bits(bits)
    H, L = 1 << hi_bits, 1 << lo_bits
    flat = idx.reshape(idx.shape[:-1] + (-1,))
    v = valid.reshape(flat.shape)

    hi = (flat >> lo_bits).astype(jnp.int32)
    lo = (flat & (L - 1)).astype(jnp.int32)
    iota_h = jnp.arange(H, dtype=jnp.int32)
    iota_l = jnp.arange(L, dtype=jnp.int32)
    oh_hi = (hi[..., None] == iota_h) & v[..., None]  # mask invalid rows
    oh_lo = (lo[..., None] == iota_l).astype(jnp.bfloat16)

    if weights is None:
        limbs = [(oh_hi.astype(jnp.bfloat16), 0)]
    else:
        w = weights.reshape(flat.shape).astype(jnp.int32)
        limbs = [
            (oh_hi.astype(jnp.bfloat16)
             * ((w >> s) & 255).astype(jnp.bfloat16)[..., None], s)
            for s in range(0, weight_bits, 8)  # 8-bit limbs
        ]
    counts = 0.0
    for oh_hi_w, shift in limbs:
        # HIGHEST precision: exact integer accumulation must not run in a
        # reduced-precision pass (sums can exceed bf16's 256 range)
        part = jnp.einsum(
            "...nh,...nl->...hl", oh_hi_w, oh_lo,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        counts = counts + part * float(1 << shift)
    return counts.reshape(idx.shape[:-1] + (H * L,))


@partial(jax.jit, static_argnames=("k",))
def count_kmers_mxu(codes: jnp.ndarray, valid: jnp.ndarray, k: int) -> jnp.ndarray:
    """Histogram of k-mer codes over all 4^k bins via one-hot matmul.

    codes: [..., N] int32 in [0, 4^k); valid: same shape bool.
    Returns [..., 4^k] float32 counts (exact integers).
    """
    return bincount_mxu(codes, valid, 4**k)


def dot_f32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Full-f32-accuracy matmul/dot: without it a float32 contraction may run
    in TF32 on the GPU's tensor cores (10-bit mantissa). Score dots compare at
    ~1e-5 relative tolerance, so force HIGHEST."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("size",))
def compact_by_rank_mxu(mask: jnp.ndarray, weights: tuple, size: int):
    """Stream compaction as a weighted histogram over rank bins (MXU).

    Gathers the values of each `weights[i]` at the True positions of `mask`,
    in ascending index order, into the front of a [size] array (0-padded) —
    the same contract as sorting (idx if mask else BIG) and slicing, but via
    two one-hot matmuls instead of a full sort.

    Formulation: rank = cumsum(mask)-1; split the output slot j = rank into
    (hi, lo) halves; then out[jhi, jlo] = sum_v onehot_hi[v]*w[v]*onehot_lo[v]
    = (onehot_hi * w)^T @ onehot_lo. Each weight value must be an integer in
    [0, 256) (bf16-exact limb) — pack wider values as 8-bit limbs and
    recombine. Entries with rank >= size are dropped (caller checks n_true).

    mask: [V] bool; weights: tuple of [V] int arrays in [0, 256); size must
    be a power of two. Returns (list of [size] int32 arrays, n_true).
    """
    bits = size.bit_length() - 1
    assert (1 << bits) == size, "size must be a power of two"
    lo_bits = bits // 2
    H, L = size >> lo_bits, 1 << lo_bits
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    jhi = rank >> lo_bits
    jlo = rank & (L - 1)
    oh_lo = (jlo[:, None] == jnp.arange(L, dtype=jnp.int32)).astype(jnp.bfloat16)
    base_hi = (jhi[:, None] == jnp.arange(H, dtype=jnp.int32)) & mask[:, None]
    # NB: keep one dot per weight — XLA fuses each one-hot construction into
    # its dot operand read; stacking the weights into one [V, W*H] operand
    # materializes it in device memory (slower on the accelerator this was
    # written for; not re-measured on the H100)
    outs = []
    for w in weights:
        oh_hi_w = base_hi.astype(jnp.bfloat16) * w.astype(jnp.bfloat16)[:, None]
        # one-hot rows select exactly one (hi, lo) cell per active v, so each
        # output cell accumulates a single product — exact in bf16*bf16->f32
        out = jnp.einsum("vh,vl->hl", oh_hi_w, oh_lo,
                         preferred_element_type=jnp.float32)
        outs.append(out.reshape(size).astype(jnp.int32))
    return outs, mask.sum().astype(jnp.int32)


@partial(jax.jit, static_argnames=("size",))
def scatter_by_rank_mxu(rank: jnp.ndarray, mask: jnp.ndarray, weights: tuple,
                        size: int):
    """Sum each `weights[i]` into its `rank` bin via hi/lo one-hot matmuls.

    Generalizes compact_by_rank_mxu to caller-supplied ranks and per-weight
    accumulation: several active rows may share a rank, in which case their
    weights ADD (exact while every partial sum stays < 2^24 and each weight
    value is an integer in [0, 256)). rank: [V] int32 (rows with mask False
    or rank >= size are dropped); weights: tuple of [V] int arrays.
    Returns list of [size] int32 arrays."""
    bits = size.bit_length() - 1
    assert (1 << bits) == size, "size must be a power of two"
    lo_bits = bits // 2
    H, L = size >> lo_bits, 1 << lo_bits
    ok = mask & (rank < size)
    jhi = rank >> lo_bits
    jlo = rank & (L - 1)
    oh_lo = (jlo[:, None] == jnp.arange(L, dtype=jnp.int32)).astype(jnp.bfloat16)
    base_hi = (jhi[:, None] == jnp.arange(H, dtype=jnp.int32)) & ok[:, None]
    outs = []
    for w in weights:
        oh_hi_w = base_hi.astype(jnp.bfloat16) * w.astype(jnp.bfloat16)[:, None]
        out = jnp.einsum("vh,vl->hl", oh_hi_w, oh_lo,
                         preferred_element_type=jnp.float32)
        outs.append(out.reshape(size).astype(jnp.int32))
    return outs


def searchsorted_mxu(sorted_vals: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """searchsorted-left as a compare-sum: idx[i] = #{j : sorted[j] < q[i]}.

    Replaces binary-search gathers with one compare-and-reduce. Pad
    sorted_vals with +inf-like sentinels so padding never counts."""
    return (sorted_vals[None, :] < queries[:, None]).sum(
        axis=1, dtype=jnp.int32)


@jax.jit
def permutation_gather_mxu(vals: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """out[..., i, :] = vals[..., idx[i], :] via two-level one-hot matmul.

    vals: [..., M, C] float32 with integer values |v| < 2^24;
    idx:  [..., Q] int32 in [0, M). Returns [..., Q, C] float32 (exact).

    The naive formulation builds an [M, M] one-hot per gather — at the
    doubling walk's M=1024 that is 1M VPU compares per gather, and the
    one-hot construction (not the matmul) dominates. Splitting idx into
    (hi, lo) halves drops it to 2*M*sqrt(M) compares:
        tmp[i, l*C+c] = onehot_hi[i, :] @ vals.reshape(H, L*C)   (MXU)
        out[i, c]     = sum_l onehot_lo[i, l] * tmp[i, l, c]     (VPU)
    Exactness: onehot_hi rows are 0/1 bf16, vals cast to bf16 would round,
    so the matmul keeps vals in f32 with HIGHEST; the lo-selection is a
    masked f32 sum of already-exact rows.
    """
    *batch, M, C = vals.shape
    Q = idx.shape[-1]
    bits = M.bit_length() - 1
    if (1 << bits) != M:
        # fallback: single-level one-hot for non-power-of-two M
        iota = jnp.arange(M, dtype=jnp.int32)
        onehot = (idx[..., None] == iota).astype(jnp.bfloat16)
        return jnp.einsum(
            "...mk,...kc->...mc", onehot, vals.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    # NB: the balanced split was the fastest on the first accelerator —
    # shrinking L (to cut the [M, L*C] tmp) grows the [M, H] hi one-hot
    # (untuned for the H100)
    lo_bits = bits // 2
    H, L = M >> lo_bits, 1 << lo_bits
    hi = (idx >> lo_bits).astype(jnp.int32)
    lo = (idx & (L - 1)).astype(jnp.int32)
    oh_hi = (hi[..., None] == jnp.arange(H, dtype=jnp.int32)).astype(jnp.bfloat16)
    v2 = vals.reshape(*batch, H, L * C).astype(jnp.float32)
    tmp = jnp.einsum(
        "...mh,...hd->...md", oh_hi, v2,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    ).reshape(*batch, Q, L, C)
    oh_lo = (lo[..., None] == jnp.arange(L, dtype=jnp.int32)).astype(jnp.float32)
    return (tmp * oh_lo[..., None]).sum(axis=-2)
