"""Batched Levenshtein distance.

Replaces the reference's per-solution edlib calls
(lib/DeNovoAssembler.cpp:41-55 NW mode; lib/BreakageScorer.cpp:41-55 HW mode)
with a batched DP over all solutions at once. Three implementations with one
semantics:

* `batched_levenshtein` — the plain prefix-min DP, kept as the independent
  reference. The row recurrence

      dp_new[j] = min(dp[j] + 1, dp[j-1] + sub_j, dp_new[j-1] + 1)

  carries a sequential dependency on dp_new[j-1]. Setting
  c[j] = min(dp[j]+1, dp[j-1]+sub_j) (c[0] = row boundary), the solution is

      dp_new[j] = min_{l <= j} (c[l] + (j - l)) = cummin(c[j] - j) + j

  — one vectorised `cummin` per target row.
* `batched_levenshtein_myers` — Myers' bit-vector algorithm (Myers 1999,
  Hyyrö 2003 horizontal-delta form) in plain `jnp`: 32 DP cells per uint32
  word op, a `lax.scan` over target characters. `myers_column` is its
  per-column update and is shared with the sequence-parallel ring
  (ops/edit_distance_ring.py).
* the CUDA kernel in ops/myers_cuda.py, which runs the same update with the
  target loop and the bit-vector state kept on the SM.

`batched_levenshtein_auto` picks one of the last two for the backend and is
the only entry point the pipelines call.

Modes (edlib task naming):
  NW: global distance, answer dp_n[len_q].
  HW: infix — target prefix/suffix gaps free: row boundary 0, answer
      min over rows of dp_i[len_q].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalar: folds into traced code as a literal, not a captured array
MSB = np.uint32(0x80000000)
shr = jax.lax.shift_right_logical


@partial(jax.jit, static_argnames=("mode",))
def batched_levenshtein(
    queries: jnp.ndarray,  # [B, M] base codes (pad arbitrary)
    query_lens: jnp.ndarray,  # [B] int32
    target: jnp.ndarray,  # [N] base codes
    target_len: jnp.ndarray | int | None = None,
    mode: str = "NW",
) -> jnp.ndarray:
    """Edit distance of each query vs one shared target. Returns [B] int32.

    `target` may be padded; pass target_len for the true length (rows beyond
    it are skipped by masking their updates).
    """
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    B, M = queries.shape
    N = target.shape[0]
    if target_len is None:
        target_len = N
    target_len = jnp.asarray(target_len, dtype=jnp.int32)

    idx = jnp.arange(M + 1, dtype=jnp.int32)  # [M+1]
    dp0 = jnp.broadcast_to(idx, (B, M + 1)).astype(jnp.int32)
    q = queries.astype(jnp.int32)

    def row_step(carry, x):
        dp, best = carry
        t_char, i = x  # i is 1-based row index
        active = i <= target_len
        sub = (q != t_char).astype(jnp.int32)  # [B, M]
        c_mid = jnp.minimum(dp[:, 1:] + 1, dp[:, :-1] + sub)
        boundary = jnp.int32(0) if mode == "HW" else i
        c = jnp.concatenate(
            [jnp.full((B, 1), 0, dtype=jnp.int32) + boundary, c_mid], axis=1
        )
        dp_new = jax.lax.cummin(c - idx, axis=1) + idx
        dp = jnp.where(active, dp_new, dp)
        row_end = jnp.take_along_axis(dp, query_lens[:, None].astype(jnp.int32), axis=1)[:, 0]
        best = jnp.where(active, jnp.minimum(best, row_end), best)
        return (dp, best), None

    t = target.astype(jnp.int32)
    rows = jnp.arange(1, N + 1, dtype=jnp.int32)
    best0 = jnp.take_along_axis(dp0, query_lens[:, None].astype(jnp.int32), axis=1)[:, 0]
    (dp, best), _ = jax.lax.scan(row_step, (dp0, best0), (t, rows))
    if mode == "HW":
        return best.astype(jnp.int32)
    final = jnp.take_along_axis(dp, query_lens[:, None].astype(jnp.int32), axis=1)[:, 0]
    return final.astype(jnp.int32)


def build_peq(queries: jnp.ndarray, W: int) -> jnp.ndarray:
    """[B, M] base codes -> Peq [4, B, W] uint32: bit i of word w is set iff
    query position 32w+i holds that base (positions >= M match nothing)."""
    B, M = queries.shape
    q = jnp.pad(queries.astype(jnp.int32), ((0, 0), (0, W * 32 - M)),
                constant_values=255).reshape(B, W, 32)
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    return jnp.stack([
        ((q == c).astype(jnp.uint32) * weights).sum(-1, dtype=jnp.uint32)
        for c in range(4)
    ])


def myers_column(VP, VN, eq, hneg0, hpos0):
    """One target column of the multi-word Myers update over [B, W] words.

    hneg0 / hpos0 ([B] bool) are the sign of the horizontal delta entering
    word 0 from above (NW top row: +1; HW: 0; a ring shard: its neighbour's
    hout). The classic block algorithm chains words through that delta, but
    a word's hout depends on its hin only through the sign (hin < 0 sets Eq
    bit 0), so each word is a 2-state map and the chain resolves with a
    log2(W) prefix of map compositions; every word then updates at once.

    Returns (VP, VN, HP, HN): the new vertical deltas and the pre-shift
    horizontal deltas, whose bit at row qlen-1 moves the score.
    """
    W = VP.shape[1]

    def flow(EqV):
        D0 = (((EqV & VP) + VP) ^ VP) | EqV | VN
        HP = VN | ~(D0 | VP)
        HN = VP & D0
        return D0, HP, HN

    # both hypotheses for this column: hin >= 0 (Eq as-is), hin < 0 (Eq | 1)
    D0a, HPa, HNa = flow(eq)
    D0b, HPb, HNb = flow(eq | jnp.uint32(1))

    # A[w] / Bn[w]: hout sign of word w given hin sign False / True; after
    # the prefix they are the compositions of words 0..w
    A = (HNa & MSB) != 0
    Bn = (HNb & MSB) != 0
    iota_w = jnp.arange(W, dtype=jnp.int32)[None, :]
    for sft in [1 << p for p in range(max(1, (W - 1).bit_length()))]:
        valid = iota_w >= sft
        A_prev = jnp.roll(A, sft, axis=1) & valid
        B_prev = jnp.roll(Bn, sft, axis=1) & valid
        A, Bn = jnp.where(A_prev, Bn, A), jnp.where(B_prev, Bn, A)
    # hin sign of word w = hout sign of word w-1 (word 0: the boundary)
    hout_sign = jnp.where(hneg0[:, None], Bn, A)
    top = iota_w == 0
    sw = jnp.where(top, hneg0[:, None], jnp.roll(hout_sign, 1, axis=1))

    D0 = jnp.where(sw, D0b, D0a)
    HP = jnp.where(sw, HPb, HPa)
    HN = jnp.where(sw, HNb, HNa)

    # shifted-in bits: word w takes the MSB of word w-1 (word 0: boundary)
    hin_pos = jnp.where(top, hpos0[:, None], jnp.roll((HP & MSB) != 0, 1, axis=1))
    HPs = (HP << 1) | hin_pos.astype(jnp.uint32)
    HNs = (HN << 1) | sw.astype(jnp.uint32)
    return HNs | ~(D0 | HPs), HPs & D0, HP, HN


def score_bit(H, sel_w, bstar):
    """[B] bool: bit bstar of the word selected by sel_w ([B, W])."""
    return (((shr(H, bstar[:, None]) & 1) != 0) & sel_w).any(1)


@partial(jax.jit, static_argnames=("mode",))
def batched_levenshtein_myers(
    queries: jnp.ndarray,  # [B, M] base codes 0..3 (pad arbitrary)
    query_lens: jnp.ndarray,  # [B] int32
    target: jnp.ndarray,  # [N] base codes (exact length)
    mode: str = "NW",
) -> jnp.ndarray:
    """Plain-XLA Myers bit-vector edit distance. Returns [B] int32, equal to
    `batched_levenshtein` on ACGT codes."""
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    B, M = queries.shape
    W = max(1, -(-M // 32))
    peq = build_peq(queries, W)
    qlen = query_lens.astype(jnp.int32)
    qm1 = jnp.maximum(qlen - 1, 0)
    sel_w = jnp.arange(W, dtype=jnp.int32)[None, :] == (qm1 >> 5)[:, None]
    bstar = (qm1 & 31).astype(jnp.uint32)
    hneg0 = jnp.zeros((B,), bool)
    hpos0 = jnp.full((B,), mode == "NW")

    def step(carry, tc):
        VP, VN, score, best = carry
        eq = jnp.take(peq, tc, axis=0, mode="fill", fill_value=0)
        VP, VN, HP, HN = myers_column(VP, VN, eq, hneg0, hpos0)
        score = (score + score_bit(HP, sel_w, bstar).astype(jnp.int32)
                 - score_bit(HN, sel_w, bstar).astype(jnp.int32))
        return (VP, VN, score, jnp.minimum(best, score)), None

    init = (jnp.full((B, W), 0xFFFFFFFF, jnp.uint32),
            jnp.zeros((B, W), jnp.uint32), qlen, qlen)
    (_, _, score, best), _ = jax.lax.scan(step, init, target.astype(jnp.int32))
    res = best if mode == "HW" else score
    # empty queries: NW distance = target length, HW distance = 0
    return jnp.where(qlen <= 0, 0 if mode == "HW" else target.shape[0], res)


def levenshtein_impl():
    """The one Levenshtein implementation for the default backend: the CUDA
    kernel on a GPU, the plain-XLA Myers elsewhere."""
    if jax.default_backend() == "gpu":
        from genomeassembler_dev.ops.myers_cuda import batched_levenshtein_cuda

        return batched_levenshtein_cuda
    return batched_levenshtein_myers


def batched_levenshtein_auto(
    queries: jnp.ndarray,
    query_lens: jnp.ndarray,
    target: jnp.ndarray,
    mode: str = "NW",
) -> jnp.ndarray:
    """Edit distance of each query [B, M] vs one exact-length target [N]
    through `levenshtein_impl()`. Composes with jit, vmap and shard_map."""
    return levenshtein_impl()(queries, query_lens, target, mode=mode)
