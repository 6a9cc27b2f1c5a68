"""Sequence-parallel (ring) Levenshtein distance.

For truth sequences far beyond one chip's comfort (the velvet-scale 50 kb
segments and beyond), the DP row is sharded across devices: each shard owns a
contiguous slice of the query dimension. The row recurrence

    c[0] = row boundary,  c[j] = min(dp[j] + 1, dp[j-1] + sub_j)
    dp_new[j] = min_{l <= j} (c[l] - l) + j

is an associative prefix-min, so a shard needs exactly two scalars from its
left neighbour per row:

    b_in = previous row's dp at the neighbour's last column  (for c's dp[j-1])
    k_in = min over all columns left of this shard of (c[l] - l)

Rows run as a software-pipelined wavefront: at step t, shard s processes row
t - s; both scalars move one ring hop per step with lax.ppermute (b_in is the
value the neighbour computed two steps ago, so each shard holds its previous
row's boundary for one step before sending). Total steps = n_rows + n_shards,
each doing [B, M/n_shards] vector work per shard (SURVEY.md §5's
long-context plan).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from genomeassembler_dev.ops.edit_distance import (
    MSB, build_peq, myers_column, score_bit)

BIG = np.int32(1 << 28)


def make_ring_levenshtein_myers(mesh: Mesh, axis: str = "read", mode: str = "NW"):
    """Myers bit-vector variant of the ring: the query dimension is sharded
    as 32-bit words (local slice must be a multiple of 32), each shard runs
    the single-device column update `ops.edit_distance.myers_column`
    (hin/hout chain resolved by a log2(W) prefix of 2-state map
    compositions) with its word-0 boundary taken from the left neighbour,
    and the ONLY
    cross-shard traffic is one horizontal-delta trit in {-1,0,+1} per query
    per wavefront step — vs two DP scalars and 32x the vector work for the
    prefix-min ring above. Returns fn(queries [B, M], query_lens [B],
    target [N]) -> [B] int32.
    """
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    n_shard = mesh.shape[axis]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(queries, query_lens, target):
        s = jax.lax.axis_index(axis)
        is_first = s == 0
        B, Ml = queries.shape
        if Ml % 32:
            raise ValueError(f"local query slice {Ml} not a multiple of 32")
        Wl = Ml // 32
        N = target.shape[0]
        qlen = query_lens.astype(jnp.int32)

        peq = build_peq(queries, Wl)  # local Peq [4, B, Wl]

        base = s * Ml
        qm1 = jnp.maximum(qlen - 1, 0)
        owner = (qm1 >= base) & (qm1 < base + Ml)  # [B]
        wstar = jnp.clip((qm1 - base) >> 5, 0, Wl - 1)
        bstar = ((qm1 - base) & 31).astype(jnp.uint32)
        sel_w = (jnp.arange(Wl, dtype=jnp.int32)[None, :] == wstar[:, None]) \
            & owner[:, None]
        perm = [(i, (i + 1) % n_shard) for i in range(n_shard)]

        VP0 = jnp.full((B, Wl), 0xFFFFFFFF, jnp.uint32)
        VN0 = jnp.zeros((B, Wl), jnp.uint32)
        best0 = jnp.where(owner, qlen, BIG)

        def step(carry, t):
            VP, VN, score, best, hin_in = carry
            i = t - s
            active = (i >= 1) & (i <= N)
            tc = target[jnp.clip(i - 1, 0, N - 1)].astype(jnp.int32)

            # shard 0's boundary: NW hin=+1, HW hin=0; else the ring trit
            hneg0 = jnp.where(is_first, False, hin_in < 0)  # [B]
            hpos0 = jnp.where(is_first, mode == "NW", hin_in > 0)
            VP_new, VN_new, HP, HN = myers_column(VP, VN, peq[tc], hneg0, hpos0)
            VP = jnp.where(active, VP_new, VP)
            VN = jnp.where(active, VN_new, VN)

            score = score + jnp.where(active & score_bit(HP, sel_w, bstar), 1, 0) \
                          - jnp.where(active & score_bit(HN, sel_w, bstar), 1, 0)
            row_end = jnp.where(owner, score, BIG)
            if mode == "HW":
                best = jnp.where(active, jnp.minimum(best, row_end), best)
            else:
                best = jnp.where(active, row_end, best)

            hout = ((HP[:, -1] & MSB) != 0).astype(jnp.int32) \
                - ((HN[:, -1] & MSB) != 0).astype(jnp.int32)
            hin_next = jax.lax.ppermute(
                jnp.where(active, hout, 0), axis, perm)
            return (VP, VN, score, best, hin_next), None

        init = (VP0, VN0, qlen, best0, jnp.zeros((B,), jnp.int32))
        (VP, VN, score, best, _), _ = jax.lax.scan(
            step, init, jnp.arange(1, N + n_shard + 1))
        return jax.lax.pmin(best, axis)

    def fn(queries, query_lens, target):
        res = run(queries, query_lens, target)
        empty = query_lens.astype(jnp.int32) <= 0
        return jnp.where(empty, 0 if mode == "HW" else target.shape[0], res)

    return fn


def make_ring_levenshtein(mesh: Mesh, axis: str = "read", mode: str = "NW"):
    """Returns fn(queries [B, M], query_lens [B], target [N]) -> [B] int32,
    with the query dimension M sharded over `axis` (M divisible by its size).
    """
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    n_shard = mesh.shape[axis]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(queries, query_lens, target):
        s = jax.lax.axis_index(axis)
        is_first = s == 0
        B, Ml = queries.shape  # local slice of the query dimension
        N = target.shape[0]
        q = queries.astype(jnp.int32)
        qlen = query_lens.astype(jnp.int32)
        jcol = jnp.broadcast_to(
            s * Ml + 1 + jnp.arange(Ml, dtype=jnp.int32), (B, Ml)
        )
        at_end = jcol == qlen[:, None]
        in_range = jcol <= qlen[:, None]

        dp0 = jnp.where(in_range, jcol, BIG)
        best0 = jnp.where(at_end, dp0, BIG).min(axis=1)
        perm = [(i, (i + 1) % n_shard) for i in range(n_shard)]

        def boundary_dp(i):  # dp_{i}[0]
            return jnp.int32(0) if mode == "HW" else i

        def step(carry, t):
            dp, held_last, best, b_in, k_in = carry
            i = t - s  # 1-based row this shard processes now
            active = (i >= 1) & (i <= N)
            t_char = target[jnp.clip(i - 1, 0, N - 1)]
            sub = (q != t_char).astype(jnp.int32)

            # shard 0's left-neighbour values are the row boundaries
            b0 = jnp.full((B,), 1, jnp.int32) * boundary_dp(i - 1)
            k0 = jnp.full((B,), 1, jnp.int32) * (
                jnp.int32(0) if mode == "HW" else i
            )  # c[0] - 0
            b_use = jnp.where(is_first, b0, b_in)
            k_use = jnp.where(is_first, k0, k_in)

            dp_left = jnp.concatenate([b_use[:, None], dp[:, :-1]], axis=1)
            c = jnp.minimum(dp + 1, dp_left + sub)
            y = c - jcol
            y_scan = jax.lax.cummin(y, axis=1)
            dp_new = jnp.minimum(y_scan, k_use[:, None]) + jcol
            dp_new = jnp.where(in_range, dp_new, BIG)
            carry_out = jnp.minimum(k_use, y_scan[:, -1])

            dp = jnp.where(active, dp_new, dp)
            row_end = jnp.where(at_end, dp_new, BIG).min(axis=1)
            if mode == "HW":
                best = jnp.where(active, jnp.minimum(best, row_end), best)
            else:
                best = jnp.where(active, row_end, best)

            # send: previous row's boundary (held one step), this row's carry
            b_next = jax.lax.ppermute(held_last, axis, perm)
            k_next = jax.lax.ppermute(
                jnp.where(active, carry_out, jnp.full((B,), BIG)), axis, perm
            )
            held_last = jnp.where(active, dp_new[:, -1], held_last)
            return (dp, held_last, best, b_next, k_next), None

        init = (
            dp0,
            dp0[:, -1],  # row 0 boundary to hand to the right neighbour
            best0,
            jnp.full((B,), BIG),
            jnp.full((B,), BIG),
        )
        (dp, _, best, _, _), _ = jax.lax.scan(
            step, init, jnp.arange(1, N + n_shard + 1)
        )
        return jax.lax.pmin(best, axis)

    return run
