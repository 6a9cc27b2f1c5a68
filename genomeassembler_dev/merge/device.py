"""On-device shuffled-ensemble greedy merge.

The reference merges each of 10,000 shuffled contig orderings to fixpoint
with in-place string surgery (lib/DeNovoAssembler.cpp:214-305). The native
engine (merge/native.py) threads that loop; this module instead runs the
whole ensemble as ONE jit program, with the ordering dimension [O] as the
vector axis — every (k, i, j) scan step decides and applies the merge for
all orderings simultaneously.

Crossover: native wins at small contig counts because the sequential
pair-step latency dominates; the device ensemble scales better in C. On the
first accelerator the device path won from C=64 x O=10k and C=128; the H100
crossover is not measured yet (ROADMAP S5). merge.engine's "auto" backend
dispatches on that crossover; this path is also the determinism cross-check
(outputs set-identical to native/spec).

Representation per (ordering, slot):
  * alive, length;
  * pre16/suf16 — the first/last 16 bases packed (contigs are always longer
    than the overlap k <= dbg_kmer-1 <= 15, and an absorb keeps the head's
    prefix and takes the absorbed chain's suffix), giving O(1) suffix_k ==
    prefix_k tests as integer mask/shift compares;
  * two 32-bit polynomial rolling hashes of the full string — concatenation
    with a k-trimmed chain is h(A)*p^(lenB-k) + (h(B) - h(B[:k])*p^(lenB-k)),
    all in wrapping uint32 arithmetic. The reference's `contigs[i] !=
    contigs[j]` guard becomes (len, h1, h2) equality — a double 32-bit hash
    collision would be needed to diverge (documented approximation; the
    native/spec backends are exact);
  * chain links over slots (next/trim/tail) so the merged strings are
    reconstructed exactly on the host afterwards — no character buffers on
    device at all.

Scan order replicates the reference exactly: for k = K-1..1, repeat until no
ordering shrinks: i ascending, j descending, skipping dead slots; erase
compaction preserves relative order, so skipping dead slots is equivalent.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.core.encoding import encode_dna

_P1 = np.uint32(1000003)
_P2 = np.uint32(805306457)


def _hash_arrays(contigs: list[str]):
    """Per-contig: packed pre16/suf16, lengths, two rolling hashes, and the
    hashes of every prefix of the first 16 characters (for trim-k removal).
    Also power tables p^x for x up to max length."""
    C = len(contigs)
    max_len = max(len(c) for c in contigs)
    pre16 = np.zeros(C, np.uint32)
    suf16 = np.zeros(C, np.uint32)
    lens = np.zeros(C, np.int32)
    h1 = np.zeros(C, np.uint32)
    h2 = np.zeros(C, np.uint32)
    hpre1 = np.zeros((C, 16), np.uint32)
    hpre2 = np.zeros((C, 16), np.uint32)
    for ci, s in enumerate(contigs):
        codes = encode_dna(s).astype(np.uint32)
        lens[ci] = len(s)
        a = 0
        b = 0
        for t, c in enumerate(codes):
            a = (a * int(_P1) + int(c)) & 0xFFFFFFFF
            b = (b * int(_P2) + int(c)) & 0xFFFFFFFF
            if t < 16:
                hpre1[ci, t] = a  # hash of s[:t+1]
                hpre2[ci, t] = b
        h1[ci] = a
        h2[ci] = b
        p = codes[:16]
        pre16[ci] = sum(int(c) << (2 * (15 - t)) for t, c in enumerate(p))
        sfx = codes[-16:] if len(codes) >= 16 else codes
        suf16[ci] = sum(int(c) << (2 * (len(sfx) - 1 - t)) for t, c in enumerate(sfx))
    # power tables up to the largest possible merged length (wrapping uint32)
    total = int(lens.sum())
    pow1 = np.ones(total + 1, np.uint32)
    pow2 = np.ones(total + 1, np.uint32)
    a = b = 1
    for x in range(1, total + 1):
        a = (a * int(_P1)) & 0xFFFFFFFF
        b = (b * int(_P2)) & 0xFFFFFFFF
        pow1[x] = a
        pow2[x] = b
    return pre16, suf16, lens, h1, h2, hpre1, hpre2, pow1, pow2


@partial(jax.jit, static_argnames=("dbg_kmer",))
def _merge_kernel(perms, pre16_c, suf16_c, lens_c, h1_c, h2_c,
                  hpre1_c, hpre2_c, pow1, pow2, dbg_kmer):
    """perms: [O, C] contig index per slot. Returns final chain state."""
    O, C = perms.shape

    # a slot's chain-head contig is invariant (absorbs append at the tail),
    # so the head contig id is simply perms[o, s]
    st = {
        "alive": jnp.ones((O, C), bool),
        "eqflag": jnp.zeros((O,), bool),
        "len": lens_c[perms],
        "pre16": pre16_c[perms],
        "suf16": suf16_c[perms],
        "h1": h1_c[perms],
        "h2": h2_c[perms],
        "next": jnp.full((O, C), -1, jnp.int32),
        "trim": jnp.zeros((O, C), jnp.int32),
        "tail": jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (O, C)),
    }
    head_c = perms.astype(jnp.int32)  # static per slot

    def body_i(i, st, k, prefix_k):
        """One i-pass: j descends C-1..0 with contigs[i] re-read after every
        merge (cpp:239-257). i's state only changes at a MERGE, and between
        merges it is constant — so the next j the reference's scan would
        merge is exactly the LARGEST candidate j below the current position
        under i's current state. The pass therefore jumps merge-to-merge: a
        while loop whose body computes the candidate mask [O, C] with vector
        ops and applies one merge per ordering, running 1 + max-merges
        iterations instead of C scan steps (merges are rare, so this cuts
        the sequential depth per sweep from C^2 to ~C)."""
        j_iota = jnp.arange(C, dtype=jnp.int32)
        o_iota = jnp.arange(O, dtype=jnp.int32)
        # j-state is fixed within the pass (each j merges at most once and
        # only i mutates); within-pass kills never re-enter because the
        # position pointer is strictly decreasing
        alive_snap = st["alive"]
        len_j, h1_j, h2_j = st["len"], st["h1"], st["h2"]
        suf16_j, tail_j = st["suf16"], st["tail"]
        hk1_j = hpre1_c[head_c, k - 1]
        hk2_j = hpre2_c[head_c, k - 1]

        def sel(A, js):
            """A[o, js[o]] via one-hot masking (C is tiny)."""
            return jnp.where(j_iota[None, :] == js[:, None], A, 0).sum(
                axis=1, dtype=A.dtype)

        carry0 = {
            "active": st["alive"][:, i],
            "eqflag": st["eqflag"],
            "pos": jnp.full((O,), C - 1, jnp.int32),
            "len": st["len"][:, i],
            "h1": st["h1"][:, i],
            "h2": st["h2"][:, i],
            "suf16": st["suf16"][:, i],
            "tail": st["tail"][:, i],
            "alive": st["alive"],
            "next": st["next"],
            "trim": st["trim"],
        }

        def cond(c):
            return c["active"].any()

        def body(c):
            suffix_i = c["suf16"] & jnp.uint32((1 << (2 * k)) - 1)
            str_eq = ((c["len"][:, None] == len_j)
                      & (c["h1"][:, None] == h1_j)
                      & (c["h2"][:, None] == h2_j))
            can_but_eq = (c["active"][:, None]
                          & (j_iota[None, :] <= c["pos"][:, None])
                          & (j_iota[None, :] != i)
                          & alive_snap
                          & (c["len"][:, None] >= k) & (len_j >= k)
                          & (suffix_i[:, None] == prefix_k))
            can = can_but_eq & ~str_eq
            # a (len, h1, h2)-equality that actually GATED a merge decision:
            # if it was genuine string equality the skip is the reference's
            # own `contigs[i] != contigs[j]` guard, but if it was a hash
            # collision the skip is wrong — flag the ordering so the host
            # re-merges it exactly (assemble_device collision guard)
            eq_gated = (can_but_eq & str_eq).any(axis=1)
            j_sel = jnp.max(jnp.where(can, j_iota[None, :], -1), axis=1)
            hit = j_sel >= 0
            js = jnp.where(hit, j_sel, 0)
            tail_len = (sel(len_j, js) - k).astype(jnp.int32)
            p1 = pow1[tail_len]
            p2 = pow2[tail_len]
            h1n = c["h1"] * p1 + (sel(h1_j, js) - sel(hk1_j, js) * p1)
            h2n = c["h2"] * p2 + (sel(h2_j, js) - sel(hk2_j, js) * p2)
            # chain links: next[o, tail_i] = j, trim[o, j] = k; kill j
            oh_j = hit[:, None] & (j_iota[None, :] == js[:, None])
            oh_tail = hit[:, None] & (j_iota[None, :] == c["tail"][:, None])
            return {
                "active": hit,
                "eqflag": c["eqflag"] | eq_gated,
                "pos": jnp.where(hit, js - 1, c["pos"]),
                "len": jnp.where(hit, c["len"] + tail_len, c["len"]),
                "h1": jnp.where(hit, h1n, c["h1"]),
                "h2": jnp.where(hit, h2n, c["h2"]),
                "suf16": jnp.where(hit, sel(suf16_j, js), c["suf16"]),
                "tail": jnp.where(hit, sel(tail_j, js), c["tail"]),
                "alive": c["alive"] & ~oh_j,
                "next": jnp.where(oh_tail, js[:, None], c["next"]),
                "trim": jnp.where(oh_j, jnp.int32(k), c["trim"]),
            }

        cf = jax.lax.while_loop(cond, body, carry0)

        st = dict(st)
        st["alive"] = cf["alive"]
        st["eqflag"] = cf["eqflag"]
        st["next"] = cf["next"]
        st["trim"] = cf["trim"]
        # column i takes the final carry
        for f in ("len", "h1", "h2", "suf16", "tail"):
            st[f] = st[f].at[:, i].set(cf[f])
        return st

    def sweep(st, k):
        prefix_k = st["pre16"] >> jnp.uint32(2 * (16 - k))  # invariant in k-phase
        return jax.lax.fori_loop(
            0, C, lambda i, s: body_i(i, s, k, prefix_k), st
        )

    def fixpoint(st, k):
        def cond(carry):
            st, changed = carry
            return changed

        def body(carry):
            st, _ = carry
            before = st["alive"].sum()
            st = sweep(st, k)
            return (st, st["alive"].sum() < before)

        st, _ = jax.lax.while_loop(cond, body, (st, jnp.bool_(True)))
        return st

    for k in range(dbg_kmer - 1, 0, -1):
        st = fixpoint(st, k)
    return st["alive"], st["next"], st["trim"], st["eqflag"]


def assemble_device(contigs: list[str], dbg_kmer: int, seed: int,
                    n_orderings: int) -> list[str]:
    """Device ensemble merge; same contract as merge.native.assemble_native:
    returns deduplicated solutions sorted by (-length, lexicographic)."""
    from genomeassembler_dev.core.rng import shuffle_orderings

    if not contigs:
        return []
    if len(contigs) == 1:
        return list(contigs)
    C = len(contigs)
    perms = shuffle_orderings(C, n_orderings, seed)
    pre16, suf16, lens, h1, h2, hpre1, hpre2, pow1, pow2 = _hash_arrays(contigs)
    alive, nxt, trim, eqflag = (
        np.asarray(x)
        for x in _merge_kernel(
            jnp.asarray(perms), jnp.asarray(pre16), jnp.asarray(suf16),
            jnp.asarray(lens), jnp.asarray(h1), jnp.asarray(h2),
            jnp.asarray(hpre1), jnp.asarray(hpre2),
            jnp.asarray(pow1), jnp.asarray(pow2), dbg_kmer,
        )
    )

    out = set()
    O = perms.shape[0]
    # collision guard: an ordering where (len, h1, h2)-equality gated a merge
    # decision is EXACTLY re-merged on the host (spec string semantics) — if
    # the equality was genuine the result is identical; if it was a double-
    # 32-bit hash collision the device chains are untrusted for that ordering.
    # Equal-string gates only fire on duplicate/repeat-heavy ensembles, so
    # the host fallback is rare and the backend stays exact in all cases.
    from genomeassembler_dev.spec.reference_semantics import merge_one_ordering

    n_fallback = 0
    for o in range(O):
        if eqflag[o]:
            out.update(merge_one_ordering(
                [contigs[p] for p in perms[o]], dbg_kmer))
            n_fallback += 1
            continue
        next_o, trim_o, perm_o = nxt[o], trim[o], perms[o]
        for s in np.nonzero(alive[o])[0]:
            parts = [contigs[perm_o[s]]]
            cur = next_o[s]
            while cur != -1:
                parts.append(contigs[perm_o[cur]][trim_o[cur]:])
                cur = next_o[cur]
            out.add("".join(parts))
    assemble_device.last_n_fallback = n_fallback
    return sorted(out, key=lambda s: (-len(s), s))
