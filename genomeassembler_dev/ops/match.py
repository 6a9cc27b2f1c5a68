"""Exact read-in-solution matching on device.

The reference scorer does |solutions| x |distinct reads| naive
`std::string::find` calls (lib/DeNovoAssembler.cpp:354-360). Here every
solution window of read length is packed into ceil(R/16) uint32 words, and a
read matches at a window iff all words are equal — pure integer compares on
the VPU, batched over (solutions x windows x reads) with chunking over reads.
The *first* matching window per (solution, read) is returned, matching
`find`'s first-occurrence semantics.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from genomeassembler_dev.ops.windows import kmer_window_codes


def _window_words(path_codes: jnp.ndarray, read_len: int) -> jnp.ndarray:
    """Packed words of every read_len-window of each path.

    path_codes: [S, L] base codes (pad > 3). Returns [S, P, W] uint32 with
    P = L - read_len + 1, W = ceil(read_len/16). Windows containing pad
    bases never match (their packed word differs from any pure-ACGT word
    only if pad bits collide — so pad contributions are mapped to a
    sentinel word instead, see below).
    """
    S, L = path_codes.shape
    P = L - read_len + 1
    words = []
    n_words = -(-read_len // 16)
    for w in range(n_words):
        chars = min(16, read_len - 16 * w)
        codes, valid = kmer_window_codes(path_codes, chars, dtype=jnp.uint32)
        # window starting at p has word w covering [p+16w, p+16w+chars)
        start = 16 * w
        seg = codes[:, start : start + P]
        seg_valid = valid[:, start : start + P]
        shifted = seg << jnp.uint32(2 * (16 - chars))
        # invalid (pad-containing) windows get an impossible word: any value
        # with bits in the low 2*(16-chars) zone can't come from a read word
        # when chars < 16; when chars == 16 use all-ones + valid mask below.
        words.append(jnp.where(seg_valid, shifted, jnp.uint32(0xFFFFFFFF)))
    return jnp.stack(words, axis=-1)  # [S, P, W]


def _read_words(read_codes: jnp.ndarray) -> jnp.ndarray:
    """Packed words of each read: [R, Lr] -> [R, W] uint32, zero-padded tail."""
    from genomeassembler_dev.ops.windows import pack_words

    return pack_words(read_codes)


@partial(jax.jit, static_argnames=())
def find_first_match_sorted(
    path_codes: jnp.ndarray,  # [S, L] base codes, pad > 3
    path_lens: jnp.ndarray,  # [S]
    read_codes: jnp.ndarray,  # [R, Lr] base codes (pure ACGT)
    read_valid: jnp.ndarray,  # [R] bool
):
    """Sort-merge variant of find_first_match: O((P+R) log) per solution
    instead of the O(P*R) compare grid — the production path at velvet scale
    (50 kb solutions x ~40k distinct reads), where the brute-force grid is
    ~100x more work.

    Per solution: windows and reads sort together lexicographically by packed
    words with a window-before-read tie tag (stable, so window positions stay
    ascending within a code run); each read's candidate is the first window
    of the preceding run (a cummax-propagated run start), verified by word
    equality. Exact first-occurrence semantics, any read length.
    """
    S, L = path_codes.shape
    R, Lr = read_codes.shape
    P = L - Lr + 1
    pw = _window_words(path_codes, Lr)  # [S, P, W]
    rw = _read_words(read_codes)  # [R, W]
    W = pw.shape[-1]
    pos = jnp.arange(P, dtype=jnp.int32)
    # pad bases live only beyond path_len, so in-range windows are pure ACGT
    # and the range mask alone is the window validity (it travels as a sort
    # operand — the 0xFFFFFFFF pad-window word is also a legitimate all-T
    # window word, so it cannot serve as a validity sentinel)
    wvalid = pos[None, :] + Lr <= path_lens[:, None]  # [S, P]

    N = P + R
    iota = jnp.arange(N, dtype=jnp.int32)

    def per_solution(pw_s, wv_s):
        keys = [jnp.concatenate([pw_s[:, w], rw[:, w]]) for w in range(W)]
        tag = jnp.concatenate([jnp.zeros(P, jnp.int32), jnp.ones(R, jnp.int32)])
        payload = jnp.concatenate([pos, jnp.arange(R, dtype=jnp.int32)])
        valid = jnp.concatenate([wv_s, read_valid])
        out = jax.lax.sort(
            [*keys, tag, payload, valid], num_keys=W + 1, is_stable=True
        )
        ks, tg, pl_, vl = out[:W], out[W], out[W + 1], out[W + 2]
        is_win = (tg == 0) & vl
        is_read = (tg == 1) & vl

        same_key = jnp.zeros(N, bool)
        for i, kw in enumerate(ks):
            eq_prev = jnp.concatenate([jnp.zeros((1,), bool), kw[1:] == kw[:-1]])
            same_key = eq_prev if i == 0 else same_key & eq_prev

        # key runs are maximal equal-key stretches; run ids are monotone, so
        # every segmented quantity is a plain cummax:
        #   rs  = index where my run starts,
        #   fm  = index of my run's FIRST valid window (markers fire at valid
        #         windows with no earlier same-run valid window; cummax of
        #         first-markers then forward-fills).
        # A read's candidate is fm when fm >= rs — and being in the same run
        # already means the keys are equal, so no verification gather needed.
        rs = jax.lax.cummax(jnp.where(~same_key, iota, -1))
        marker = jnp.concatenate(
            [jnp.zeros((1,), bool), is_win[:-1]]
        ) & same_key
        new_run_win = is_win & ~marker
        ffprev = jnp.concatenate([
            jnp.full((1,), -1, jnp.int32),
            jax.lax.cummax(jnp.where(new_run_win, iota, -1))[:-1],
        ])
        is_first_marker = new_run_win & (ffprev < rs)
        fm = jax.lax.cummax(jnp.where(is_first_marker, iota, -1))

        ok = is_read & (fm >= rs)
        fpos = jnp.where(ok, pl_[jnp.maximum(fm, 0)], 0)
        slot = jnp.where(is_read, pl_, R)
        found = jnp.zeros(R, bool).at[slot].set(ok, mode="drop")
        first = jnp.zeros(R, jnp.int32).at[slot].set(fpos, mode="drop")
        return found, first

    return jax.vmap(per_solution)(pw, wvalid)


def find_first_match_auto(
    path_codes: jnp.ndarray,
    path_lens: jnp.ndarray,
    read_codes: jnp.ndarray,
    read_valid: jnp.ndarray,
    read_chunk: int = 512,
):
    """Shape-based dispatch: the O(P*R) compare grid wins at small sizes
    (one fused reduction, no sort); the sort-merge join wins once the grid
    exceeds ~64M cells (velvet-scale: ~100x less work)."""
    S, L = path_codes.shape
    R, Lr = read_codes.shape
    P = L - Lr + 1
    if S * P * R > (1 << 26):
        return find_first_match_sorted(path_codes, path_lens, read_codes,
                                       read_valid)
    return find_first_match(path_codes, path_lens, read_codes, read_valid,
                            read_chunk=read_chunk)


@partial(jax.jit, static_argnames=("read_chunk",))
def find_first_match(
    path_codes: jnp.ndarray,  # [S, L] base codes, pad > 3
    path_lens: jnp.ndarray,  # [S]
    read_codes: jnp.ndarray,  # [R, Lr] base codes (pure ACGT)
    read_valid: jnp.ndarray,  # [R] bool — slot actually holds a read
    read_chunk: int = 512,
):
    """First occurrence of each read in each path.

    Returns (found [S, R] bool, first_pos [S, R] int32). A read matches at
    window p iff p + Lr <= path_len and all packed words agree.
    """
    S, L = path_codes.shape
    R, Lr = read_codes.shape
    P = L - Lr + 1
    pw = _window_words(path_codes, Lr)  # [S, P, W]
    rw = _read_words(read_codes)  # [R, W]
    pos = jnp.arange(P, dtype=jnp.int32)
    in_range = pos[None, :] + Lr <= path_lens[:, None]  # [S, P]

    n_chunks = -(-R // read_chunk)
    pad_r = n_chunks * read_chunk - R
    # padding reads are excluded via the validity mask
    rw_p = jnp.pad(rw, ((0, pad_r), (0, 0)))
    rv_p = jnp.pad(read_valid, (0, pad_r))
    rw_c = rw_p.reshape(n_chunks, read_chunk, -1)
    rv_c = rv_p.reshape(n_chunks, read_chunk)

    def chunk_step(_, x):
        rwc, rvc = x  # [C, W], [C]
        eq = (pw[:, :, None, :] == rwc[None, None, :, :]).all(-1)  # [S, P, C]
        eq = eq & in_range[:, :, None] & rvc[None, None, :]
        found = eq.any(axis=1)  # [S, C]
        first = jnp.argmax(eq, axis=1).astype(jnp.int32)  # [S, C]
        return None, (found, first)

    _, (found_c, first_c) = jax.lax.scan(chunk_step, None, (rw_c, rv_c))
    # [n_chunks, S, C] -> [S, R]
    found = jnp.moveaxis(found_c, 0, 1).reshape(S, n_chunks * read_chunk)[:, :R]
    first = jnp.moveaxis(first_c, 0, 1).reshape(S, n_chunks * read_chunk)[:, :R]
    return found, first
