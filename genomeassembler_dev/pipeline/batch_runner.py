"""Batched multi-segment experiment execution.

The reference runs its 200-experiment x 7-config study strictly serially
(scripts/02_…:33-53). Here the device stages run batched across segments:

  stage 1: one jit simulates every segment's read set          [B, N, R]
  stage 2: one jit builds every dBG and walks every contig     [B, W, L]
  stage 3: the native engine merges each segment's orderings (threads)
  stage 4: segments are grouped by bucketed (solutions, reads) shapes and
           scored with vmapped breakscore / Levenshtein / KS — a handful of
           jit calls for the whole group instead of per-experiment dispatch.

Outputs are identical to Assembler.run_experiment per segment (same spec
semantics); only the execution schedule changes.
"""

from __future__ import annotations

import os

from collections import defaultdict
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.core.encoding import encode_dna
from genomeassembler_dev.core.querytable import QueryTable
from genomeassembler_dev.dbg.assemble import DENSE_MAX_K, dedup_contigs
from genomeassembler_dev.dbg.dense import contigs_dense
from genomeassembler_dev.dbg.graph import contigs_sparse
from genomeassembler_dev.merge.engine import assemble_solutions
from genomeassembler_dev.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev.ops.ks import batched_ks_2samp
from genomeassembler_dev.ops.mxu import dot_f32
from genomeassembler_dev.ops.windows import kmer_window_codes
from genomeassembler_dev.pipeline.assembler import (
    ExperimentResult,
    pack_strings,
    pad_reads,
)
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.score.breakscore import breakscore
from genomeassembler_dev.sim.reads import dedup_reads, n_draws_for, simulate_reads
from genomeassembler_dev.utils.timers import StageTimer


def _shard_over_seg(vfn, mesh, n_in: int, n_repl: int = 0):
    """shard_map a vmapped per-segment function over the mesh's `seg` axis:
    the first n_in inputs shard on their leading (batch) axis, the last
    n_repl inputs (shared tables) replicate. Mesh axes other than `seg` (if
    present) replicate the compute — the batched study is pure segment data
    parallelism (SURVEY §2.2 row 1)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    return jax.jit(shard_map(
        vfn, mesh=mesh,
        in_specs=tuple([P("seg")] * n_in + [P()] * n_repl),
        out_specs=P("seg"), check_vma=False,
    ))


# ---------------------------------------------------------------------------
# cached stage programs: rebuilding jit closures per call forces a retrace
# (and a compile-cache round-trip) on EVERY batch. Builders are keyed on the
# static config so repeat batches hit the in-process jit cache; all arrays
# (genomes, tables) are arguments, never closures.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=128)
def _sim_jit(read_len: int, n_draws: int, kmer: int, seed: int, mesh):
    vsim = jax.vmap(
        lambda g, p8: simulate_reads(jax.random.key(seed), g, p8, read_len,
                                     n_draws, kmer),
        in_axes=(0, None),
    )
    if mesh is None:
        return jax.jit(vsim)
    return _shard_over_seg(vsim, mesh, n_in=1, n_repl=1)


@lru_cache(maxsize=128)
def _walk_jit(read_len: int, dbg_kmer: int, contig_cap: int, max_walks: int,
              use_dedup: bool, dedup_cap: int, node_cap: int, mesh):
    from genomeassembler_dev.ops.dedup import (
        dedup_with_counts, pack_read_codes, unpack_kmer_windows)

    if dbg_kmer <= DENSE_MAX_K:
        # thread the runner-computed node_cap through (the default 1024 was
        # silently undersized for long segments: compact_by_rank_mxu drops
        # nodes with rank >= cap, corrupting contigs with no error)
        def fn(kc, kv, k, cap, mw):
            return contigs_dense(kc, kv, k, cap, mw, node_cap=node_cap)
    else:
        # cap the sparse node arrays (callers check n_nodes <= node_cap):
        # walking the full 2E-padded arrays costs ~2E/n_nodes x redundant
        # doubling gathers — the dominant study dBG-stage cost
        def fn(kc, kv, k, cap, mw):
            return contigs_sparse(kc, kv, k, cap, mw, node_cap=node_cap)

    def per_seg(codes, valid):
        if use_dedup:
            ucodes, _, n_u = dedup_with_counts(
                pack_read_codes(codes, valid), dedup_cap)
            kc = unpack_kmer_windows(ucodes, read_len, dbg_kmer)
            kv = jnp.broadcast_to(
                (jnp.arange(dedup_cap, dtype=jnp.int32) < n_u)[:, None],
                kc.shape)
        else:
            kc, kv = kmer_window_codes(codes, dbg_kmer)
            kv = kv & valid[:, None]
            n_u = jnp.int32(0)
        return fn(kc, kv, dbg_kmer, contig_cap, max_walks) + (n_u,)

    vwalk = jax.vmap(per_seg)
    if mesh is None:
        return jax.jit(vwalk)
    return _shard_over_seg(vwalk, mesh, n_in=2)


@lru_cache(maxsize=128)
def _score_jit(break_kmer: int, read_chunk: int, mesh):
    if mesh is not None and mesh.shape.get("read", 1) > 1:
        # read-axis model parallelism for the score stage: the site-count
        # matcher is the read-heavy program (at 50 kb configs ~167k reads
        # per experiment, lib/GenerateReads.R:302-313), so reads shard over
        # `read` with a psum of the partial site counts — the production
        # runner uses the exact collective step the unit lanes verify
        # (parallel/sharding.py::make_breakscore_step). Output-identical to
        # the replicated path (tests/test_batch_runner.py).
        from types import SimpleNamespace

        from genomeassembler_dev.parallel.sharding import (
            make_breakscore_step,
        )

        step = jax.jit(make_breakscore_step(mesh, break_kmer, read_chunk))

        def run(pm, pl, rc, rn, rv, probs):
            return SimpleNamespace(**step(pm, pl, rc, rn, rv, probs))

        run.lower = step.lower  # keep the prewarm (.lower().compile()) path
        return run
    vscore = jax.vmap(
        lambda pm, pl, rc, rn, rv, probs: breakscore(
            pm, pl, rc, rn, rv, probs,
            break_kmer=break_kmer, read_chunk=read_chunk,
        ),
        in_axes=(0, 0, 0, 0, 0, None),
    )
    if mesh is None:
        return jax.jit(vscore)
    return _shard_over_seg(vscore, mesh, n_in=5, n_repl=1)


@lru_cache(maxsize=64)
def _eval_jit(break_kmer: int, read_chunk: int):
    """Single-device fused eval: breakscore + KS + random-table dots +
    Levenshtein as ONE compiled program, with outputs identical to the four
    separate programs (same vmapped breakscore, same 256-row-chunked
    pooled-sort KS with nan padding, same vmapped Levenshtein).

    OPT-IN via GA_FUSED_EVAL=1: its compile is much heavier than the four
    small programs'. Whether it pays on the H100 is not measured yet
    (ROADMAP S3)."""
    from genomeassembler_dev.ops.ks import batched_ks_2samp as ks2

    def fn(pm, pl, rc, rn, rv, probs, uni, gm, tr):
        bs = jax.vmap(
            lambda a, b, c, d, e, p: breakscore(
                a, b, c, d, e, p, break_kmer=break_kmer,
                read_chunk=read_chunk),
            in_axes=(0, 0, 0, 0, 0, None),
        )(pm, pl, rc, rn, rv, probs)
        total = jnp.maximum(bs.kmer_breaks.astype(jnp.float32), 1.0)
        bp_rand = dot_f32(bs.site_counts, uni)
        bp_rand_nb = jnp.where(
            bs.kmer_breaks > 0,
            dot_f32(bs.site_counts / total[..., None], uni), 0.0)
        # KS in 256-solution-row chunks (the pooled sort needs three f32
        # operands of [rows, 70k]; full-S at once OOMs HBM for big buckets)
        G, S, F = bs.path_freq.shape
        CH = 256
        n_ch = -(-S // CH)
        pf = jnp.pad(bs.path_freq, ((0, 0), (0, n_ch * CH - S), (0, 0)),
                     constant_values=jnp.nan)
        pf = pf.reshape(G, n_ch, CH, F).transpose(1, 0, 2, 3)
        ks = jax.lax.map(lambda sl: jax.vmap(ks2)(sl, tr), pf)
        ks = ks.transpose(1, 0, 2).reshape(G, n_ch * CH)[:, :S]
        lev = jax.vmap(
            lambda q, ql, t: batched_levenshtein_auto(q, ql, t, mode="NW")
        )(pm, pl, gm)
        return {
            "bp_score": bs.bp_score,
            "bp_score_norm_by_break_freqs": bs.bp_score_norm_by_break_freqs,
            "bp_score_norm_by_len": bs.bp_score_norm_by_len,
            "kmer_breaks": bs.kmer_breaks,
            "bp_rand": bp_rand,
            "bp_rand_nb": bp_rand_nb,
            "ks": ks,
            "lev": lev,
        }

    return jax.jit(fn)


@lru_cache(maxsize=16)
def _rand_scores_jit(mesh):
    """Random-table score dots as ONE program instead of an eager division
    and two dot dispatches (three compiles and three launches)."""
    def fn(site_counts, kmer_breaks, uni):
        total = jnp.maximum(kmer_breaks.astype(jnp.float32), 1.0)
        bp_rand = dot_f32(site_counts, uni)
        bp_rand_nb = jnp.where(
            kmer_breaks > 0,
            dot_f32(site_counts / total[..., None], uni), 0.0)
        return bp_rand, bp_rand_nb
    if mesh is None:
        return jax.jit(fn)
    return _shard_over_seg(fn, mesh, n_in=2, n_repl=1)


@lru_cache(maxsize=16)
def _ks_jit(mesh):
    vks = jax.vmap(batched_ks_2samp)
    if mesh is None:
        return jax.jit(vks)
    return _shard_over_seg(vks, mesh, n_in=2)


@lru_cache(maxsize=16)
def _lev_jit(mesh):
    # one Levenshtein implementation on every path (a mesh shard runs the
    # same function); targets are exact seq_len rows, all it requires
    vlev = jax.vmap(
        lambda pm, pl, g: batched_levenshtein_auto(pm, pl, g, mode="NW"))
    if mesh is None:
        return jax.jit(vlev)
    return _shard_over_seg(vlev, mesh, n_in=3)


def run_experiments_batched(
    cfg: ExperimentConfig,
    segments: list[str],
    table: QueryTable,
    uniform: QueryTable | None = None,
    score_group: int = 8,
    verbose: bool = False,
    mesh=None,
) -> list[ExperimentResult]:
    """mesh=None runs single-device; passing a jax.sharding.Mesh with a
    `seg` axis runs every device stage (simulate, dBG+walk, scoring, KS,
    Levenshtein) shard_map'ed over segments — bit-identical outputs, tested
    on the virtual 8-device CPU mesh (tests/test_batch_runner.py)."""
    if cfg.traversal != "standard":
        # the batched walk implements the standard traversal only; fall back
        # to the serial per-segment Assembler so a biased-labeled config
        # never silently produces standard-traversal results (mesh does not
        # apply)
        from genomeassembler_dev.pipeline.assembler import Assembler

        asm = Assembler(cfg, table, verbose=verbose)
        return [asm.run_experiment(s) for s in segments]
    return _run_standard_batched(cfg, segments, table, uniform, score_group,
                                 verbose, mesh)


def _run_standard_batched(
    cfg: ExperimentConfig,
    segments: list[str],
    table: QueryTable,
    uniform: QueryTable | None,
    score_group: int,
    verbose: bool,
    mesh,
) -> list[ExperimentResult]:
    uniform = uniform or QueryTable.uniform()
    timer = StageTimer(verbose)
    B_out = len(segments)
    if mesh is not None:
        n_seg = mesh.shape["seg"]
        segments = list(segments) + [segments[0]] * ((-len(segments)) % n_seg)
    B = len(segments)
    L = cfg.seq_len
    probs8 = jnp.asarray(table.probs[8], jnp.float32)
    probs_all = jnp.asarray(table.combined, jnp.float32)
    uni_all = jnp.asarray(uniform.combined, jnp.float32)

    genome_mat = np.stack([encode_dna(s) for s in segments])
    n_draws = n_draws_for(cfg.coverage_target, L, cfg.read_len)

    # background stage-compile worker: stages otherwise compile serially as
    # the runner first reaches them; prewarming the NEXT stage while the
    # current one compiles/runs overlaps that latency (the compiled
    # executable lands in the persistent cache, which the real call then
    # loads). Compiles are ordered by need on a narrow pool rather than
    # fanned out speculatively. Whether the H100 needs this is an open
    # measurement (ROADMAP D1).
    from concurrent.futures import ThreadPoolExecutor

    compile_pool = ThreadPoolExecutor(max_workers=3)
    prewarmed: dict = {}

    def prewarm(key, fn, *abstract_args):
        if key not in prewarmed:
            def compile_():
                try:
                    fn.lower(*abstract_args).compile()
                except Exception:  # pragma: no cover — best-effort
                    pass
            prewarmed[key] = compile_pool.submit(compile_)
        return prewarmed[key]

    # walk-stage statics are all known before the sim runs: prewarm it now
    max_walks = 2048
    dedup_cap = 1 << (L - cfg.read_len + 1).bit_length()
    use_dedup = cfg.read_len <= 15 and dedup_cap <= n_draws * 2
    if cfg.dbg_kmer <= DENSE_MAX_K:
        # simulated reads are genome substrings, so distinct (k-1)-mer
        # nodes <= L - k + 2; power-of-two ladder for jit-cache reuse
        node_cap = 1 << max(6, (L - cfg.dbg_kmer + 1).bit_length())
        node_cap = min(node_cap, 4 ** (cfg.dbg_kmer - 1))
    else:
        node_cap = 1 << max(1, cfg.contig_cap + 64 - 1).bit_length()
    walk = _walk_jit(cfg.read_len, cfg.dbg_kmer, cfg.contig_cap,
                     max_walks, use_dedup, dedup_cap, node_cap, mesh)
    walk_fut = prewarm(
        "walk", walk,
        jax.ShapeDtypeStruct((B, n_draws, cfg.read_len), jnp.uint8),
        jax.ShapeDtypeStruct((B, n_draws), jnp.bool_))

    # ---- eval-stage prewarm helpers (used speculatively NOW and again as
    # real buckets appear) --------------------------------------------------
    score6 = _score_jit(cfg.kmer, cfg.read_chunk, mesh)
    ks_fn = _ks_jit(mesh)
    rand_fn = _rand_scores_jit(mesh)
    lev_fn = _lev_jit(mesh)
    # the fused eval program (score+KS+rand+Lev in one compile): opt in via
    # GA_FUSED_EVAL=1 (see _eval_jit)
    use_fused_eval = (mesh is None
                      and os.environ.get("GA_FUSED_EVAL", "") == "1")
    eval_fn = (_eval_jit(cfg.kmer, cfg.read_chunk)
               if use_fused_eval else None)
    F = int(probs_all.shape[0])

    def _group_cap(shape_key) -> int:
        # the matcher materialises ~[G, S, P, read_chunk] compare buffers
        # plus [G, S, 69904] f32 count matrices; budget both against device
        # memory (the 2.5e9-cell cap was sized for a 16 GB device and is
        # untuned for the H100's 80 GB, ROADMAP S3)
        S_bucket, P_bucket = shape_key[0]
        cells = S_bucket * P_bucket * cfg.read_chunk
        group = max(1, min(score_group,
                           int(2.5e9 // max(cells, 1)),
                           int(4096 // max(S_bucket, 1))))
        if mesh is not None:
            # each device carries `group` members; chunks fill the seg axis
            group *= mesh.shape["seg"]
        return group

    def _prewarm_score(key) -> None:
        """Background-compile the eval program(s) for a bucket shape the
        moment its first member appears — the group fills over several
        native merges, hiding (part of) the compile latency."""
        G = _group_cap(key)
        (S, Lp), (Nr, R) = key
        # the four small programs compile in need order; the fused program
        # is appended only under GA_FUSED_EVAL=1 (single device)
        prewarm(("score", key), score6,
                jax.ShapeDtypeStruct((G, S, Lp), jnp.uint8),
                jax.ShapeDtypeStruct((G, S), jnp.int32),
                jax.ShapeDtypeStruct((G, Nr, R), jnp.uint8),
                jax.ShapeDtypeStruct((G, Nr), jnp.int32),
                jax.ShapeDtypeStruct((G, Nr), jnp.bool_),
                jax.ShapeDtypeStruct((F,), jnp.float32))
        prewarm(("ks", G), ks_fn,
                jax.ShapeDtypeStruct((G, 256, F), jnp.float32),
                jax.ShapeDtypeStruct((G, L), jnp.float32))
        prewarm(("rand", (G, S)), rand_fn,
                jax.ShapeDtypeStruct((G, S, F), jnp.float32),
                jax.ShapeDtypeStruct((G, S), jnp.int32),
                jax.ShapeDtypeStruct((F,), jnp.float32))
        prewarm(("lev", (S, Lp)), lev_fn,
                jax.ShapeDtypeStruct((G, S, Lp), jnp.uint8),
                jax.ShapeDtypeStruct((G, S), jnp.int32),
                jax.ShapeDtypeStruct((G, L), jnp.uint8))
        if use_fused_eval:
            prewarm(("eval", key), eval_fn,
                    jax.ShapeDtypeStruct((G, S, Lp), jnp.uint8),
                    jax.ShapeDtypeStruct((G, S), jnp.int32),
                    jax.ShapeDtypeStruct((G, Nr, R), jnp.uint8),
                    jax.ShapeDtypeStruct((G, Nr), jnp.int32),
                    jax.ShapeDtypeStruct((G, Nr), jnp.bool_),
                    jax.ShapeDtypeStruct((F,), jnp.float32),
                    jax.ShapeDtypeStruct((F,), jnp.float32),
                    jax.ShapeDtypeStruct((G, L), jnp.uint8),
                    jax.ShapeDtypeStruct((G, L), jnp.float32))

    # NOTE: no speculative bucket prewarm here — a wrong guess delays the
    # real compiles; _prewarm_score fires on each bucket's FIRST member
    # instead, which still overlaps the score/KS/Lev compiles with the
    # native merges.

    # ---- stage 1: batched read simulation ---------------------------------
    with timer.stage("Generating sequencing reads (batched)"):
        # the reference reseeds identically per experiment (scripts/02_…:37),
        # so one static seed serves every segment
        sim = _sim_jit(cfg.read_len, n_draws, cfg.kmer, cfg.seed, mesh)
        rs = sim(jnp.asarray(genome_mat), probs8)
        jax.block_until_ready(rs.codes)

    # ---- stage 2: batched dBG + contig walk -------------------------------
    with timer.stage("Running DBG de novo genome assembler (batched)"):
        walk_fut.result()  # compiled in the background during stage 1
        out = walk(rs.codes, rs.valid)
        # fetch the small outputs first, then slice the contig buffer to the
        # REAL walk count and max length before the host copy: the padded
        # [B, 2048, contig_cap] buffer is hundreds of MB, while real walks
        # are ~15-200 rows
        lens, wvalid, ovf, n_walks, n_nodes, n_u = [
            np.asarray(x) for x in out[1:]
        ]
        if (n_walks > max_walks).any():
            raise ValueError("walk capacity exceeded; raise max_walks")
        w_used = int(min(max_walks, max(1, n_walks.max())))
        l_used = int(min(out[0].shape[-1], max(1, lens.max())))
        bufs = np.asarray(out[0][:, :w_used, :l_used])
        lens, wvalid, ovf = lens[:, :w_used], wvalid[:, :w_used], ovf[:, :w_used]
        if (n_nodes > node_cap).any():
            # dense drops nodes with rank >= cap (corrupt contigs), sparse
            # slices its arrays — either way the outputs are wrong: fail loud
            raise ValueError(
                f"node capacity exceeded ({int(n_nodes.max())} > {node_cap})")
        if (n_u > dedup_cap).any():
            # compact_by_rank_mxu silently drops reads with rank >= cap, which
            # would corrupt contigs; cap is sized for exact-substring reads,
            # so overflow means that assumption broke (e.g. read errors).
            raise ValueError(
                f"read dedup capacity exceeded ({int(n_u.max())} > {dedup_cap})"
            )
        contig_sets = [
            dedup_contigs(bufs[b], lens[b], wvalid[b], ovf[b]) for b in range(B)
        ]

    # ---- stages 3+4: native merge OVERLAPPED with grouped scoring ---------
    # the merge is reference hot loop #1 (lib/DeNovoAssembler.cpp:228-266),
    # run on host CPU threads; the scorer runs on the device. A background
    # worker merges segment b+1..B while the main thread packs and scores
    # completed segments — the two resources proceed concurrently instead of
    # serialising (round-2 verdict: merge was a dead stage between the walk
    # and the scorer). Outputs are bit-identical to the serial schedule.
    read_codes = np.asarray(rs.codes)
    read_valid = np.asarray(rs.valid)
    tracks = np.asarray(rs.track)

    solutions: list[list[str] | None] = [None] * B
    packed: list[tuple | None] = [None] * B

    score_fn = lambda pm, pl, rc, rn, rv: score6(pm, pl, rc, rn, rv, probs_all)

    def ks_chunked(path_freq, tr, chunk=256):
        """KS in solution-row chunks: the pooled sort needs three f32
        operands of [rows, 70k]; full-S at once OOMs HBM for big buckets."""
        G, S, _ = path_freq.shape
        outs = []
        for lo in range(0, S, chunk):
            sl = path_freq[:, lo : lo + chunk]
            if sl.shape[1] < chunk:
                sl = jnp.pad(sl, ((0, 0), (0, chunk - sl.shape[1]), (0, 0)),
                             constant_values=jnp.nan)
            outs.append(np.asarray(ks_fn(sl, tr)))
        return np.concatenate(outs, axis=1)[:, :S]
    results: list[ExperimentResult | None] = [None] * B

    def _score_chunk(chunk: list[int], group: int) -> None:
        # wait for this bucket's background compiles (calling before they
        # finish would start a duplicate compile of the same program)
        key = (packed[chunk[0]][0].shape, packed[chunk[0]][2].shape)
        # adaptive: the fused program is used only once its background
        # compile has LANDED — early (cold) chunks run the small programs
        use_fused = (use_fused_eval and ("eval", key) in prewarmed
                     and prewarmed[("eval", key)].done())
        wait_keys = ([("eval", key)] if use_fused else
                     [("score", key), ("ks", group),
                      ("rand", (group, key[0][0])), ("lev", key[0])])
        for k in wait_keys:
            if k in prewarmed:
                prewarmed[k].result()
        # pad partial groups (repeat first member) to keep one shape
        chunk = chunk + [chunk[0]] * (group - len(chunk))
        pm = jnp.asarray(np.stack([packed[b][0] for b in chunk]))
        pl = jnp.asarray(np.stack([packed[b][1] for b in chunk]))
        rc = jnp.asarray(np.stack([packed[b][2] for b in chunk]))
        rn = jnp.asarray(np.stack([packed[b][3] for b in chunk]))
        rv = jnp.asarray(np.stack([packed[b][4] for b in chunk]))
        gm = jnp.asarray(np.stack([genome_mat[b] for b in chunk]))
        tr = jnp.asarray(np.stack([tracks[b] for b in chunk]))
        if use_fused:
            # fused single-program eval (see _eval_jit): fewer dispatches,
            # identical outputs
            ev = eval_fn(pm, pl, rc, rn, rv, probs_all, uni_all, gm, tr)
            bp_score = np.asarray(ev["bp_score"])
            bp_nb = np.asarray(ev["bp_score_norm_by_break_freqs"])
            bp_nl = np.asarray(ev["bp_score_norm_by_len"])
            kmer_breaks = np.asarray(ev["kmer_breaks"])
            lev = np.asarray(ev["lev"])
            ks = np.asarray(ev["ks"])
            bp_rand = np.asarray(ev["bp_rand"])
            bp_rand_nb = np.asarray(ev["bp_rand_nb"])
        else:
            bs = score_fn(pm, pl, rc, rn, rv)
            lev = np.asarray(lev_fn(pm, pl, gm))
            ks = ks_chunked(bs.path_freq, tr)
            bp_rand_d, bp_rand_nb_d = rand_fn(bs.site_counts, bs.kmer_breaks,
                                              uni_all)
            bp_score = np.asarray(bs.bp_score)
            bp_nb = np.asarray(bs.bp_score_norm_by_break_freqs)
            bp_nl = np.asarray(bs.bp_score_norm_by_len)
            kmer_breaks = np.asarray(bs.kmer_breaks)
            bp_rand = np.asarray(bp_rand_d)
            bp_rand_nb = np.asarray(bp_rand_nb_d)
        plv = np.asarray(pl).astype(np.float32)
        bp_rand_nl = bp_rand / np.maximum(plv, 1.0)

        for gi, b in enumerate(chunk):
            sols = solutions[b]
            n_real = len(sols)
            order = np.argsort(-bp_score[gi, :n_real], kind="stable")
            plens_b = np.asarray(pl)[gi]
            max_len = int(plens_b.max()) if n_real else 0
            contig_frac = min(100.0, 100.0 * max_len / cfg.seq_len)
            ksv = ks[gi]
            cols = {
                "sequence": [sols[i] for i in order],
                "sequence_len": plens_b[order],
                "bp_score_true": bp_score[gi][order],
                "bp_score_norm_by_break_freqs_true": bp_nb[gi][order],
                "bp_score_norm_by_len_true": bp_nl[gi][order],
                "kmer_breaks": kmer_breaks[gi][order],
                "lev_dist_vs_true": lev[gi][order],
                "stat_test_KS_true": ksv[order],
                "contig_frac_len": np.full(n_real, contig_frac),
                "bp_score_random": bp_rand[gi][order],
                "bp_score_norm_by_break_freqs_random": bp_rand_nb[gi][order],
                "bp_score_norm_by_len_random": bp_rand_nl[gi][order],
                "stat_test_KS_random": ksv[order],
            }
            n_reads = int(read_valid[b].sum())
            acgt = np.bincount(
                genome_mat[b][genome_mat[b] <= 3], minlength=4
            )
            stats = {
                "base_composition": (acgt / L).tolist(),
                "coverage": round(n_reads * cfg.read_len / L, 3),
                "nr_of_reads": n_reads,
                "genome_seq": segments[b],
            }
            results[b] = ExperimentResult(
                columns=cols, stats=stats, timings=dict(timer.times)
            )

    with timer.stage("Merging + evaluating solutions (overlapped)"):
        from concurrent.futures import ThreadPoolExecutor

        pending: dict[tuple, list[int]] = defaultdict(list)
        # one worker: each native merge already fans out across all host
        # cores (native/gadev.cpp thread pool); the ctypes call releases the
        # GIL, so merges of later segments run while the main thread packs
        # and the device scores earlier ones
        with ThreadPoolExecutor(max_workers=1) as pool:
            futs = [
                pool.submit(assemble_solutions, c, cfg.dbg_kmer, cfg.seed,
                            cfg.n_orderings, backend=cfg.merge_backend)
                for c in contig_sets
            ]
            for b in range(B):
                solutions[b] = futs[b].result()
                pmat, plens = pack_strings(solutions[b], s_multiple=64,
                                           l_multiple=128)
                uniq, counts = dedup_reads(read_codes[b], read_valid[b])
                rcds, rcnt, rvld = pad_reads(uniq, counts, cfg.read_chunk)
                packed[b] = (pmat, plens, rcds, rcnt, rvld)
                key = (pmat.shape, rcds.shape)
                _prewarm_score(key)
                pending[key].append(b)
                if len(pending[key]) >= _group_cap(key):
                    _score_chunk(pending.pop(key), _group_cap(key))
            for key in list(pending):
                _score_chunk(pending.pop(key), _group_cap(key))

    compile_pool.shutdown(wait=False)
    return results[:B_out]  # type: ignore[return-value]
