#!/usr/bin/env python
"""Smoke test of the assembler's main path on an NVIDIA GPU (H100).

    python chip_smoke.py              # one GPU: phases (a)-(f)
    python chip_smoke.py --four-gpus  # four GPUs: the multi-device path only

Run from the repository root. Every phase drives the normal entry points at
the reference's study scale and compares against the repository's own
references:

  (a) preconditions: JAX's device is a GPU, the native engine and the Myers
      CUDA kernel build and load;
  (b) Levenshtein: the GPU implementation vs the prefix-min DP on the card at
      three real shapes, and vs spec.levenshtein on small edge cases;
  (c) bench.py's headline fused step at 1024 x 1 kb, segment 0's contigs vs
      the native engine;
  (d) the batched own-path runner at 32 x 1 kb, 40x, 10,000 orderings for
      grid rows (12, 9) and (16, 13), two experiments per row vs the spec;
  (e) the velvet path on a 50 kb segment with 20,000 orderings and a 50 kb
      HW Levenshtein;
  (f) BASELINE config 1 (50 kb, 150 bp reads, k = 31, big-k dBG path).

Tolerances: contigs, solutions, k-mer breaks and edit distances exact;
bp-score columns rtol 2e-5 (f32 sums in another order); KS atol 1e-6.

Prints the card's name and power limit, each phase's wall time and result,
and as its last line {"ok": true, "device": {...}}. A failed check raises,
so the script exits non-zero and prints no result line; it also exits
non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev.core.encoding import decode_dna, encode_dna  # noqa: E402
from genomeassembler_dev.core.querytable import (  # noqa: E402
    QueryTable, load_default_query_table)
from genomeassembler_dev.ops.edit_distance import (  # noqa: E402
    batched_levenshtein, batched_levenshtein_auto)
from genomeassembler_dev.pipeline.config import ExperimentConfig  # noqa: E402
from genomeassembler_dev.sim.segments import (  # noqa: E402
    synthetic_genome, synthetic_segment_store)
from genomeassembler_dev.spec import reference_semantics as spec  # noqa: E402

RTOL_BP = 2e-5
ATOL_KS = 1e-6

# the reference's study scale (scripts/02_…:21-31, scripts/00_…:20-30)
OWN_LEN, OWN_SEGMENTS, ORDERINGS = 1000, 32, 10000
VELVET_LEN = 50000
HEADLINE_B = 1024
LEV_OWN = 512  # solutions per own-path Levenshtein group
LEV_VELVET = 8  # velvet solutions per segment
LEV_BENCH = (2048, 2048, 50000)  # queries, query length, target length


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"[{name}] start")
    yield
    log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def assert_exact(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    bad = np.flatnonzero(got != want)
    check(got.shape == want.shape and bad.size == 0,
          f"{what}: {bad.size} mismatches, first at {bad[:5].tolist()}")


# --- (a) -------------------------------------------------------------------


def preconditions(n_devices: int) -> None:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}")
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: needs {n_devices} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    from genomeassembler_dev.merge import native
    from genomeassembler_dev.ops.myers_cuda import build_library

    check(native.available(), "native engine (native/libgadev.so) did not build")
    log(f"native engine: {native._SO_PATH}")
    log(f"Myers CUDA kernel: {build_library()}")


# --- (b) -------------------------------------------------------------------


def mutate(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    """Random substitutions, deletions and (duplicating) insertions."""
    u = rng.random(codes.size)
    out = codes.copy()
    sub = (u >= rate / 3) & (u < 2 * rate / 3)
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reps = np.where(u < rate / 3, 0, np.where(u < 2 * rate / 3, 1,
                                              np.where(u < rate, 2, 1)))
    return np.repeat(out, reps).astype(np.uint8)


def pack(rows: list[np.ndarray], multiple: int = 128):
    M = -(-max(len(r) for r in rows) // multiple) * multiple
    qm = np.zeros((len(rows), M), np.uint8)
    for i, r in enumerate(rows):
        qm[i, : len(r)] = r
    return qm, np.array([len(r) for r in rows], np.int32)


def lev_vs_reference(name, queries, qlens, target, mode, ref_rows=None):
    """The GPU implementation on every row vs the prefix-min DP on the card
    (on the first `ref_rows` rows when given): exact."""
    q, ql, t = jnp.asarray(queries), jnp.asarray(qlens), jnp.asarray(target)
    got = np.asarray(jax.block_until_ready(
        batched_levenshtein_auto(q, ql, t, mode=mode)))
    t0 = time.perf_counter()
    got = np.asarray(jax.block_until_ready(
        batched_levenshtein_auto(q, ql, t, mode=mode)))
    t_impl = time.perf_counter() - t0
    n = ref_rows or q.shape[0]
    t0 = time.perf_counter()
    want = np.asarray(jax.block_until_ready(
        batched_levenshtein(q[:n], ql[:n], t, mode=mode)))
    t_ref = time.perf_counter() - t0
    assert_exact(got[:n], want, f"Levenshtein {name}")
    log(f"  {name}: {q.shape[0]} x {q.shape[1]} vs {t.shape[0]} {mode}: "
        f"{t_impl * 1e3:.1f} ms; prefix-min reference on {n} rows "
        f"{t_ref * 1e3:.1f} ms (incl. compile); exact, "
        f"distances {int(want.min())}..{int(want.max())}")


def phase_levenshtein() -> None:
    rng = np.random.default_rng(7)
    # own-path NW: 512 solutions of ~1 kb vs the 1 kb segment
    tgt = encode_dna(synthetic_genome(5, OWN_LEN))
    qs = [mutate(rng, tgt, rate) for rate in rng.uniform(0.0, 0.2, LEV_OWN)]
    lev_vs_reference("own-path NW", *pack(qs), tgt, "NW")
    # velvet HW: 8 solutions of ~50 kb vs the 50 kb segment
    tgt = encode_dna(synthetic_genome(6, VELVET_LEN))
    qs = [tgt.copy(), tgt[VELVET_LEN // 50 : VELVET_LEN * 4 // 5].copy()] + [
        mutate(rng, tgt, rate)
        for rate in np.geomspace(0.001, 0.2, LEV_VELVET - 2)]
    lev_vs_reference("velvet HW", *pack(qs), tgt, "HW")
    # bench HW: 2048 x 2048 random queries vs a 50 kb target (row subset)
    S, M, N = LEV_BENCH
    lev_vs_reference("bench HW", rng.integers(0, 4, (S, M)).astype(np.uint8),
                     np.full(S, M, np.int32),
                     rng.integers(0, 4, N).astype(np.uint8), "HW",
                     ref_rows=min(S, 128))
    # edge cases vs the string-level spec
    target = synthetic_genome(8, 150)
    cases = {
        "single-word": [synthetic_genome(9, 20), target[10:40]],
        "multi-word": [synthetic_genome(10, 200), target + "ACGT" * 10,
                       target[5:140]],
        "empty": ["", target[:1]],
        "query longer than target": [synthetic_genome(11, 400), target * 2],
    }
    for mode in ("NW", "HW"):
        for case, strs in cases.items():
            qm, ql = pack([encode_dna(s) for s in strs], 32)
            got = np.asarray(batched_levenshtein_auto(
                jnp.asarray(qm), jnp.asarray(ql),
                jnp.asarray(encode_dna(target)), mode=mode))
            want = [spec.levenshtein(s, target, mode=mode) for s in strs]
            assert_exact(got, want, f"Levenshtein {mode} {case} vs spec")
    log("  NW/HW x single-word, multi-word, empty, longer-than-target: "
        "exact vs spec.levenshtein")


# --- (c) -------------------------------------------------------------------


def phase_headline(table) -> None:
    import bench
    from genomeassembler_dev.dbg.assemble import dedup_contigs
    from genomeassembler_dev.merge import native

    B = HEADLINE_B
    read_codes, read_valid = bench.simulate_batch(B, table)
    step = jax.jit(jax.vmap(bench.per_segment))
    out = jax.block_until_ready(step(read_codes, read_valid))
    t0 = time.perf_counter()
    out = jax.block_until_ready(step(read_codes, read_valid))
    t_step = time.perf_counter() - t0
    _, n_walks, n_oct, n_u = (np.asarray(x) for x in out)
    valid = np.asarray(read_valid)
    check((n_walks <= bench.MAX_WALKS).all(), "walk capacity exceeded")
    check((n_u <= bench.U_CAP).all(), "read dedup capacity exceeded")
    check(int(n_oct.sum()) == int((valid.sum(1) * (bench.READ_LEN - 8 + 1)).sum()),
          "weighted octamer count != total windows")

    codes0 = np.asarray(read_codes[0])
    seg0 = jax.jit(bench.headline_segment)(read_codes[0], read_valid[0])
    buf, lens, wvalid, ovf = (np.asarray(x) for x in seg0[:4])
    got = dedup_contigs(buf, lens, wvalid, ovf)
    reads0 = [decode_dna(r) for r, ok in zip(codes0, valid[0]) if ok]
    want = native.contigs_from_reads_native(reads0, bench.DBG_K)
    check(got == want, "segment 0 contigs != native engine")
    log(f"  fused step B={B}: {t_step * 1e3:.2f} ms/batch warm, "
        f"{int(valid.sum())} reads; segment 0: {len(got)} contigs == native")


# --- (d) -------------------------------------------------------------------


def compare_with_spec(res, segment: str, cfg: ExperimentConfig, table) -> int:
    """Every column of one own-path experiment vs the spec pipeline run on
    the same read set. Returns the number of solutions."""
    from genomeassembler_dev.sim.reads import generate_reads

    rs = generate_reads(jax.random.key(cfg.seed), encode_dna(segment), table,
                        cfg.read_len, cfg.coverage_target, cfg.kmer)
    reads = [decode_dna(r) for r, ok in
             zip(np.asarray(rs.codes), np.asarray(rs.valid)) if ok]
    kmers = [r[i : i + cfg.dbg_kmer] for r in reads
             for i in range(cfg.read_len - cfg.dbg_kmer + 1)]
    contigs = spec.get_contig_set(kmers, cfg.dbg_kmer)
    sols = spec.assemble_solutions(
        spec.shuffled_orderings(contigs, cfg.seed, cfg.n_orderings),
        cfg.dbg_kmer)
    cols = res.columns
    check(sorted(cols["sequence"]) == sorted(sols), "solution set != spec")
    sp = spec.calc_breakscore(sols, reads, segment, cfg.kmer, table)
    sr = spec.calc_breakscore(sols, reads, segment, cfg.kmer, QueryTable.uniform())
    pos = {s: i for i, s in enumerate(sols)}
    idx = [pos[s] for s in cols["sequence"]]
    assert_exact(cols["sequence_len"], [len(sols[i]) for i in idx], "sequence_len")
    assert_exact(cols["kmer_breaks"], sp["kmer_breaks"][idx], "kmer_breaks")
    assert_exact(cols["lev_dist_vs_true"], sp["lev_dist_vs_true"][idx],
                 "lev_dist_vs_true")
    for col, ref in (("bp_score_true", sp["bp_score"]),
                     ("bp_score_norm_by_break_freqs_true",
                      sp["bp_score_norm_by_break_freqs"]),
                     ("bp_score_norm_by_len_true", sp["bp_score_norm_by_len"]),
                     ("bp_score_random", sr["bp_score"]),
                     ("bp_score_norm_by_break_freqs_random",
                      sr["bp_score_norm_by_break_freqs"]),
                     ("bp_score_norm_by_len_random", sr["bp_score_norm_by_len"])):
        np.testing.assert_allclose(cols[col], ref[idx], rtol=RTOL_BP, err_msg=col)
    track = np.asarray(rs.track)
    track_nz = track[track > 0]
    hit = [r for r, i in enumerate(idx) if sp["kmer_breaks"][i] > 0]
    ks_want = [spec.ks_2samp(sp["path_freq"][idx[r]].astype(np.float32),
                             track_nz) for r in hit]
    for col in ("stat_test_KS_true", "stat_test_KS_random"):
        np.testing.assert_allclose(np.asarray(cols[col])[hit], ks_want,
                                   atol=ATOL_KS, err_msg=col)
    frac = min(100.0, 100.0 * max(len(s) for s in sols) / cfg.seq_len)
    np.testing.assert_allclose(cols["contig_frac_len"], frac, err_msg="contig_frac")
    check(res.stats["nr_of_reads"] == len(reads), "nr_of_reads")
    return len(sols)


def phase_own_batched(table, read_len: int, dbg_kmer: int) -> None:
    from genomeassembler_dev.pipeline.batch_runner import run_experiments_batched

    cfg = ExperimentConfig(seq_len=OWN_LEN, read_len=read_len,
                           dbg_kmer=dbg_kmer, coverage_target=40.0, kmer=8,
                           seed=1234, n_orderings=ORDERINGS)
    segs = [synthetic_genome(1000 + i, OWN_LEN) for i in range(OWN_SEGMENTS)]
    t0 = time.perf_counter()
    res = run_experiments_batched(cfg, segs, table)
    t_run = time.perf_counter() - t0
    check(len(res) == len(segs) and all(r.n_solutions >= 1 for r in res),
          "batched runner lost experiments")
    n_sols = [compare_with_spec(res[b], segs[b], cfg, table) for b in (0, 1)]
    log(f"  row ({read_len}, {dbg_kmer}): {len(segs)} experiments in "
        f"{t_run:.1f} s (cold); experiments 0, 1 ({n_sols} solutions) == spec")


# --- (e) -------------------------------------------------------------------


def phase_velvet(table) -> None:
    from genomeassembler_dev.pipeline.velvet import IndustryAssembler
    from tools.make_external_contigs import tile_contigs

    cfg = ExperimentConfig(seq_len=VELVET_LEN, read_len=12, dbg_kmer=11,
                           coverage_target=40.0, kmer=8, seed=1234,
                           industry_standard=True)
    seg = synthetic_segment_store(1234, VELVET_LEN, 1).seqs[0]
    # velvet-shaped output: tiles overlapping by exactly dbg_kmer - 1 (the
    # velvet hash-length contract), so the ensemble reconstructs the segment
    tiles = list(tile_contigs(seg, piece=min(3000, VELVET_LEN // 16),
                              overlap=cfg.dbg_kmer - 1).values())
    t0 = time.perf_counter()
    res = IndustryAssembler(cfg, table).run_external(seg, tiles)
    t_run = time.perf_counter() - t0
    cols = res.columns
    check(seg in cols["sequence"], "velvet tiles did not reassemble the segment")
    lev = np.asarray(cols["lev_dist_vs_true"])
    assert_exact(lev, np.zeros_like(lev), "velvet HW Levenshtein of substrings")
    log(f"  velvet (12, 11): {len(tiles)} tiles, 20,000 orderings, "
        f"{len(cols['sequence'])} solutions, {t_run:.1f} s (cold); the full "
        f"{len(seg)} bp reconstruction scores HW Levenshtein 0")


# --- (f) -------------------------------------------------------------------


def phase_config1(table) -> None:
    from genomeassembler_dev.merge import native
    from genomeassembler_dev.merge.engine import assemble_solutions
    from genomeassembler_dev.pipeline.assembler import Assembler
    from genomeassembler_dev.utils.timers import StageTimer

    cfg = ExperimentConfig(seq_len=VELVET_LEN, read_len=150, dbg_kmer=31,
                           coverage_target=40.0, kmer=8, seed=1234,
                           n_orderings=ORDERINGS)
    seg = synthetic_segment_store(1234, VELVET_LEN, 1).seqs[0]
    asm = Assembler(cfg, table)
    t0 = time.perf_counter()
    res = asm.run_experiment(seg)
    t_run = time.perf_counter() - t0

    # the big-k contigs (run again: a re-execution of the compiled walk) vs
    # the native engine, and the solutions merged from them
    rs = asm.simulate(encode_dna(seg), StageTimer(False))
    reads = [decode_dna(r) for r, ok in
             zip(np.asarray(rs.codes), np.asarray(rs.valid)) if ok]
    contigs = asm.contigs(rs.codes, rs.valid, StageTimer(False))
    check(contigs == native.contigs_from_reads_native(reads, 31),
          "config 1 big-k contigs != native engine")
    sols = assemble_solutions(contigs, 31, cfg.seed, cfg.n_orderings,
                              backend="native")
    cols = res.columns
    check(sorted(cols["sequence"]) == sorted(sols), "config 1 solutions")
    top = cols["sequence"][:4]
    sp = spec.calc_breakscore(top, reads, seg, cfg.kmer, table)
    assert_exact(cols["kmer_breaks"][:4], sp["kmer_breaks"], "config 1 kmer_breaks")
    assert_exact(cols["lev_dist_vs_true"][:4], sp["lev_dist_vs_true"],
                 "config 1 NW Levenshtein")
    np.testing.assert_allclose(cols["bp_score_true"][:4], sp["bp_score"],
                               rtol=RTOL_BP, err_msg="config 1 bp_score")
    log(f"  config 1: {len(reads)} reads, {len(contigs)} contigs == native, "
        f"{len(sols)} solutions, top lengths {[len(s) for s in top]}, NW "
        f"Levenshtein {[int(x) for x in cols['lev_dist_vs_true'][:4]]} == spec; "
        f"{t_run:.1f} s (cold)")


# --- four GPUs ---------------------------------------------------------------


def four_gpus(table) -> None:
    from __graft_entry__ import dryrun_multichip
    from genomeassembler_dev.parallel.mesh import make_mesh
    from genomeassembler_dev.pipeline.batch_runner import run_experiments_batched

    with phase("dryrun_multichip(4)"):
        dryrun_multichip(4)
    with phase("batched runner: 4-way seg mesh vs one GPU"):
        cfg = ExperimentConfig(seq_len=OWN_LEN, read_len=12, dbg_kmer=9,
                               coverage_target=40.0, kmer=8, seed=1234,
                               n_orderings=ORDERINGS)
        segs = [synthetic_genome(1000 + i, OWN_LEN) for i in range(OWN_SEGMENTS)]
        t0 = time.perf_counter()
        one = run_experiments_batched(cfg, segs, table)
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        four = run_experiments_batched(cfg, segs, table,
                                       mesh=make_mesh(seg=4, read=1, tp=1))
        t_four = time.perf_counter() - t0
        check(len(one) == len(four) == len(segs), "experiment count")
        for a, b in zip(four, one):
            check(a.columns["sequence"] == b.columns["sequence"], "solutions")
            for col in ("sequence_len", "kmer_breaks", "lev_dist_vs_true"):
                assert_exact(a.columns[col], b.columns[col], col)
            for col in ("bp_score_true", "bp_score_norm_by_break_freqs_true",
                        "bp_score_norm_by_len_true", "bp_score_random",
                        "bp_score_norm_by_break_freqs_random",
                        "bp_score_norm_by_len_random"):
                np.testing.assert_allclose(a.columns[col], b.columns[col],
                                           rtol=RTOL_BP, err_msg=col)
            np.testing.assert_allclose(
                a.columns["stat_test_KS_true"], b.columns["stat_test_KS_true"],
                atol=ATOL_KS, equal_nan=True)
            check(a.stats == b.stats, "stats")
        log(f"  {len(segs)} x {OWN_LEN} bp, {ORDERINGS} orderings: one GPU "
            f"{t_one:.1f} s, 4-way seg mesh {t_four:.1f} s (both cold); every "
            f"column matches")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU path and its one-GPU comparison")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four_gpus else 1

    t_start = time.perf_counter()
    with phase("a: preconditions"):
        preconditions(n_dev)
    table = load_default_query_table()
    if args.four_gpus:
        four_gpus(table)
    else:
        with phase("b: Levenshtein at real widths"):
            phase_levenshtein()
        with phase("c: headline fused step"):
            phase_headline(table)
        with phase("d: own-path batched runner, row (12, 9)"):
            phase_own_batched(table, 12, 9)
        with phase("d: own-path batched runner, row (16, 13)"):
            phase_own_batched(table, 16, 13)
        with phase("e: velvet path"):
            phase_velvet(table)
        with phase("f: BASELINE config 1"):
            phase_config1(table)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
