#!/usr/bin/env python
"""Headline benchmark: reads/s per chip for k-mer counting + dBG build.

Workload (BASELINE.md): per segment, extract dbg_kmer-mers from all reads,
build the de Bruijn graph (edges, degrees, branch nodes), walk all contigs
(pointer-doubling traversal), and count breakage octamers — one fused jit
over a batch of segments on one chip.

Baseline: the same pipeline in single-threaded C++ (native/gadev.cpp:
hash-map dBG + rolling k-mer counter), the shape of implementation the
reference uses (lib/DeNovoAssembler.cpp).

Prints ONE JSON line to stdout:
  {"metric": ..., "value": reads/s (device), "unit": "reads/s",
   "vs_baseline": device_reads_per_s / cpp_single_core_reads_per_s,
   "device": {"platform", "kind", "count"}}
All diagnostics go to stderr. Fails when JAX finds no GPU: a CPU run would
say nothing about the device.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# one-shot emitter + watchdog: the headline payload is registered as soon as
# the core measurement exists; a watchdog hard-exits (after printing it) when
# the extras budget runs out, so a run always prints exactly one JSON line
# within bounded wall time.
_emit_lock = threading.Lock()
_emitted = False


def emit(payload: dict) -> None:
    global _emitted
    with _emit_lock:
        if not _emitted:
            print(json.dumps(payload), flush=True)
            _emitted = True


def start_watchdog(payload: dict, seconds: float) -> threading.Timer:
    def fire():
        log(f"watchdog: extras budget ({seconds:.0f}s) exhausted; emitting")
        emit(payload)
        os._exit(0)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


# headline cell: 1 kb segments, 12 bp reads at 40x, dBG k = 9
SEQ_LEN, READ_LEN, COV, DBG_K = 1000, 12, 40.0, 9
MAX_WALKS, MAX_LEN = 256, SEQ_LEN + DBG_K
U_CAP = 1024  # distinct reads/segment <= SEQ_LEN - READ_LEN + 1 = 989


def simulate_batch(B: int, table):
    """Simulated read sets for B synthetic segments (one batched jit):
    (read_codes [B, N, R], read_valid [B, N])."""
    import jax
    import jax.numpy as jnp

    from genomeassembler_dev.core.encoding import encode_dna
    from genomeassembler_dev.sim.reads import n_draws_for, simulate_reads
    from genomeassembler_dev.sim.segments import synthetic_genome

    n_draws = n_draws_for(COV, SEQ_LEN, READ_LEN)
    probs8 = jnp.asarray(table.probs[8], jnp.float32)
    genomes = jnp.asarray(
        np.stack([encode_dna(synthetic_genome(i, SEQ_LEN)) for i in range(B)])
    )
    keys = jax.random.split(jax.random.key(0), B)
    sim = jax.jit(
        jax.vmap(lambda k, g: simulate_reads(k, g, probs8, READ_LEN, n_draws))
    )
    rs = sim(keys, genomes)
    jax.block_until_ready(rs.codes)
    return rs.codes, rs.valid


def headline_segment(codes, valid):
    """The fused device step for one segment: read dedup + dense dBG + walk +
    octamer count. Dedup-with-counts comes first (the reference's own
    scoring-side move, cpp:333-337), so every downstream histogram shrinks
    ~3.5x; octamer counts are multiplicity-weighted and therefore identical
    to counting every read. Returns (contigs_dense outputs..., counts8, n_u)."""
    import jax.numpy as jnp

    from genomeassembler_dev.dbg.dense import contigs_dense
    from genomeassembler_dev.ops.dedup import (
        dedup_with_counts, pack_read_codes, unpack_kmer_windows)
    from genomeassembler_dev.ops.mxu import bincount_mxu

    packed = pack_read_codes(codes, valid)
    ucodes, ucounts, n_u = dedup_with_counts(packed, U_CAP)
    uvalid = jnp.arange(U_CAP, dtype=jnp.int32) < n_u
    kc = unpack_kmer_windows(ucodes, READ_LEN, DBG_K)
    kv = jnp.broadcast_to(uvalid[:, None], kc.shape)
    walk = contigs_dense(kc, kv, DBG_K, MAX_LEN, MAX_WALKS)
    oc = unpack_kmer_windows(ucodes, READ_LEN, 8)
    counts8 = bincount_mxu(
        oc.reshape(-1),
        jnp.broadcast_to(uvalid[:, None], oc.shape).reshape(-1),
        4**8,
        jnp.broadcast_to(ucounts[:, None], oc.shape).reshape(-1),
        weight_bits=16,  # multiplicities <= reads/segment < 2^16
    )
    return tuple(walk) + (counts8, n_u)


def per_segment(codes, valid):
    """Headline step reduced to the numbers the bench checks."""
    import jax.numpy as jnp

    buf, lens, wvalid, overflow, n_walks, n_nodes, counts8, n_u = (
        headline_segment(codes, valid))
    return jnp.where(wvalid, lens, 0).sum(), n_walks, counts8.sum(), n_u


def main():
    import jax
    import jax.numpy as jnp

    from genomeassembler_dev.core.querytable import load_default_query_table
    from genomeassembler_dev.merge import native

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")

    # B=1024 segments per batch; a B=256 group is timed alongside as an
    # extra. Both batch sizes are untuned for the H100 (ROADMAP S7).
    B = 1024
    table = load_default_query_table()

    log("simulating reads...")
    read_codes, read_valid = simulate_batch(B, table)
    n_reads_total = int(np.asarray(read_valid).sum())
    log(f"{n_reads_total} reads total ({B} segments x ~{n_reads_total // B})")

    step = jax.jit(jax.vmap(per_segment))

    log("compiling...")
    out = step(read_codes, read_valid)
    jax.block_until_ready(out)
    log(f"sanity: walks/segment ~{int(np.asarray(out[1]).mean())}, "
        f"contig chars/segment ~{int(np.asarray(out[0]).mean())}, "
        f"distinct reads/segment ~{int(np.asarray(out[3]).mean())}")
    assert (np.asarray(out[1]) <= MAX_WALKS).all(), "walk capacity exceeded"
    assert (np.asarray(out[3]) <= U_CAP).all(), "read dedup capacity exceeded"
    assert int(np.asarray(out[2]).sum()) == int(
        (np.asarray(read_valid).sum(1) * (READ_LEN - 8 + 1)).sum()
    ), "weighted octamer count != total windows"

    # correctness spot check: segment 0 contigs must match the native engine
    from genomeassembler_dev.dbg.assemble import contigs_from_read_codes

    codes0 = np.asarray(read_codes[0])
    valid0 = np.asarray(read_valid[0])
    if native.available():
        dev_contigs = contigs_from_read_codes(codes0, valid0, DBG_K, MAX_LEN)
        reads0 = ["".join("ACGT"[c] for c in row)
                  for row, ok in zip(codes0, valid0) if ok]
        cpp_contigs = native.contigs_from_reads_native(reads0, DBG_K)
        assert dev_contigs == cpp_contigs, "device contigs != native contigs"
        log(f"correctness: {len(dev_contigs)} contigs match native engine")

    REPS = 10

    def time_device_group() -> float:
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = step(read_codes, read_valid)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / REPS

    def time_cpp_pass(reads_by_seg) -> float:
        t0 = time.perf_counter()
        for reads in reads_by_seg:
            native.count_kmers_native(reads, 8)
            native.contigs_from_reads_native(reads, DBG_K)
        return time.perf_counter() - t0

    # --- interleaved device / single-core-C++ measurement -------------------
    # The C++ denominator swings ~1.7x with host load (262-455 ms observed
    # across rounds); an un-interleaved best-of-N C++ vs min-of-M device made
    # the archived ratio hostage to whichever load regime the C++ reps hit.
    # Interleave the two sides in pairs sampled under the SAME load and take
    # the median of per-pair ratios; absolute ms for both sides are reported
    # alongside so rounds stay comparable on the stable (device-ms) axis.
    vs_baseline = float("nan")
    dev_times, cpp_times, pair_ratios = [], [], []
    if native.available():
        codes_np = np.asarray(read_codes)
        valid_np = np.asarray(read_valid)
        reads_by_seg = [
            ["".join("ACGT"[c] for c in row) for row, ok in zip(cs, vs) if ok]
            for cs, vs in zip(codes_np, valid_np)
        ]
        time_device_group()  # untimed warm group after the compile
        for i in range(5):
            t_c = time_cpp_pass(reads_by_seg)
            t_t = time_device_group()
            cpp_times.append(t_c)
            dev_times.append(t_t)
            pair_ratios.append(t_c / t_t)
            log(f"pair {i}: cpp {t_c * 1e3:.1f} ms, device {t_t * 1e3:.2f} ms "
                f"-> ratio {t_c / t_t:.1f}x")
        vs_baseline = float(np.median(pair_ratios))
    else:
        log("native engine unavailable; vs_baseline = NaN")
        for _ in range(3):
            dev_times.append(time_device_group())

    t_dev = min(dev_times)
    dev_rps = n_reads_total / t_dev
    log(f"device: {t_dev * 1e3:.2f} ms/batch -> {dev_rps:,.0f} reads/s")
    extras = {
        "device_ms_per_batch": round(t_dev * 1e3, 2),
    }
    if cpp_times:
        extras["cpp_ms_best"] = round(min(cpp_times) * 1e3, 1)
        extras["cpp_ms_range"] = [round(min(cpp_times) * 1e3, 1),
                                  round(max(cpp_times) * 1e3, 1)]
        extras["ratio_pairs"] = [round(r, 1) for r in pair_ratios]
        log(f"median interleaved ratio: {vs_baseline:.1f}x "
            f"(pairs {extras['ratio_pairs']})")
    payload = {
        "metric": "reads_per_sec_kmer_count_plus_dbg_build",
        "value": round(dev_rps, 1),
        "unit": "reads/s",
        "vs_baseline": (round(vs_baseline, 3)
                        if vs_baseline == vs_baseline else None),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": extras,  # extras mutate in place as they complete
    }
    # the headline is emitted on deadline, so a long extras window risks
    # nothing but its own time
    extras_budget = float(os.environ.get("GA_BENCH_EXTRAS_S", "420"))
    t_extras0 = time.perf_counter()
    remaining = lambda: extras_budget - (time.perf_counter() - t_extras0)
    watchdog = start_watchdog(payload, extras_budget)

    # --- extra: end-to-end experiments/s (simulate -> dBG -> 10k-ordering
    # merge -> double scoring -> KS -> Levenshtein), batched runner --------
    try:
        from genomeassembler_dev.pipeline.batch_runner import (
            run_experiments_batched)
        from genomeassembler_dev.pipeline.config import ExperimentConfig
        from genomeassembler_dev.sim.segments import synthetic_genome as sg

        cfg = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9,
                               coverage_target=40.0, kmer=8, seed=1234,
                               n_orderings=10000)
        segs = [sg(1000 + i, 1000) for i in range(32)]
        tbl = load_default_query_table()
        t0 = time.perf_counter()
        res = run_experiments_batched(cfg, segs, tbl)  # compile + run
        t_cold = time.perf_counter() - t0
        assert len(res) == len(segs) and all(r.n_solutions >= 1 for r in res)
        extras["experiments_per_sec_e2e_cold"] = round(len(segs) / t_cold, 3)
        log(f"e2e batched study (cold): {len(segs)} experiments in "
            f"{t_cold:.1f} s -> {len(segs) / t_cold:.2f} experiments/s")
        if remaining() > 1.5 * t_cold / 4:  # warm pass reuses every compile
            t0 = time.perf_counter()
            res = run_experiments_batched(cfg, segs, tbl)
            t_e2e = time.perf_counter() - t0
            extras["experiments_per_sec_e2e"] = round(len(segs) / t_e2e, 3)
            log(f"e2e batched study: {len(segs)} experiments in {t_e2e:.1f} s"
                f" -> {len(segs) / t_e2e:.2f} experiments/s (warm)")
    except Exception as e:
        log(f"e2e experiments/s extra skipped: {e}")

    # --- extra: B=256 batch timing (cross-round ms/batch history) -----------
    try:
        if remaining() < 60:
            raise TimeoutError("extras budget low; skipping B=256 group")
        codes256, valid256 = read_codes[:256], read_valid[:256]
        out = step(codes256, valid256)  # separate compile (new shape)
        jax.block_until_ready(out)
        times256 = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(REPS):
                out = step(codes256, valid256)
            jax.block_until_ready(out)
            times256.append((time.perf_counter() - t0) / REPS)
        extras["device_ms_per_batch_b256"] = round(min(times256) * 1e3, 2)
        log(f"B=256 group: {min(times256) * 1e3:.2f} ms/batch "
            f"(history axis; headline batch is B={B})")
    except Exception as e:
        log(f"B=256 extra skipped: {e}")

    # --- extra: XLA-counted FLOP and byte rates of the fused headline step --
    # (from .compile().cost_analysis(); no peak shares until the benchmark
    # carries a device peak table, ROADMAP S1)
    try:
        ca = step.lower(read_codes, read_valid).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        fl = float(ca.get("flops", 0.0))
        by = float(ca.get("bytes accessed", 0.0))
        if fl > 0:
            extras["fused_step_tflops_per_sec"] = round(fl / t_dev / 1e12, 2)
            log(f"fused step: {fl / t_dev / 1e12:.2f} TFLOP/s "
                f"(XLA-counted {fl / 1e9:.1f} GFLOP/batch)")
        if by > 0:
            extras["fused_step_gb_per_sec"] = round(by / t_dev / 1e9, 1)
            log(f"fused step: {by / t_dev / 1e9:.1f} GB/s "
                f"(XLA-counted {by / 1e6:.1f} MB/batch)")
    except Exception as e:
        log(f"cost-analysis extra skipped: {e}")

    # --- extra: edit-distance throughput ------------------------------------
    try:
        if remaining() < 45:
            raise TimeoutError("extras budget low; skipping edit-distance")
        from genomeassembler_dev.ops.edit_distance import batched_levenshtein_auto

        S, M = 256, 1024
        rng = np.random.default_rng(1)
        qs = jnp.asarray(rng.integers(0, 4, (S, M)).astype(np.uint8))
        qlen = jnp.full(S, M, jnp.int32)
        tgt = jnp.asarray(rng.integers(0, 4, SEQ_LEN).astype(np.uint8))
        jax.block_until_ready(batched_levenshtein_auto(qs, qlen, tgt))
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = batched_levenshtein_auto(qs, qlen, tgt)
        jax.block_until_ready(out)
        t_lev = (time.perf_counter() - t0) / REPS
        extras["lev_nw_gcells_per_sec_256x1024x1000"] = round(
            S * M * SEQ_LEN / t_lev / 1e9, 1)
        log(f"edit distance: {S}x{M}x{SEQ_LEN} in {t_lev * 1e3:.1f} ms -> "
            f"{S * M * SEQ_LEN / t_lev / 1e9:.1f} Gcell/s "
            f"({S / t_lev:,.0f} alignments/s)")

        # HW-mode shape at the velvet-scale target length: 256 queries, one
        # rep; GA_BENCH_FULL=1 runs the full 2048x2048x50000 shape.
        if remaining() < 60:
            raise TimeoutError("extras budget low; skipping HW edit-distance")
        S2 = 2048 if os.environ.get("GA_BENCH_FULL") else 256
        M2, T2 = 2048, 50000
        qs2 = jnp.asarray(rng.integers(0, 4, (S2, M2)).astype(np.uint8))
        qlen2 = jnp.full(S2, M2, jnp.int32)
        tgt2 = jnp.asarray(rng.integers(0, 4, T2).astype(np.uint8))
        jax.block_until_ready(batched_levenshtein_auto(qs2, qlen2, tgt2,
                                                       mode="HW"))
        t0 = time.perf_counter()
        out = batched_levenshtein_auto(qs2, qlen2, tgt2, mode="HW")
        jax.block_until_ready(out)
        t_hw = time.perf_counter() - t0
        extras[f"lev_hw_gcells_per_sec_{S2}x{M2}x{T2}"] = round(
            S2 * M2 * T2 / t_hw / 1e9, 1)
        extras[f"lev_hw_alignments_per_sec_{S2}x{M2}x{T2}"] = round(S2 / t_hw, 1)
        log(f"edit distance HW: {S2}x{M2}x{T2} in {t_hw:.2f} s -> "
            f"{S2 * M2 * T2 / t_hw / 1e9:.1f} Gcell/s")
    except Exception as e:  # extras must not break the bench
        log(f"edit-distance extras skipped: {e}")

    watchdog.cancel()
    emit(payload)


if __name__ == "__main__":
    main()
