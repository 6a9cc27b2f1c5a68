"""Time the Myers CUDA kernel against the plain-XLA Myers on the GPU.

    python tools/lev_timing.py [--reps N]

Three kernel shapes (own-path NW 512 x ~1 kb vs 1 kb; velvet HW 8 x 50 kb
vs 50 kb; bench HW 2048 x 2048 vs 50 kb) and two end-to-end runs (one
own-path batch of 32 x 1 kb at 10,000 orderings through
run_experiments_batched; one velvet experiment at 50 kb with 20,000
orderings), each with both implementations swapped in behind
`ops.edit_distance.levenshtein_impl`. End-to-end runs alternate kernel,
plain, plain, kernel after one untimed warm run of each. Prints one line per
measurement and a JSON summary as the last line. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from genomeassembler_dev.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev.ops import edit_distance as ed  # noqa: E402
from genomeassembler_dev.ops.myers_cuda import batched_levenshtein_cuda  # noqa: E402
from genomeassembler_dev.pipeline import batch_runner  # noqa: E402
from genomeassembler_dev.pipeline.config import ExperimentConfig  # noqa: E402
from genomeassembler_dev.sim.segments import (  # noqa: E402
    synthetic_genome, synthetic_segment_store)

IMPLS = {"kernel": batched_levenshtein_cuda,
         "plain": ed.batched_levenshtein_myers}


_lev_jit = batch_runner._lev_jit
_runner_lev = {}


def use(name: str) -> None:
    """Route every pipeline Levenshtein call to one implementation. The
    batched runner's jitted Levenshtein stage is built once per
    implementation, so switching does not retrace or recompile it."""
    ed.levenshtein_impl = lambda: IMPLS[name]
    if name not in _runner_lev:
        _lev_jit.cache_clear()
        _runner_lev[name] = _lev_jit(None)
    batch_runner._lev_jit = lambda mesh: _runner_lev[name]


def timed(fn, reps: int) -> float:
    jax.block_until_ready(fn())  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def shapes():
    rng = np.random.default_rng(7)
    tgt = encode_dna(synthetic_genome(5, 1000))
    own = chip_smoke.pack([chip_smoke.mutate(rng, tgt, r)
                           for r in rng.uniform(0.0, 0.2, 512)]) + (tgt, "NW")
    tgt = encode_dna(synthetic_genome(6, 50000))
    vel = chip_smoke.pack([chip_smoke.mutate(rng, tgt, r)
                           for r in np.geomspace(0.001, 0.2, 8)]) + (tgt, "HW")
    bench = (rng.integers(0, 4, (2048, 2048)).astype(np.uint8),
             np.full(2048, 2048, np.int32),
             rng.integers(0, 4, 50000).astype(np.uint8), "HW")
    return {"own_nw_512x1k_vs_1k": own, "velvet_hw_8x50k_vs_50k": vel,
            "bench_hw_2048x2048_vs_50k": bench}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("lev_timing.py needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi, "kernel_s": {}, "plain_s": {}}

    for name, (q, ql, t, mode) in shapes().items():
        args_d = (jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t))
        for impl in ("kernel", "plain"):
            reps = args.reps if impl == "kernel" else 1
            s = timed(lambda: IMPLS[impl](*args_d, mode=mode), reps)
            out[f"{impl}_s"][name] = s
            print(f"{name} {impl}: {s * 1e3:.2f} ms", flush=True)

    table = load_default_query_table()
    from genomeassembler_dev.pipeline.batch_runner import run_experiments_batched
    from genomeassembler_dev.pipeline.velvet import IndustryAssembler
    from tools.make_external_contigs import tile_contigs

    own_cfg = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9,
                               coverage_target=40.0, kmer=8, seed=1234,
                               n_orderings=10000)
    segs = [synthetic_genome(1000 + i, 1000) for i in range(32)]
    vel_cfg = ExperimentConfig(seq_len=50000, read_len=12, dbg_kmer=11,
                               coverage_target=40.0, kmer=8, seed=1234,
                               industry_standard=True)
    seg = synthetic_segment_store(1234, 50000, 1).seqs[0]
    tiles = list(tile_contigs(seg, overlap=vel_cfg.dbg_kmer - 1).values())
    runs = {
        "e2e_own_batch_32x1k": lambda: run_experiments_batched(
            own_cfg, segs, table),
        "e2e_velvet_50k": lambda: IndustryAssembler(vel_cfg, table)
        .run_external(seg, tiles),
    }
    for name, run in runs.items():
        for impl in ("kernel", "plain"):  # untimed warm runs
            use(impl)
            run()
        times = {"kernel": [], "plain": []}
        for impl in ("kernel", "plain", "plain", "kernel"):
            use(impl)
            t0 = time.perf_counter()
            run()
            times[impl].append(time.perf_counter() - t0)
        for impl, ts in times.items():
            out[f"{impl}_s"][name] = ts
            print(f"{name} {impl}: {[round(x, 3) for x in ts]} s", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
