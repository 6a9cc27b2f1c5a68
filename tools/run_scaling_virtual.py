"""Commit a scaling methodology record on the virtual 8-device CPU mesh.

This tool measures the FULL production per-experiment
step — run_experiments_batched: simulate -> dBG+walk -> merge -> score ->
KS -> Levenshtein — at 1/2/4/8 virtual devices (seg data parallelism) plus a
(seg x read x tp) mesh exercising the collective score step, and records
wall-clock + parallel efficiency to studies/scaling_virtual.json.

CPU-mesh timings are a correctness-of-methodology record (the shard_map
programs, collectives, and sharding layouts are the ones a multi-device run
uses); absolute numbers are not device claims and the JSON says so.

Run: python tools/run_scaling_virtual.py   (forces JAX_PLATFORMS=cpu, 8 dev)
"""
import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.parallel.mesh import make_mesh
from genomeassembler_dev.pipeline.batch_runner import run_experiments_batched
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.sim.segments import synthetic_genome


def main():
    cfg = ExperimentConfig(seq_len=500, read_len=12, dbg_kmer=9,
                           coverage_target=30.0, kmer=8, seed=1234,
                           n_orderings=500)
    B = 8
    segs = [synthetic_genome(1000 + i, cfg.seq_len) for i in range(B)]
    table = load_default_query_table()

    meshes = [("1dev", None)] + [
        (f"seg{n}", make_mesh(seg=n, read=1, tp=1)) for n in (2, 4, 8)
    ] + [("seg2xread2xtp2", make_mesh(seg=2, read=2, tp=2))]

    points = []
    ref_cols = None
    for name, mesh in meshes:
        run_experiments_batched(cfg, segs, table, mesh=mesh)  # compile pass
        t0 = time.perf_counter()
        res = run_experiments_batched(cfg, segs, table, mesh=mesh)
        dt = time.perf_counter() - t0
        cols = [r.columns["bp_score_true"].tolist() for r in res]
        if ref_cols is None:
            ref_cols = cols
        bitwise_equal = all(
            len(a) == len(b) and all(abs(x - y) <= 1e-6 * max(abs(x), 1.0)
                                     for x, y in zip(a, b))
            for a, b in zip(cols, ref_cols))
        points.append({"mesh": name, "wall_s": round(dt, 3),
                       "experiments_per_s": round(B / dt, 3),
                       "matches_single_device": bitwise_equal})
        print(points[-1], flush=True)
        _write(cfg, B, points)  # incremental: a timeout still leaves a record

    _write(cfg, B, points)


def _write(cfg, B, points):
    base = points[0]["experiments_per_s"]
    for p in points:
        n = {"1dev": 1, "seg2": 2, "seg4": 4, "seg8": 8,
             "seg2xread2xtp2": 8}[p["mesh"]]
        p["parallel_efficiency_vs_ideal"] = round(
            p["experiments_per_s"] / (base * n), 3)

    out = {
        "note": ("virtual 8-device CPU mesh; methodology record — "
                 "shard_map programs, psum/all_to_all collectives, and "
                 "sharding layouts are the production ones; absolute times "
                 "are CPU-bound (2 host cores oversubscribed 8 virtual "
                 "devices) and are NOT device performance claims"),
        "config": {"seq_len": cfg.seq_len, "read_len": cfg.read_len,
                   "dbg_kmer": cfg.dbg_kmer, "n_orderings": cfg.n_orderings,
                   "batch": B},
        "points": points,
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "studies", "scaling_virtual.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
