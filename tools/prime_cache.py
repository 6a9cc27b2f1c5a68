"""Pre-seed the persistent compile cache for known study/bench shapes.

A fresh process on a new shape compiles every stage program first. Every
stage program's shape is a pure function of the ExperimentConfig, so this
tool runs ONE tiny-batch pass per requested grid row — populating the
persistent compile cache ($JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache)
— after which any study or bench process on those shapes starts warm (cache
loads, not compiles). Whether the H100 needs it is ROADMAP D1/S6.

Usage:
  python tools/prime_cache.py bench          # the bench e2e shape (1 kb)
  python tools/prime_cache.py own            # the own-study grid (1 kb rows)
  python tools/prime_cache.py velvet         # the velvet grid (50 kb rows)
  python tools/prime_cache.py config1        # BASELINE config 1 (50 kb k=31)
  python tools/prime_cache.py bench own      # any combination
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.pipeline.config import ExperimentConfig
from genomeassembler_dev.sim.segments import synthetic_genome


def prime_batched(cfg, n_segs=2):
    from genomeassembler_dev.pipeline.batch_runner import (
        run_experiments_batched,
    )

    segs = [synthetic_genome(1000 + i, cfg.seq_len) for i in range(n_segs)]
    t0 = time.time()
    run_experiments_batched(cfg, segs, load_default_query_table())
    print(f"  primed rl={cfg.read_len} k={cfg.dbg_kmer} seq={cfg.seq_len} "
          f"in {time.time() - t0:.1f}s", flush=True)


def prime_serial(cfg):
    from genomeassembler_dev.pipeline.assembler import Assembler

    t0 = time.time()
    asm = Assembler(cfg, load_default_query_table())
    asm.run_experiment(synthetic_genome(1000, cfg.seq_len))
    print(f"  primed serial rl={cfg.read_len} k={cfg.dbg_kmer} "
          f"seq={cfg.seq_len} traversal={cfg.traversal} "
          f"in {time.time() - t0:.1f}s", flush=True)


def main(targets):
    if "bench" in targets:
        print("bench e2e shape:", flush=True)
        prime_batched(ExperimentConfig(
            seq_len=1000, read_len=12, dbg_kmer=9, coverage_target=40.0,
            kmer=8, seed=1234, n_orderings=10000), n_segs=32)
    if "own" in targets:
        print("own-study grid:", flush=True)
        base = ExperimentConfig(seq_len=1000, coverage_target=40.0, kmer=8,
                                seed=1234)
        for rl, k in ExperimentConfig.OWN_STUDY_GRID:
            prime_batched(base.with_(read_len=rl, dbg_kmer=k))
    if "velvet" in targets:
        # the velvet eval path runs through IndustryAssembler.run_external;
        # external tiles reproduce the production bucket shapes
        print("velvet grid:", flush=True)
        from genomeassembler_dev.pipeline.velvet import IndustryAssembler

        table = load_default_query_table()
        for rl, k in ExperimentConfig.VELVET_STUDY_GRID:
            cfg = ExperimentConfig(
                seq_len=50000, read_len=rl, dbg_kmer=k, coverage_target=40.0,
                kmer=8, seed=1234, industry_standard=True)
            seg = synthetic_genome(1000, 50000)
            step = 3000 - 600
            tiles = [seg[lo:lo + 3000] for lo in range(0, 50000 - 600, step)]
            t0 = time.time()
            IndustryAssembler(cfg, table).run_external(seg, tiles)
            print(f"  primed velvet rl={rl} k={k} in {time.time() - t0:.1f}s",
                  flush=True)
    if "config1" in targets:
        print("BASELINE config 1 (50 kb, k=31):", flush=True)
        for traversal in ("standard", "biased"):
            prime_serial(ExperimentConfig(
                seq_len=50000, read_len=150, dbg_kmer=31, coverage_target=40.0,
                kmer=8, seed=1234, n_orderings=10000, traversal=traversal))


if __name__ == "__main__":
    main(sys.argv[1:] or ["bench"])
