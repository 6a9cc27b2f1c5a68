"""Warm steady-state timings for the big-k flagships (VERDICT r3 weak #5).

Runs BASELINE config 1 (50 kb / 150 bp / k=31) twice in ONE process —
cold (compile-inclusive) then warm (every jit cached) — for both the
standard and the biased traversal, and writes per-stage timings to
studies/bigk_warm.json. Run on the GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from genomeassembler_dev.pipeline.assembler import Assembler
    from genomeassembler_dev.pipeline.config import ExperimentConfig
    from genomeassembler_dev.sim.segments import synthetic_segment_store

    seg = synthetic_segment_store(1234, 50000, 1).seqs[0]
    out = {}
    for traversal in ("standard", "biased"):
        cfg = ExperimentConfig(
            seq_len=50000, read_len=150, dbg_kmer=31, kmer=8,
            coverage_target=40.0, seed=1234, n_orderings=10000,
            traversal=traversal)
        asm = Assembler(cfg, verbose=True)
        runs = {}
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            res = asm.run_experiment(seg)
            dt = time.perf_counter() - t0
            runs[label] = {
                "total_s": round(dt, 2),
                "stages_s": {k: round(v, 3) for k, v in res.timings.items()},
                "n_solutions": res.n_solutions,
                "best_len": int(max(len(s) for s in res.columns["sequence"]))
                if res.n_solutions else 0,
                "best_lev": int(min(res.columns["lev_dist_vs_true"]))
                if res.n_solutions else -1,
            }
            print(f"{traversal} {label}: {dt:.1f} s, "
                  f"{res.n_solutions} solutions", flush=True)
        out[traversal] = runs
    out_path = os.environ.get("GA_BIGK_OUT", "studies/bigk_warm.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
