"""Native-vs-device ensemble-merge crossover (VERDICT r3 weak #2).

Measures assemble_native (threaded C++) against assemble_device (one-jit
hash-chain ensemble) over contig count C and ordering count O, asserts
set-identical outputs, and prints the crossover table for studies/.

Run on the GPU (device path) — the native side is host-only either way.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, flush=True)


def make_contigs(rng, C: int, mean_len: int, k: int) -> list[str]:
    """Contigs with plantable k-1 overlaps so merges actually happen: build
    from a base sequence's overlapping windows plus random tails."""
    base = "".join(rng.choice(list("ACGT"), size=C * mean_len // 2 + 64))
    out = []
    step = max(1, (len(base) - mean_len) // max(1, C - 1))
    for i in range(C):
        s = base[i * step : i * step + mean_len]
        if rng.random() < 0.5:  # half get a random tail (no overlap)
            s = s[: mean_len // 2] + "".join(
                rng.choice(list("ACGT"), size=mean_len - mean_len // 2))
        out.append(s)
    # dedup (merge semantics require distinct strings for i!=j merging)
    seen, uniq = set(), []
    for s in out:
        if s not in seen:
            seen.add(s)
            uniq.append(s)
    return uniq


def main():
    from genomeassembler_dev.merge.device import assemble_device
    from genomeassembler_dev.merge import native

    k = 9
    rng = np.random.default_rng(0)
    rows = []
    for C in (8, 16, 32, 64, 128):
        for O in (1000, 10000):
            contigs = make_contigs(rng, C, 60, k)
            # native timing (skip the largest native shapes: minutes)
            t_nat = float("nan")
            sol_nat = None
            if native.available() and C * C * O <= 64 * 64 * 10000:
                t0 = time.perf_counter()
                sol_nat = native.assemble_native(contigs, k, 1234, O)
                t_nat = time.perf_counter() - t0
            # device timing: compile once, then time
            t0 = time.perf_counter()
            sol_dev = assemble_device(contigs, k, 1234, O)
            t_cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            sol_dev2 = assemble_device(contigs, k, 1234, O)
            t_dev = time.perf_counter() - t0
            assert sol_dev == sol_dev2
            if sol_nat is not None:
                assert set(sol_nat) == set(sol_dev), (
                    f"device != native at C={len(contigs)} O={O}")
            rows.append((len(contigs), O, t_nat, t_dev, t_cold))
            log(f"C={len(contigs):4d} O={O:6d}  native {t_nat*1e3:9.1f} ms"
                f"  device {t_dev*1e3:9.1f} ms (cold {t_cold:.1f} s)"
                f"  ratio {t_nat/t_dev if t_dev else float('nan'):7.2f}x")
    log("\n| C | O | native ms | device ms | device/native |")
    log("|---|---|---|---|---|")
    for C, O, tn, td, tc in rows:
        log(f"| {C} | {O} | {tn*1e3:.1f} | {td*1e3:.1f} | "
            f"{td/tn if tn == tn else float('nan'):.2f} |")


if __name__ == "__main__":
    main()
