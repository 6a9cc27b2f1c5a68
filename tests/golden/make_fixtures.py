"""Golden-fixture generation against the reference C++ kernels.

Builds the harness binaries (tests/golden/harness/Makefile), which compile
/root/reference/lib/{DeNovoAssembler,BreakageScorer}.cpp verbatim with shim
Rcpp/gtl/edlib headers, generates deterministic inputs (breakage-weighted
read sets over synthetic segments — the SURVEY §7.1 stored-read-set equality
gate), runs the binaries, and stores the inputs + reference outputs as JSON
under tests/golden/fixtures/.

Run `python tests/golden/make_fixtures.py` to (re)generate; tests/test_golden.py
consumes the committed fixtures and fails if our spec or any backend drifts
from the reference semantics.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

HARNESS_DIR = os.path.join(REPO, "tests", "golden", "harness")
FIXTURE_DIR = os.path.join(REPO, "tests", "golden", "fixtures")

# (name, mode, seq_len, read_len, dbg_kmer, sim_seed, coverage)
# Coverage is kept low enough to leave k-mer gaps (dead ends) and segments
# carry planted repeats (branch nodes), so the dBG yields many contigs and
# the 10k-ordering merge fixpoint produces a rich solution set.
CASES = [
    ("own_k9_rl12", "own", 240, 12, 9, 101, 12),
    ("own_k13_rl16", "own", 300, 16, 13, 102, 10),
    ("own_k15_rl20", "own", 360, 20, 15, 103, 8),
    ("velvet_k15_rl12", "velvet", 400, 12, 15, 104, 25),
]
BREAK_KMER = 8
REF_SEED = 1234  # the mt19937 shuffle seed (scripts/02_…:21)


def build_harness() -> None:
    subprocess.run(["make", "-C", HARNESS_DIR], check=True,
                   capture_output=True)


def table_lines() -> tuple[list[str], "np.ndarray"]:
    """All 69,904 k-mer strings in canonical combined order + normalised
    probs from the repo asset (byte-equal to the reference CSVs)."""
    from genomeassembler_dev.core.querytable import load_default_query_table

    table = load_default_query_table()
    kmers = []
    for k in (2, 4, 6, 8):
        kmers.extend("".join(t) for t in itertools.product("ACGT", repeat=k))
    return kmers, table.combined


def simulate_read_set(seq_len: int, read_len: int, seed: int,
                      coverage: int) -> tuple[str, list[str]]:
    """Deterministic numpy stand-in for the read simulator: breakpoints drawn
    with replacement weighted by the per-position octamer probability track
    (GenerateReads.R:302-313 semantics incl. the 3' discard), over a
    synthetic segment with planted repeats (branch nodes in the dBG). The
    golden gate is 'given identical read sets' — these reads are recorded in
    the fixture and replayed on our side."""
    from genomeassembler_dev.core.encoding import encode_dna, kmer_codes_np
    from genomeassembler_dev.core.querytable import load_default_query_table
    from genomeassembler_dev.sim.segments import synthetic_genome

    rng = np.random.default_rng(seed)
    seg = list(synthetic_genome(seed, seq_len))
    # plant a ~25 bp motif at several spots: repeated stretches longer than
    # any dbg_kmer in CASES, creating genuine branch nodes
    motif = synthetic_genome(seed + 7, 25)
    for lo in sorted(rng.choice(seq_len - 25, size=4, replace=False)):
        seg[lo : lo + 25] = motif
    segment = "".join(seg)
    codes = encode_dna(segment)
    table = load_default_query_table()
    track = table.probs[8][kmer_codes_np(codes, 8)]  # [L-7]
    n_draws = int(np.ceil(coverage * seq_len / read_len))
    p = track / track.sum()
    starts = rng.choice(track.size, size=n_draws, replace=True, p=p)
    starts = starts[starts + read_len <= seq_len]  # 3' boundary discard
    reads = [segment[s : s + read_len] for s in starts]
    return segment, reads


def external_contigs(segment: str, piece: int = 90, overlap: int = 25) -> list[str]:
    """Velvet-shaped external contigs: overlapping tiles of the segment."""
    out = []
    step = piece - overlap
    for lo in range(0, len(segment) - overlap, step):
        out.append(segment[lo : lo + piece])
    return sorted(set(out))


def read_kmers_of(reads: list[str], dbg_kmer: int) -> list[str]:
    """Sliding dbg_kmer windows over every read (lib/DeNovoAssembler.R:109-130
    flattening order: all windows of read 1, then read 2, ...)."""
    out = []
    for r in reads:
        out.extend(r[i : i + dbg_kmer] for i in range(len(r) - dbg_kmer + 1))
    return out


def write_input(path: str, dbg_kmer: int, kmer: int, true_solution: str,
                reads: list[str], items: list[str],
                bp_kmer: list[str], bp_prob: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"{dbg_kmer} {REF_SEED} {kmer}\n")
        f.write(true_solution + "\n")
        f.write(f"{len(reads)}\n")
        f.write("\n".join(reads) + "\n")
        f.write(f"{len(items)}\n")
        f.write("\n".join(items) + "\n")
        f.write(f"{len(bp_kmer)}\n")
        for km, pr in zip(bp_kmer, bp_prob):
            f.write(f"{km} {pr:.17g}\n")


def make_fixture(name: str, mode: str, seq_len: int, read_len: int,
                 dbg_kmer: int, sim_seed: int, coverage: int,
                 bp_kmer: list[str], bp_prob: np.ndarray) -> dict:
    segment, reads = simulate_read_set(seq_len, read_len, sim_seed, coverage)
    if mode == "own":
        items = read_kmers_of(reads, dbg_kmer)
        binary = os.path.join(HARNESS_DIR, "harness_own")
    else:
        # drop one tile so the merge cannot fully reassemble the segment
        items = external_contigs(segment)
        items = items[:2] + items[3:]
        binary = os.path.join(HARNESS_DIR, "harness_velvet")
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as tf:
        input_path = tf.name
    write_input(input_path, dbg_kmer, BREAK_KMER, segment, reads, items,
                bp_kmer, bp_prob)
    out = subprocess.run([binary, input_path], check=True,
                         capture_output=True, text=True)
    os.unlink(input_path)
    reference = json.loads(out.stdout)
    return {
        "name": name,
        "mode": mode,
        "config": {
            "seq_len": seq_len,
            "read_len": read_len,
            "dbg_kmer": dbg_kmer,
            "break_kmer": BREAK_KMER,
            "seed": REF_SEED,
            "sim_seed": sim_seed,
            "coverage": coverage,
        },
        "segment": segment,
        "reads": reads,
        "external_contigs": items if mode == "velvet" else None,
        "reference": reference,
    }


def main() -> None:
    build_harness()
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    bp_kmer, bp_prob = table_lines()
    for name, mode, seq_len, read_len, dbg_kmer, sim_seed, coverage in CASES:
        fx = make_fixture(name, mode, seq_len, read_len, dbg_kmer, sim_seed,
                          coverage, bp_kmer, bp_prob)
        path = os.path.join(FIXTURE_DIR, f"{name}.json")
        with open(path, "w") as f:
            json.dump(fx, f)
        ref = fx["reference"]
        print(f"{name}: {len(ref['solutions'])} solutions, "
              f"{len(ref.get('contigs', []))} contigs -> {path}")


if __name__ == "__main__":
    main()
