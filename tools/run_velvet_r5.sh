#!/bin/bash
# Round-5 full-scale velvet-shape study: the reference grid
# (scripts/00_Real_vs_rand_prob_velvet.R:20-30) at 200 experiments/row.
# External contigs simulate velvet output per row: tiles overlapping by
# exactly dbg_kmer-1 (the velvet hash-length contract), so the shuffled
# ensemble reconstructs the full segment. One study-velvet call per row
# (each row needs its own contigs dir); the final call re-runs the full
# grid with skip-if-exists resume to emit the cross-row aggregation.
set -u
cd "$(dirname "$0")/.."
W=studies/velvet_r5
run_row() {
  rl=$1; k=$2
  echo "=== row ${rl}:${k} $(date +%T) ==="
  python -m genomeassembler_dev.cli study-velvet --workdir $W \
    --seq-len 50000 --total-iters 200 --grid ${rl}:${k} \
    --contigs-dir $W/contigs_k${k} --verbose 2>&1 | tail -2
}
run_row 12 11
run_row 14 13
run_row 16 13
run_row 18 15
run_row 20 17
run_row 25 19
run_row 40 37
echo "=== aggregation pass $(date +%T) ==="
# NB: aggregation-only; every row's artifacts exist so nothing re-runs, but
# run_velvet_study still needs per-row contig dirs to construct sources —
# re-aggregate per row and merge in python instead
python - <<'EOF'
import csv, os
rows_sum, rows_all = [], []
grid = [(12,11),(14,13),(16,13),(18,15),(20,17),(25,19),(40,37)]
import numpy as np
from genomeassembler_dev.pipeline import results as res_io
from genomeassembler_dev.pipeline.config import ExperimentConfig
base = ExperimentConfig(seq_len=50000, coverage_target=40.0, kmer=8,
                        seed=1234, industry_standard=True)
for rl, k in grid:
    cfg = base.with_(read_len=rl, dbg_kmer=k)
    for i in range(1, 201):
        p = res_io.solutions_path("studies/velvet_r5", i, cfg)
        if not os.path.exists(p):
            continue
        cols = res_io.load_result_columns(p)
        for key in ("stat_test_KS_true", "stat_test_KS_random",
                    "bp_score_norm_by_len_true", "bp_score_norm_by_len_random"):
            vals = cols.get(key, [])
            mean = float(np.nanmean(vals)) if len(vals) else float("nan")
            rows_sum.append([rl, k, key.rsplit("_", 1)[0], mean,
                             key.endswith("_random")])
        n_sol = len(cols.get("sequence_len", []))
        for r in range(n_sol):
            rows_all.append([
                rl, k, i,
                cols["sequence_len"][r], cols["kmer_breaks"][r],
                cols["bp_score_norm_by_break_freqs_true"][r],
                cols["bp_score_norm_by_len_true"][r],
                cols["bp_score_true"][r], cols["bp_score_random"][r],
                cols["lev_dist_vs_true"][r], cols["stat_test_KS_true"][r]])
out = "studies/velvet_r5/IndustryModel_True"
os.makedirs(out, exist_ok=True)
with open(out + "/results_summary.csv", "w", newline="") as f:
    w = csv.writer(f)
    w.writerow(["read_len", "dbg_kmer", "Key", "Value", "random_prob"])
    w.writerows(rows_sum)
with open(out + "/results_all.csv", "w", newline="") as f:
    w = csv.writer(f)
    w.writerow(["read_len", "dbg_kmer", "experiment", "sequence_len",
                "kmer_breaks", "bp_score_norm_by_break_freqs_true",
                "bp_score_norm_by_len_true", "bp_score_true",
                "bp_score_random", "lev_dist_vs_true", "stat_test_KS_true"])
    w.writerows(rows_all)
print("aggregated", len(rows_all), "solution rows")
EOF
echo "=== done $(date +%T) ==="
