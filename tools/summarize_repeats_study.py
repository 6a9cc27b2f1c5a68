"""Summarize the round-3 repeat-bearing study: per-grid-row ANOVA/Spearman
(the reference's significance tests, scripts/02_…:548-588) plus solution
diversity — the statistic the round-2 uniform-random segments lacked (5/7
rows collapsed to one solution per experiment)."""
import csv
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from genomeassembler_dev.pipeline.experiments import study_statistics

workdir = sys.argv[1] if len(sys.argv) > 1 else "studies/own_repeats"
all_csv = os.path.join(workdir, "IndustryModel_False", "results_all.csv")

stats = study_statistics(all_csv)

with open(all_csv, newline="") as f:
    rows = list(csv.DictReader(f))
div: dict[str, dict[int, int]] = {}
for r in rows:
    key = f"{int(float(r['read_len']))}:{int(float(r['dbg_kmer']))}"
    exp = int(float(r["experiment"]))
    div.setdefault(key, {}).setdefault(exp, 0)
    div[key][exp] += 1

out = {}
for key in sorted(stats, key=lambda s: int(s.split(":")[0])):
    counts = np.array(sorted(div[key].values()))
    out[key] = dict(
        stats[key],
        experiments=int(len(div[key])),
        solutions_total=int(counts.sum()),
        solutions_per_experiment_mean=round(float(counts.mean()), 2),
        solutions_per_experiment_median=float(np.median(counts)),
        multi_solution_experiments_pct=round(
            100.0 * float((counts > 1).mean()), 1),
    )
print(json.dumps(out, indent=1))
