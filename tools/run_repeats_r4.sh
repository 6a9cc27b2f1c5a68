#!/bin/bash
# Structured-repeats study (VERDICT r3 ask #2): >= 2 grid rows x 200
# experiments with tandem/inverted/diverged repeat structure
# (sim.segments.plant_repeats). Relaunches after a crash; the
# file-per-experiment artifacts make every relaunch lossless (the
# reference's restart contract, lib/DeNovoAssembler.R:280-308).
set -u
cd "$(dirname "$0")/.."
WD=studies/own_repeats_r4
LOG=studies/own_repeats_r4.log
for attempt in $(seq 1 12); do
  python -m genomeassembler_dev.cli study-own \
    --workdir "$WD" --synthetic --repeat-segments \
    --total-iters 200 --seq-len 1000 --coverage 40 --n-orderings 10000 \
    --grid 12:9,16:13,25:15 \
    --batched --seg-batch 64 >> "$LOG" 2>&1
  rc=$?
  echo "=== attempt $attempt rc=$rc $(date -u)" >> "$LOG"
  [ $rc -eq 0 ] && break
  sleep 20
done
python tools/summarize_repeats_study.py "$WD" > studies/own_repeats_r4_stats.json 2>> "$LOG"
echo "STUDY DONE rc=$rc" >> "$LOG"
