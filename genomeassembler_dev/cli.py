"""Command-line interface mirroring the reference's experiment scripts.

  python -m genomeassembler_dev.cli run        # one experiment
  python -m genomeassembler_dev.cli study-own  # scripts/02 (grid x iters)
  python -m genomeassembler_dev.cli study-kmer-count  # scripts/01
  python -m genomeassembler_dev.cli study-gc   # scripts/03

Segments come from --segments-fasta (the reference's SampledRefGenome
contract) or a seeded synthetic store (--synthetic).
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--workdir", default="./workdir")
    p.add_argument("--platform", default=None,
                   help="force a JAX platform (e.g. cpu, cuda)")
    p.add_argument("--seq-len", type=int, default=1000)
    p.add_argument("--read-len", type=int, default=12)
    p.add_argument("--dbg-kmer", type=int, default=9)
    p.add_argument("--kmer", type=int, default=8)
    p.add_argument("--coverage", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--n-orderings", type=int, default=10000)
    p.add_argument("--traversal", default="standard",
                   choices=["standard", "biased"],
                   help="biased = probability-guided branch continuation "
                        "(BASELINE config 4)")
    p.add_argument("--biased-max-solutions", type=int, default=256,
                   help="keep the longest N biased assemblies as solutions")
    p.add_argument("--segments-fasta", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use a seeded synthetic segment store")
    p.add_argument("--repeat-segments", action="store_true",
                   help="plant segmental duplications in synthetic segments "
                        "(repeat structure like real genomic sequence)")
    p.add_argument("--total-iters", type=int, default=10)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--plots", action="store_true",
                   help="emit per-experiment diagnostic plots "
                        "(probability track, breakpoint histogram, "
                        "score-vs-Levenshtein boxplots)")


def _segments(args):
    from genomeassembler_dev.sim.segments import SegmentStore, synthetic_segment_store

    if args.segments_fasta:
        return SegmentStore.load(args.segments_fasta)
    return synthetic_segment_store(
        args.seed, args.seq_len, args.total_iters,
        repeats=getattr(args, "repeat_segments", False))


def _config(args, **over):
    from genomeassembler_dev.pipeline.config import ExperimentConfig

    return ExperimentConfig(
        seq_len=args.seq_len, read_len=args.read_len, dbg_kmer=args.dbg_kmer,
        kmer=args.kmer, coverage_target=args.coverage, seed=args.seed,
        n_orderings=args.n_orderings,
        traversal=getattr(args, "traversal", "standard"),
        biased_max_solutions=getattr(args, "biased_max_solutions", 256),
    ).with_(**over)


def cmd_run(args):
    from genomeassembler_dev.pipeline.assembler import Assembler
    from genomeassembler_dev.pipeline import results as res_io

    segs = _segments(args)
    cfg = _config(args)
    asm = Assembler(cfg, verbose=args.verbose)
    ind = args.ind
    res = asm.run_experiment(segs.seqs[ind - 1])
    path = res_io.save_result(args.workdir, ind, cfg, res)
    out = {"solutions": res.n_solutions, "csv": path,
           "stats": {k: v for k, v in res.stats.items() if k != "genome_seq"}}
    if args.plots:
        from genomeassembler_dev.pipeline.experiments import (
            emit_experiment_plots)

        out["plots"] = emit_experiment_plots(
            args.workdir, ind, cfg, res, segs.seqs[ind - 1], asm.table)
    print(json.dumps(out))


def cmd_study_own(args):
    from genomeassembler_dev.pipeline.experiments import run_own_study

    segs = _segments(args)
    grid = None
    if args.grid:
        grid = tuple(tuple(int(x) for x in pair.split(":")) for pair in args.grid.split(","))
    rep = run_own_study(
        args.workdir, segs, base=_config(args), grid=grid,
        total_iters=args.total_iters, verbose=args.verbose,
        batched=args.batched, seg_batch=args.seg_batch, plots=args.plots,
    )
    print(json.dumps({"summary": rep.summary_path, "all": rep.all_path,
                      "ran": rep.n_experiments, "skipped": rep.n_skipped}))


def cmd_study_all(args):
    """scripts/submit.sh contract: study 02 (own) -> 01 (kmer count) ->
    03 (GC), one command, shared workdir (run_genomeassembler_dev.sh:8-9)."""
    from genomeassembler_dev.pipeline.experiments import (
        run_gc_study, run_kmer_count_study, run_own_study)

    segs = _segments(args)
    grid = None
    if args.grid:
        grid = tuple(tuple(int(x) for x in pair.split(":"))
                     for pair in args.grid.split(","))
    rep = run_own_study(
        args.workdir, segs, base=_config(args), grid=grid,
        total_iters=args.total_iters, verbose=args.verbose,
        batched=args.batched, seg_batch=args.seg_batch, plots=args.plots,
    )
    r2 = run_kmer_count_study(args.workdir, segs.seqs[0], base=_config(args))
    gc_csv = run_gc_study(args.workdir, segs, _config(args), args.total_iters)
    print(json.dumps({
        "own": {"summary": rep.summary_path, "all": rep.all_path,
                "ran": rep.n_experiments, "skipped": rep.n_skipped},
        "kmer_count_r_squared": {str(k): v for k, v in r2.items()},
        "gc_csv": gc_csv,
    }))


def cmd_study_velvet(args):
    from genomeassembler_dev.pipeline.experiments import run_velvet_study
    from genomeassembler_dev.pipeline.velvet import IndustryAssembler
    from genomeassembler_dev.sim.segments import read_fasta

    segs = _segments(args)
    base = _config(args, industry_standard=True)

    if args.contigs_dir:
        def source(asm, segment, ind):
            d = read_fasta(f"{args.contigs_dir}/contigs_exp_{ind}.fa")
            return list(d.values())
    elif IndustryAssembler.velvet_available():
        import os

        from genomeassembler_dev.core.encoding import encode_dna
        from genomeassembler_dev.sim.reads import generate_reads
        from genomeassembler_dev.sim.reads_io import save_read_fastas

        def source(asm, segment, ind):
            import jax
            import numpy as np

            rs = generate_reads(jax.random.key(base.seed), encode_dna(segment),
                                asm.table, base.read_len, base.coverage_target)
            p1, p2, _ = save_read_fastas(
                args.workdir, ind, asm.config, np.asarray(rs.codes),
                np.asarray(rs.valid), np.asarray(rs.positions), segment,
            )
            out = os.path.join(args.workdir, "velvet", f"exp_{ind}")
            return asm.run_velvet(p1, p2, out)
    else:
        raise SystemExit(
            "study-velvet needs --contigs-dir (contigs_exp_<i>.fa files) or "
            "velveth/velvetg on PATH"
        )

    grid = None
    if args.grid:
        grid = tuple(tuple(int(x) for x in p.split(":")) for p in args.grid.split(","))
    rep = run_velvet_study(args.workdir, segs, source, base=base, grid=grid,
                           total_iters=args.total_iters, verbose=args.verbose)
    print(json.dumps({"summary": rep.summary_path, "all": rep.all_path,
                      "ran": rep.n_experiments, "skipped": rep.n_skipped}))


def cmd_study_kmer_count(args):
    from genomeassembler_dev.pipeline.experiments import run_kmer_count_study

    segs = _segments(args)
    r2 = run_kmer_count_study(args.workdir, segs.seqs[0], base=_config(args))
    print(json.dumps({"r_squared": {str(k): v for k, v in r2.items()}}))


def cmd_study_gc(args):
    from genomeassembler_dev.pipeline.experiments import run_gc_study

    segs = _segments(args)
    out = run_gc_study(args.workdir, segs, _config(args), args.total_iters)
    print(json.dumps({"csv": out}))


def cmd_study_plots(args):
    from genomeassembler_dev.utils.plots import study_plots

    made = []
    for d in args.study_dirs:
        made += study_plots(d, top_frac=args.top_frac)
    print(json.dumps({"figures": made}))


def cmd_fit_model(args):
    from genomeassembler_dev.core.querytable import load_default_query_table
    from genomeassembler_dev.models import breakage_model as bm

    table = load_default_query_table()
    params, losses = bm.fit_to_table(
        table, k=args.kmer, steps=args.steps, hidden=args.hidden, lr=args.lr,
        seed=args.seed,
    )
    bm.save_params(args.out, params)
    print(json.dumps({"checkpoint": args.out,
                      "loss_first": float(losses[0]),
                      "loss_last": float(losses[-1])}))


def cmd_bench_scaling(args):
    import numpy as np

    from genomeassembler_dev.core.encoding import encode_dna
    from genomeassembler_dev.core.querytable import load_default_query_table
    from genomeassembler_dev.parallel.scaling import measure_scaling
    from genomeassembler_dev.sim.segments import synthetic_genome

    table = load_default_query_table()
    counts = [int(x) for x in args.devices.split(",")]
    B = max(counts) * args.segments_per_device
    genomes = np.stack(
        [encode_dna(synthetic_genome(i, args.seq_len)) for i in range(B)]
    )
    pts = measure_scaling(genomes, table.probs[8], args.read_len,
                          args.draws_per_segment, counts)
    print(json.dumps([
        {"devices": p.n_devices, "reads_per_s": round(p.reads_per_s, 1),
         "efficiency": round(p.efficiency, 3)} for p in pts
    ]))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genomeassembler_dev")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run one experiment")
    _add_common(p)
    p.add_argument("--ind", type=int, default=1, help="experiment index (1-based)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("study-own", help="own-dBG study grid (scripts/02)")
    _add_common(p)
    p.add_argument("--grid", default=None,
                   help="comma list of read_len:dbg_kmer pairs, e.g. 12:9,14:9")
    p.add_argument("--batched", action="store_true",
                   help="vmapped device stages across segments")
    p.add_argument("--seg-batch", type=int, default=16)
    p.set_defaults(fn=cmd_study_own)

    p = sub.add_parser("study-all",
                       help="full study chain 02 -> 01 -> 03 "
                            "(scripts/submit.sh)")
    _add_common(p)
    p.add_argument("--grid", default=None,
                   help="comma list of read_len:dbg_kmer pairs")
    p.add_argument("--batched", action="store_true")
    p.add_argument("--seg-batch", type=int, default=16)
    p.set_defaults(fn=cmd_study_all)

    p = sub.add_parser("study-velvet",
                       help="industry-standard study (scripts/00); external "
                            "contigs or velvet binaries")
    _add_common(p)
    p.add_argument("--grid", default=None)
    p.add_argument("--contigs-dir", default=None,
                   help="directory of contigs_exp_<i>.fa files")
    p.set_defaults(fn=cmd_study_velvet)

    p = sub.add_parser("study-kmer-count", help="k-mer count vs prob (scripts/01)")
    _add_common(p)
    p.set_defaults(fn=cmd_study_kmer_count)

    p = sub.add_parser("study-gc", help="GC dependency (scripts/03)")
    _add_common(p)
    p.set_defaults(fn=cmd_study_gc)

    p = sub.add_parser("study-plots",
                       help="render the aggregated figure families from a "
                            "study's results_summary/results_all CSVs "
                            "(scripts/02_…:129-546, 00_…:129-169)")
    p.add_argument("study_dirs", nargs="+",
                   help="IndustryModel_* dirs holding the study CSVs")
    p.add_argument("--top-frac", type=float, default=0.05)
    p.set_defaults(fn=cmd_study_plots)

    p = sub.add_parser("fit-model", help="distil the QueryTable into the MLP")
    p.add_argument("--platform", default=None)
    p.add_argument("--kmer", type=int, default=8)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="./breakage_model.npz")
    p.set_defaults(fn=cmd_fit_model)

    p = sub.add_parser("bench-scaling", help="throughput vs device count")
    p.add_argument("--platform", default=None)
    p.add_argument("--devices", default="1,2,4",
                   help="comma list of device counts")
    p.add_argument("--segments-per-device", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=500)
    p.add_argument("--read-len", type=int, default=12)
    p.add_argument("--draws-per-segment", type=int, default=256)
    p.set_defaults(fn=cmd_bench_scaling)

    args = ap.parse_args(argv)
    if getattr(args, "platform", None):
        import jax

        jax.config.update("jax_platforms", args.platform)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
