"""Emit external (velvet-shaped) contig FASTAs for a segment store: each
experiment gets contigs_exp_<i>.fa of overlapping tiles of its segment —
the C14 contract (external assembler output in, scored solutions out),
letting study-velvet run end-to-end where velvet binaries are absent.

    python tools/make_external_contigs.py OUT_DIR [seed seq_len n piece overlap repeats]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from genomeassembler_dev.sim.segments import synthetic_segment_store, write_fasta


def tile_contigs(seg: str, piece: int = 3000, overlap: int = 600) -> dict[str, str]:
    """Tiles of `piece` bases, consecutive tiles overlapping by `overlap`."""
    step = piece - overlap
    return {f"NODE_{j + 1}": seg[lo : lo + piece]
            for j, lo in enumerate(range(0, len(seg) - overlap, step))}


def main(argv: list[str]) -> None:
    out_dir = argv[0]
    seed = int(argv[1]) if len(argv) > 1 else 1234
    seq_len = int(argv[2]) if len(argv) > 2 else 50000
    n = int(argv[3]) if len(argv) > 3 else 4
    piece = int(argv[4]) if len(argv) > 4 else 3000
    overlap = int(argv[5]) if len(argv) > 5 else 600
    # repeats=1 plants repeat structure in the segments (pair with the CLI's
    # --repeat-segments). NOTE: repeat-heavy segments make the tile ensemble
    # merge combinatorially (thousands of ~2x-length solutions per
    # experiment); the reference's velvet study runs on real genome segments
    # where ensembles stay small, so repeats=0 is the faithful stand-in at
    # study scale.
    repeats = bool(int(argv[6])) if len(argv) > 6 else False

    store = synthetic_segment_store(seed, seq_len, n, repeats=repeats)
    os.makedirs(out_dir, exist_ok=True)
    for ind, seg in enumerate(store.seqs, start=1):
        tiles = tile_contigs(seg, piece, overlap)
        write_fasta(os.path.join(out_dir, f"contigs_exp_{ind}.fa"), tiles)
    print(f"{n} contig FASTAs ({len(tiles)} tiles each) in {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
