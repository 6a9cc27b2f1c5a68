"""Shuffled-ensemble greedy contig merging."""

from genomeassembler_dev.merge.engine import assemble_solutions  # noqa: F401
