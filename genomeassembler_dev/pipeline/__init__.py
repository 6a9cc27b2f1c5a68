"""Experiment orchestration: config, per-experiment runner, result artifacts."""

from genomeassembler_dev.pipeline.config import ExperimentConfig  # noqa: F401
from genomeassembler_dev.pipeline.assembler import Assembler  # noqa: F401
