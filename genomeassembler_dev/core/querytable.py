"""QueryTable loading and normalisation.

The reference ships four CSV assets `data/QueryTable/QueryTable_kmer-{2,4,6,8}.csv`
with raw per-k-mer breakage ratios over all 4^k k-mers (16 + 256 + 4096 + 65536
= 69,904 rows). Its loader (ref: lib/GenerateReads.R:153-184):

  1. per table, replaces NA probabilities with that table's minimum,
  2. concatenates all four tables and normalises the *combined* vector to sum
     to one,
  3. splits back into per-k tables plus the combined `all` table.

Here the tables become dense float arrays indexed directly by the k-mer's
integer code — the gtl hash-map lookup of the reference scorer
(ref: lib/DeNovoAssembler.cpp:324-328) becomes a gather. The combined table
uses the canonical index space

    combined_index(k, code) = OFFSETS[k] + code

with k in (2, 4, 6, 8) and OFFSETS = {2:0, 4:16, 6:272, 8:4368}, total 69,904.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from genomeassembler_dev.core.encoding import kmer_code

KS = (2, 4, 6, 8)
SIZES = {k: 4**k for k in KS}
OFFSETS = {2: 0, 4: 16, 6: 272, 8: 4368}
TOTAL = 69904  # sum of 4^k for k in (2,4,6,8)


@dataclass(frozen=True)
class QueryTable:
    """Normalised breakage-probability tables in dense code order.

    probs[k][code] is the probability of k-mer with integer code `code`;
    the four tables jointly sum to 1 (matching lib/GenerateReads.R:173-176).
    """

    probs: dict[int, np.ndarray] = field(repr=False)

    @cached_property
    def combined(self) -> np.ndarray:
        """All 69,904 probabilities in combined-index order, float64."""
        return np.concatenate([self.probs[k] for k in KS])

    def lookup(self, k: int, codes: np.ndarray) -> np.ndarray:
        return self.probs[k][codes]

    def combined_index(self, k: int, codes: np.ndarray) -> np.ndarray:
        return OFFSETS[k] + codes

    @staticmethod
    def uniform() -> "QueryTable":
        """The reference's random-probability control: every entry 1/69904
        (ref: lib/DeNovoAssembler.R:326-330)."""
        p = 1.0 / TOTAL
        return QueryTable(probs={k: np.full(SIZES[k], p) for k in KS})


def _read_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read one QueryTable CSV -> (codes, raw probs with NaN for NA)."""
    codes, probs = [], []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        if header[:2] != ["kmer", "prob"]:
            raise ValueError(f"{path}: expected header kmer,prob, got {header}")
        for row in reader:
            codes.append(kmer_code(row[0]))
            v = row[1]
            probs.append(float("nan") if v in ("", "NA", "NaN") else float(v))
    return np.asarray(codes, dtype=np.int64), np.asarray(probs, dtype=np.float64)


def load_query_table(directory: str) -> QueryTable:
    """Load and normalise the four QueryTable CSVs from `directory`.

    Reproduces lib/GenerateReads.R:153-184: per-table NA -> table minimum,
    then one normalisation over the concatenation of all 69,904 entries.
    """
    raw: dict[int, np.ndarray] = {}
    for k in KS:
        path = os.path.join(directory, f"QueryTable_kmer-{k}.csv")
        codes, probs = _read_csv(path)
        dense = np.full(SIZES[k], np.nan)
        dense[codes] = probs
        if np.isnan(dense).all():
            raise ValueError(f"{path}: all probabilities missing")
        # NA -> per-table minimum (lib/GenerateReads.R:161-165). Codes absent
        # from the CSV entirely get the same treatment.
        dense = np.where(np.isnan(dense), np.nanmin(dense), dense)
        raw[k] = dense

    total = sum(float(raw[k].sum()) for k in KS)
    return QueryTable(probs={k: raw[k] / total for k in KS})


def save_query_table_npz(table_dir: str, out_path: str) -> None:
    """Convert the four CSV assets into a dense .npz (raw, un-normalised
    values in code order, NA kept as NaN). The npz is this framework's native
    asset format: code-indexed dense arrays load straight onto the device."""
    arrays = {}
    for k in KS:
        codes, probs = _read_csv(os.path.join(table_dir, f"QueryTable_kmer-{k}.csv"))
        dense = np.full(SIZES[k], np.nan)
        dense[codes] = probs
        arrays[f"raw_k{k}"] = dense
    np.savez_compressed(out_path, **arrays)


def load_query_table_npz(path: str) -> QueryTable:
    """Load the dense npz asset and normalise exactly like load_query_table."""
    with np.load(path) as data:
        raw = {}
        for k in KS:
            dense = data[f"raw_k{k}"]
            dense = np.where(np.isnan(dense), np.nanmin(dense), dense)
            raw[k] = dense
    total = sum(float(raw[k].sum()) for k in KS)
    return QueryTable(probs={k: raw[k] / total for k in KS})


def default_query_table_path() -> str:
    """Location of the QueryTable asset bundled with this repo."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "data", "querytable.npz")


def load_default_query_table() -> QueryTable:
    return load_query_table_npz(default_query_table_path())
