"""Device meshes for the framework's parallel axes.

The reference has no parallelism (SURVEY.md §2.2); these axes are new design:

  seg — data parallelism over independent segments/experiments (the
        reference's serial `for i in 1:total_iters` loop),
  read — read-batch parallelism within one segment: reads sharded, k-mer
        counts and break-score partials merged with psum,
  tp  — tensor/table parallelism: the probability table or the model's
        hidden dimension sharded, partial dots reduced over the axis.

The GPUs of one host are joined all to all (NVLink), so the mesh follows the
algorithm, not a topology; jax.distributed + the same axis names extend it
across hosts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(seg: int | None = None, read: int = 1, tp: int = 1,
              devices=None) -> Mesh:
    """Mesh with axes (seg, read, tp). With seg=None, all remaining devices
    go to seg."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if seg is None:
        if n % (read * tp):
            raise ValueError(f"{n} devices not divisible by read*tp={read * tp}")
        seg = n // (read * tp)
    if seg * read * tp > n:
        raise ValueError(f"mesh {seg}x{read}x{tp} needs more than {n} devices")
    arr = np.asarray(devices[: seg * read * tp]).reshape(seg, read, tp)
    return Mesh(arr, ("seg", "read", "tp"))


def segment_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-of-segments arrays: leading axis sharded over seg."""
    return NamedSharding(mesh, P("seg"))


def read_sharding(mesh: Mesh) -> NamedSharding:
    """[B, N_reads, ...] arrays: segments over seg, reads over read."""
    return NamedSharding(mesh, P("seg", "read"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
