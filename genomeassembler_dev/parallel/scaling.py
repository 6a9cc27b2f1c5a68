"""Scaling-efficiency harness.

Measures throughput of the sharded simulate+count step at increasing device
counts on whatever mesh is available (virtual CPU mesh in tests, real slices
in production) and reports efficiency vs linear scaling — the BASELINE.md
">80% at 2+ hosts" metric. On multi-host systems, call
jax.distributed.initialize() first; the same mesh axes span ICI within a
slice and DCN across slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from genomeassembler_dev.parallel.mesh import make_mesh
from genomeassembler_dev.parallel.sharding import make_sim_count_step


@dataclass
class ScalingPoint:
    n_devices: int
    seconds: float
    reads_per_s: float
    efficiency: float  # vs the smallest measured device count


def measure_scaling(
    genomes: np.ndarray,  # [B, L] codes; B divisible by every seg count
    probs_k8: np.ndarray,
    read_len: int,
    n_draws_per_seg: int,
    device_counts: list[int],
    count_k: int = 8,
    reps: int = 3,
) -> list[ScalingPoint]:
    B = genomes.shape[0]
    gj = jnp.asarray(genomes)
    seeds = jnp.arange(B, dtype=jnp.int32)
    probs = jnp.asarray(probs_k8, jnp.float32)
    points: list[ScalingPoint] = []
    for n in device_counts:
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} devices")
        mesh = make_mesh(seg=n, read=1, tp=1)
        step = make_sim_count_step(mesh, read_len, n_draws_per_seg, count_k)
        out = step(gj, seeds, probs)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(step(gj, seeds, probs))
        dt = (time.perf_counter() - t0) / reps
        rps = B * n_draws_per_seg / dt
        points.append(ScalingPoint(n, dt, rps, 0.0))
    base = points[0]
    for p in points:
        ideal = base.reads_per_s * (p.n_devices / base.n_devices)
        p.efficiency = p.reads_per_s / ideal
    return points
