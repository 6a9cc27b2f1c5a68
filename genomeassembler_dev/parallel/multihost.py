"""Multi-host launch/runtime.

The reference has no distributed execution (SURVEY.md §2.2); this is the
framework's N-host entry point. One call per host process:

    from genomeassembler_dev.parallel import multihost
    multihost.initialize("localhost:12355", num_processes=2, process_id=0)
    mesh = multihost.global_mesh(read=2, tp=2)

jax.distributed wires the hosts (pass coordinator_address, num_processes and
process_id; only cluster launchers that JAX detects supply them itself), and
the (seg, read, tp) mesh then spans every device of every host with the same
shard_map steps as single-host runs.

Per-host input pipelines: shard experiment indices by process with
`host_segment_slice`, write per-experiment artifacts from their owning host
(the file-per-experiment layout is already the restart unit), and aggregate
CSVs from any host.
"""

from __future__ import annotations

import jax

from genomeassembler_dev.parallel.mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize; with no arguments JAX's cluster
    auto-detection must find the coordinator."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(read: int = 1, tp: int = 1):
    """(seg, read, tp) mesh over all global devices."""
    return make_mesh(read=read, tp=tp, devices=jax.devices())


def host_segment_slice(n_segments: int) -> range:
    """The contiguous block of experiment indices this host owns."""
    p = jax.process_index()
    n = jax.process_count()
    per = -(-n_segments // n)
    return range(p * per, min((p + 1) * per, n_segments))
