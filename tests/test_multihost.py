"""First real multi-PROCESS distributed execution (SURVEY §2.2 multi-host).

The rest of the suite exercises multi-DEVICE sharding inside one process
(8 virtual CPU devices). This lane launches two actual OS processes wired by
`jax.distributed` over a localhost coordinator — the same code path
(multihost.initialize -> global_mesh -> shard_map step) a multi-host run
takes — and asserts the sharded k-mer count step's global result equals the
single-process run, plus the host_segment_slice artifact-ownership contract
(lib/DeNovoAssembler.R:280-308 is the per-host artifact unit).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import pytest

# two real OS processes + a coordinator handshake per test: minutes, not
# seconds — full lane only (pytest -m "slow or not slow")
pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, @REPO@)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    from genomeassembler_dev.parallel import multihost
    from genomeassembler_dev.parallel.sharding import make_sim_count_step

    pid = int(sys.argv[1])
    multihost.initialize(coordinator_address=@COORD@, num_processes=2,
                         process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()   # 2 local x 2 processes

    mesh = multihost.global_mesh(read=2)            # (seg=2, read=2, tp=1)

    # host_segment_slice: disjoint contiguous halves covering every index
    sl = multihost.host_segment_slice(10)
    assert list(sl) == (list(range(0, 5)) if pid == 0 else list(range(5, 10)))

    # one sharded pipeline step over the global mesh: genomes sharded over
    # `seg`, reads split over `read` with a psum count merge
    B, L, READ_LEN, N_DRAWS, K = 2, 120, 12, 64, 4
    rng = np.random.default_rng(0)
    genomes_np = rng.integers(0, 4, (B, L)).astype(np.uint8)
    seeds_np = np.arange(B, dtype=np.int32)
    probs_np = rng.random(65536).astype(np.float32)

    from jax.sharding import NamedSharding, PartitionSpec as P
    def to_global(x, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: x[idx])
    genomes = to_global(genomes_np, P("seg", None))
    seeds = to_global(seeds_np, P("seg"))
    probs = to_global(probs_np, P())

    step = make_sim_count_step(mesh, READ_LEN, N_DRAWS, K)
    out = jax.jit(step)(genomes, seeds, probs)

    # expected: the identical step on a single-process 4-device mesh layout
    # is what the main suite validates; here assert cross-process coherence
    # via the global window-count invariant and determinism across the two
    # processes (both fetch the same addressable shard rows).
    from jax.experimental import multihost_utils
    full = multihost_utils.process_allgather(out, tiled=True)
    # process_allgather returns the assembled global array on every process
    got = np.asarray(full).reshape(B, 4**K)
    total = got.sum()
    print("TOTAL", int(total), flush=True)
    # every process sees the identical global result
    digest = int(np.asarray(got, np.int64).ravel() @
                 (np.arange(got.size, dtype=np.int64) % 97 + 1))
    print("DIGEST", digest, flush=True)
    print("OK", flush=True)
""")


_STUDY_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, @REPO@)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")

    from genomeassembler_dev.parallel import multihost

    pid = int(sys.argv[1])
    workdir = sys.argv[2]
    multihost.initialize(coordinator_address=@COORD@, num_processes=2,
                         process_id=pid)

    # heavier imports AFTER initialize: some touch the backend at import
    from genomeassembler_dev.core.querytable import load_default_query_table
    from genomeassembler_dev.parallel.mesh import make_mesh
    from genomeassembler_dev.pipeline import results as res_io
    from genomeassembler_dev.pipeline.batch_runner import run_experiments_batched
    from genomeassembler_dev.pipeline.config import ExperimentConfig
    from genomeassembler_dev.sim.segments import synthetic_segment_store

    # end-to-end study over this host's OWN experiment slice: the reference's
    # per-host unit of work and restart (lib/DeNovoAssembler.R:280-308 —
    # each job owns exp_<i> artifacts); the device stages run sharded over
    # this host's local (seg=2) mesh
    segments = synthetic_segment_store(21, 250, 4)
    cfg = ExperimentConfig(seq_len=250, read_len=12, dbg_kmer=9,
                           coverage_target=12.0, kmer=8, seed=1234,
                           n_orderings=100)
    table = load_default_query_table()
    inds = list(multihost.host_segment_slice(len(segments)))
    mesh = make_mesh(seg=2, read=1, tp=1, devices=jax.local_devices())
    res = run_experiments_batched(
        cfg, [segments.seqs[i] for i in inds], table, mesh=mesh)
    owned = []
    for i, r in zip(inds, res):
        res_io.save_result(workdir, i + 1, cfg, r)
        owned.append(i + 1)
    print("OWNED", ",".join(map(str, owned)), flush=True)
    print("OK", flush=True)
""")


def test_two_process_distributed_step(tmp_path):
    # (no pytest.mark.timeout: the plugin is not installed here; the
    # communicate(timeout=240) below is the enforced bound)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(
        _WORKER.replace("@REPO@", repr(REPO)).replace("@COORD@", repr(coord)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err[-3000:]}"
        assert "OK" in out
    # both processes computed the identical global result
    d0 = [l for l in outs[0][1].splitlines() if l.startswith("DIGEST")]
    d1 = [l for l in outs[1][1].splitlines() if l.startswith("DIGEST")]
    assert d0 == d1 and d0
    t0 = [l for l in outs[0][1].splitlines() if l.startswith("TOTAL")]
    t1 = [l for l in outs[1][1].splitlines() if l.startswith("TOTAL")]
    assert t0 == t1 and t0

    # ... and it equals the single-process run of the same (seg=2, read=2)
    # step in THIS process (8 virtual devices; result is placement-free)
    import numpy as np

    from genomeassembler_dev.parallel.mesh import make_mesh
    from genomeassembler_dev.parallel.sharding import make_sim_count_step

    import jax

    rng = np.random.default_rng(0)
    genomes = rng.integers(0, 4, (2, 120)).astype(np.uint8)
    seeds = np.arange(2, dtype=np.int32)
    probs = rng.random(65536).astype(np.float32)
    mesh = make_mesh(seg=2, read=2, devices=jax.devices()[:4])
    got = np.asarray(jax.jit(make_sim_count_step(mesh, 12, 64, 4))(
        genomes, seeds, probs))
    digest = int(np.asarray(got, np.int64).ravel()
                 @ (np.arange(got.size, dtype=np.int64) % 97 + 1))
    assert d0[0] == f"DIGEST {digest}"
    assert t0[0] == f"TOTAL {int(got.sum())}"


def test_two_process_study_artifact_ownership(tmp_path):
    """End-to-end multi-process study: each process runs the batched
    production runner over its host_segment_slice and writes its own
    exp_<i> artifacts; ownership is disjoint and the merged artifact tree
    is byte-identical to a single-process run."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    workdir = tmp_path / "shared"
    workdir.mkdir()
    script = tmp_path / "study_worker.py"
    script.write_text(_STUDY_WORKER.replace("@REPO@", repr(REPO))
                      .replace("@COORD@", repr(coord)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid), str(workdir)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("study workers timed out")
    owned = []
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err[-3000:]}"
        assert "OK" in out
        line = [l for l in out.splitlines() if l.startswith("OWNED")][0]
        owned.append({int(x) for x in line.split()[1].split(",")})
    # disjoint ownership covering every experiment
    assert owned[0] & owned[1] == set()
    assert owned[0] | owned[1] == {1, 2, 3, 4}

    # the merged tree equals a single-process run, byte for byte
    from genomeassembler_dev.core.querytable import load_default_query_table
    from genomeassembler_dev.pipeline import results as res_io
    from genomeassembler_dev.pipeline.batch_runner import (
        run_experiments_batched)
    from genomeassembler_dev.pipeline.config import ExperimentConfig
    from genomeassembler_dev.sim.segments import synthetic_segment_store

    segments = synthetic_segment_store(21, 250, 4)
    cfg = ExperimentConfig(seq_len=250, read_len=12, dbg_kmer=9,
                           coverage_target=12.0, kmer=8, seed=1234,
                           n_orderings=100)
    ref_dir = tmp_path / "single"
    res = run_experiments_batched(cfg, list(segments.seqs),
                                  load_default_query_table())
    for i, r in enumerate(res, start=1):
        res_io.save_result(str(ref_dir), i, cfg, r)
    for i in range(1, 5):
        got = open(res_io.solutions_path(str(workdir), i, cfg), "rb").read()
        want = open(res_io.solutions_path(str(ref_dir), i, cfg), "rb").read()
        assert got == want, f"exp_{i} artifact differs from single-process run"
