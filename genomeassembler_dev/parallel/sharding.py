"""Sharded pipeline steps: the multi-chip execution path.

Three demonstrable shardings, matching SURVEY.md §2.2's required inventory:

  * simulate+count (seg x read): each (segment-shard, read-shard) device
    simulates its slice of the breakpoint draws and counts k-mers locally;
    partial histograms merge with psum over the read axis — the reference's
    per-segment serial loop (scripts/02_…:33-53) becomes pure data
    parallelism, and its k-mer counting becomes a collective reduction.
  * breakscore (seg x read x tp): reads sharded over `read` (partial break
    counts psum'd), probability table row-sharded over `tp` (partial dots
    psum'd) — the sharded-QueryTable path.
  * MLP train step (dp x tp): batch sharded over (seg, read) as dp, hidden
    dimension sharded over tp via parameter shardings; GSPMD inserts the
    collectives.

All steps are shard_map/jit programs over a mesh from parallel.mesh and run
identically on a virtual CPU mesh (tests) and a real slice.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from genomeassembler_dev.models import breakage_model as bm
from genomeassembler_dev.score.breakscore import breakscore
from genomeassembler_dev.sim.reads import simulate_reads
from genomeassembler_dev.ops.mxu import dot_f32


def make_sim_count_step(mesh: Mesh, read_len: int, n_draws: int, count_k: int,
                        break_kmer: int = 8):
    """Returns step(genomes [B, L], seeds [B] int32, probs_k8 [65536]) ->
    counts [B, 4^count_k] int32, reads/valid per shard merged over `read`.

    B must divide by the seg axis; n_draws splits over the read axis.
    """
    n_read = mesh.shape["read"]
    if n_draws % n_read:
        raise ValueError(f"n_draws={n_draws} not divisible by read axis {n_read}")
    draws_local = n_draws // n_read

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("seg", None), P("seg"), P()),
        out_specs=P("seg", None),
        check_vma=False,
    )
    def step(genomes, seeds, probs_k8):
        read_idx = jax.lax.axis_index("read")

        def per_segment(genome, seed):
            key = jax.random.fold_in(jax.random.key(seed), read_idx)
            rs = simulate_reads(key, genome, probs_k8, read_len, draws_local,
                                break_kmer)
            from genomeassembler_dev.ops.histogram import count_kmers
            from genomeassembler_dev.ops.windows import kmer_window_codes

            codes, valid = kmer_window_codes(rs.codes, count_k)
            valid = valid & rs.valid[:, None]
            return count_kmers(codes, valid, 4**count_k)

        local = jax.vmap(per_segment)(genomes, seeds)  # [Bl, 4^k]
        return jax.lax.psum(local, "read")

    return step


def make_breakscore_step(mesh: Mesh, break_kmer: int = 8, read_chunk: int = 128):
    """Returns step(paths [B,S,L], plens [B,S], rcodes [B,U,R], rcounts [B,U],
    rvalid [B,U], probs [TOTAL]) -> the full per-solution output set
    (lib/DeNovoAssembler.cpp:394-426): a dict with bp_score,
    bp_score_norm_by_break_freqs, bp_score_norm_by_len [B,S] f32,
    kmer_breaks [B,S] i32, path_freq and site_counts [B,S,TOTAL] f32.

    Reads sharded over `read` (partial break counts psum'd), table rows
    sharded over `tp` (partial dots psum'd).
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("seg", None, None), P("seg", None),
            P("seg", "read", None), P("seg", "read"), P("seg", "read"),
            P("tp"),
        ),
        out_specs=P("seg"),
        check_vma=False,
    )
    def step(paths, plens, rcodes, rcounts, rvalid, probs_shard):
        # local break counts from the local read shard
        counts_local = jax.vmap(
            lambda pa, pl, rc, rn, rv: _site_counts(pa, pl, rc, rn, rv,
                                                    break_kmer, read_chunk)
        )(paths, plens, rcodes, rcounts, rvalid)  # [Bl, S, TOTAL]
        counts = jax.lax.psum(counts_local, "read")
        total = counts.sum(axis=2)  # [Bl, S] == kmer_breaks
        safe_total = jnp.maximum(total, 1.0)

        # row-sharded table: local slice dots, reduced over tp
        tp_idx = jax.lax.axis_index("tp")
        shard_size = probs_shard.shape[0]
        lo = tp_idx * shard_size
        local_counts = jax.lax.dynamic_slice_in_dim(counts, lo, shard_size, axis=2)
        bp_score = jax.lax.psum(dot_f32(local_counts, probs_shard), "tp")
        norm_by_breaks = jax.lax.psum(
            dot_f32(local_counts / safe_total[:, :, None], probs_shard), "tp"
        )
        norm_by_breaks = jnp.where(total > 0, norm_by_breaks, 0.0)
        norm_by_len = bp_score / jnp.maximum(plens.astype(jnp.float32), 1.0)
        path_freq = jnp.where(
            total[:, :, None] > 0, counts / safe_total[:, :, None], jnp.nan
        )
        return {
            "bp_score": bp_score,
            "bp_score_norm_by_break_freqs": norm_by_breaks,
            "bp_score_norm_by_len": norm_by_len,
            "kmer_breaks": total.astype(jnp.int32),
            "path_freq": path_freq,
            "site_counts": counts,
        }

    return step


def make_ks_step(mesh: Mesh):
    """Sharded per-solution KS statistic: step(path_freq [B,S,T], tracks
    [B,W]) -> [B,S] f32, segments sharded over `seg` (the KS pooled sort is
    per solution, so only data parallelism applies)."""
    from genomeassembler_dev.ops.ks import batched_ks_2samp

    @partial(
        shard_map, mesh=mesh, in_specs=(P("seg"), P("seg")),
        out_specs=P("seg"), check_vma=False,
    )
    def step(path_freq, tracks):
        return jax.vmap(batched_ks_2samp)(path_freq, tracks)

    return step


def make_lev_step(mesh: Mesh, mode: str = "NW"):
    """Sharded Levenshtein vs each segment's truth: step(pm [B,S,L], pl
    [B,S], gm [B,L]) -> [B,S] i32 over `seg` (the scan DP runs per device)."""
    from genomeassembler_dev.ops.edit_distance import batched_levenshtein

    @partial(
        shard_map, mesh=mesh, in_specs=(P("seg"), P("seg"), P("seg")),
        out_specs=P("seg"), check_vma=False,
    )
    def step(pm, pl, gm):
        return jax.vmap(
            lambda a, b, g: batched_levenshtein(a, b, g, mode=mode)
        )(pm, pl, gm)

    return step


def _site_counts(paths, plens, rcodes, rcounts, rvalid, break_kmer, read_chunk):
    """Break-count matrix only (no table needed)."""
    bs = breakscore(paths, plens, rcodes, rcounts, rvalid,
                    jnp.zeros((69904,), jnp.float32),
                    break_kmer=break_kmer, read_chunk=read_chunk)
    return bs.site_counts


def make_sharded_train_step(mesh: Mesh, optimizer: optax.GradientTransformation):
    """dp x tp sharded MLP train step via parameter/batch shardings; XLA
    (GSPMD) inserts the all-reduces."""
    dp = ("seg", "read")

    param_specs = {
        "w1": P(None, "tp"), "b1": P("tp"),
        "w2": P("tp", None), "b2": P(),
        "w3": P(None, None), "b3": P(),
    }

    def sharding(spec):
        return NamedSharding(mesh, spec)

    param_shardings = {k: sharding(v) for k, v in param_specs.items()}
    batch_sharding = sharding(P(dp))

    @partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, codes, target_logp):
        params = jax.lax.with_sharding_constraint(params, param_shardings)
        codes = jax.lax.with_sharding_constraint(codes, batch_sharding)
        loss, grads = jax.value_and_grad(bm.loss_fn)(params, codes, target_logp)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = jax.lax.with_sharding_constraint(params, param_shardings)
        return params, opt_state, loss

    return train_step, param_shardings, batch_sharding
