"""Batched two-sample Kolmogorov-Smirnov statistic on device.

The reference calls R's ks.test per solution against the genome's octamer
probability track (lib/DeNovoAssembler.R:419-426). Here all solutions are
evaluated at once with a sort-and-cumsum formulation (no gather-based
binary searches, which a searchsorted formulation needs):

  * pool each row's sample with the shared sample, tagging origins,
  * one key/value sort per row,
  * both ECDFs are cumulative sums of the origin weights along the sorted
    order; the KS gap is only evaluated at the end of each tie run, which
    realises the right-continuous ECDF semantics exactly (ties across the
    two samples included, matching R).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ks_from_pooled(values: jnp.ndarray, wx: jnp.ndarray, wy: jnp.ndarray) -> jnp.ndarray:
    """values/wx/wy: [B, P]; weights sum to 1 per row (0 on padding).
    Returns [B] KS statistics."""
    order_vals, wx_s, wy_s = jax.lax.sort((values, wx, wy), num_keys=1)
    cx = jnp.cumsum(wx_s, axis=1)
    cy = jnp.cumsum(wy_s, axis=1)
    gap = jnp.abs(cx - cy)
    # evaluate only at the last element of each tie run (right-continuous)
    nxt = jnp.concatenate(
        [order_vals[:, 1:], jnp.full_like(order_vals[:, :1], jnp.inf)], axis=1
    )
    run_end = (order_vals != nxt) & jnp.isfinite(order_vals)
    return jnp.where(run_end, gap, 0.0).max(axis=1)


@jax.jit
def batched_ks_2samp_masked(
    x_rows: jnp.ndarray, x_valid: jnp.ndarray, y: jnp.ndarray
) -> jnp.ndarray:
    """KS statistic of the *valid* entries of each row of x_rows [B, N] vs
    the shared sample y [M]. Rows with no valid entries return NaN."""
    B, N = x_rows.shape
    M = y.shape[0]
    n_valid = x_valid.sum(axis=1)
    xm = jnp.where(x_valid, x_rows, jnp.inf).astype(jnp.float32)
    yb = jnp.broadcast_to(y.astype(jnp.float32), (B, M))
    values = jnp.concatenate([xm, yb], axis=1)
    wx = jnp.concatenate(
        [jnp.where(x_valid, 1.0 / jnp.maximum(n_valid, 1)[:, None], 0.0),
         jnp.zeros((B, M))], axis=1,
    ).astype(jnp.float32)
    wy = jnp.concatenate(
        [jnp.zeros((B, N)), jnp.full((B, M), 1.0 / M)], axis=1
    ).astype(jnp.float32)
    d = _ks_from_pooled(values, wx, wy)
    return jnp.where(n_valid > 0, d, jnp.nan)


@jax.jit
def batched_ks_2samp(x_rows: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """KS statistic of each full row of x_rows [B, N] vs shared sample y [M].
    Rows containing NaN (the no-matched-reads case, see spec.calc_breakscore)
    return NaN, mirroring the undefined statistic."""
    bad = jnp.isnan(x_rows).any(axis=1)
    x_clean = jnp.where(jnp.isnan(x_rows), 0.0, x_rows)
    d = batched_ks_2samp_masked(
        x_clean, jnp.ones(x_rows.shape, bool), y
    )
    return jnp.where(bad, jnp.nan, d)
