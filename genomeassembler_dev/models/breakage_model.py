"""Breakage-probability models.

The reference's probability source is a static lookup table distilled from
ultrasonication experiments (data/QueryTable, produced by a companion
preprocessing repo — SURVEY.md §1). This module provides:

  * TableModel — the dense lookup, exactly the reference's semantics;
  * MLPBreakageModel — a trainable neural surrogate mapping octamer one-hots
    to log-probabilities. It generalises the table (e.g. to unseen k or to
    condition on context) and gives the framework a first-class *training*
    path: the train step is pure JAX + optax and is designed to shard over a
    (dp, tp) mesh — batch data-parallel, hidden dimension tensor-parallel —
    which __graft_entry__.dryrun_multichip exercises.

bf16 matmuls with f32 accumulation; parameters stay f32.
"""

from __future__ import annotations

from dataclasses import dataclass
import jax
import jax.numpy as jnp
import numpy as np
import optax

from genomeassembler_dev.core.querytable import QueryTable


@dataclass(frozen=True)
class TableModel:
    """The reference's probability source: dense code-indexed lookup."""

    table: QueryTable

    def log_prob(self, k: int, codes: jnp.ndarray) -> jnp.ndarray:
        return jnp.log(jnp.asarray(self.table.probs[k], jnp.float32))[codes]


def one_hot_octamer(codes: jnp.ndarray, k: int = 8) -> jnp.ndarray:
    """[N] integer k-mer codes -> [N, 4k] position-wise one-hot features."""
    shifts = 2 * jnp.arange(k - 1, -1, -1, dtype=codes.dtype)
    digits = (codes[:, None] >> shifts[None, :]) & 3  # [N, k]
    return jax.nn.one_hot(digits, 4, dtype=jnp.float32).reshape(codes.shape[0], 4 * k)


def init_params(key: jax.Array, k: int = 8, hidden: int = 256) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    d_in = 4 * k
    s1 = (2.0 / d_in) ** 0.5
    s2 = (2.0 / hidden) ** 0.5
    return {
        "w1": jax.random.normal(k1, (d_in, hidden), jnp.float32) * s1,
        "b1": jnp.zeros((hidden,), jnp.float32),
        "w2": jax.random.normal(k2, (hidden, hidden), jnp.float32) * s2,
        "b2": jnp.zeros((hidden,), jnp.float32),
        "w3": jax.random.normal(k3, (hidden, 1), jnp.float32) * s2,
        "b3": jnp.zeros((1,), jnp.float32),
    }


def forward(params: dict, feats: jnp.ndarray) -> jnp.ndarray:
    """[N, 4k] features -> [N] predicted log-probability.

    Layer 1 is column-parallel and layer 2 row-parallel under a "tp" sharding
    of the hidden dimension; XLA inserts the reduce for layer 2 when the
    arrays carry shardings (see parallel/sharding.py).
    """
    x = feats.astype(jnp.bfloat16)
    h = jnp.dot(x, params["w1"].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32) + params["b1"]
    h = jax.nn.gelu(h)
    h = jnp.dot(h.astype(jnp.bfloat16), params["w2"].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32) + params["b2"]
    h = jax.nn.gelu(h)
    out = jnp.dot(h.astype(jnp.bfloat16), params["w3"].astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32) + params["b3"]
    return out[:, 0]


def loss_fn(params: dict, codes: jnp.ndarray, target_logp: jnp.ndarray) -> jnp.ndarray:
    pred = forward(params, one_hot_octamer(codes))
    return jnp.mean((pred - target_logp) ** 2)


def make_train_step(optimizer: optax.GradientTransformation):
    @jax.jit
    def train_step(params, opt_state, codes, target_logp):
        loss, grads = jax.value_and_grad(loss_fn)(params, codes, target_logp)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def save_params(path: str, params: dict) -> None:
    """Checkpoint model parameters (npz; orbax-free so it works everywhere)."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params(path: str) -> dict:
    with np.load(path) as d:
        return {k: jnp.asarray(d[k]) for k in d.files}


def fit_to_table(
    table: QueryTable,
    k: int = 8,
    steps: int = 200,
    batch: int = 4096,
    hidden: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
):
    """Distil the k-mer table into the MLP. Returns (params, losses)."""
    key = jax.random.key(seed)
    params = init_params(key, k, hidden)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    step = make_train_step(opt)
    logp = jnp.log(jnp.asarray(table.probs[k], jnp.float32))
    n = logp.shape[0]
    losses = []
    for i in range(steps):
        key, sub = jax.random.split(key)
        codes = jax.random.randint(sub, (batch,), 0, n)
        params, opt_state, loss = step(params, opt_state, codes, logp[codes])
        losses.append(float(loss))
    return params, np.asarray(losses)
