"""Breakage-probability models."""

import numpy as np
import jax
import jax.numpy as jnp

from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.models import breakage_model as bm


def test_one_hot_features():
    codes = jnp.asarray([0, 65535], jnp.int32)
    f = np.asarray(bm.one_hot_octamer(codes))
    assert f.shape == (2, 32)
    # AAAAAAAA -> every position one-hot at A
    assert f[0].reshape(8, 4)[:, 0].sum() == 8
    # TTTTTTTT -> every position one-hot at T
    assert f[1].reshape(8, 4)[:, 3].sum() == 8


def test_table_model_lookup():
    table = load_default_query_table()
    m = bm.TableModel(table)
    codes = jnp.asarray([0, 1, 2], jnp.int32)
    lp = np.asarray(m.log_prob(8, codes))
    np.testing.assert_allclose(lp, np.log(table.probs[8][:3]), rtol=1e-5)


def test_fit_reduces_loss():
    table = load_default_query_table()
    params, losses = bm.fit_to_table(table, steps=300, batch=2048, hidden=128,
                                     lr=3e-3)
    assert losses[-1] < losses[0] * 0.5
    # predictions correlate with the table across the code space
    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 65536, size=4096), jnp.int32)
    pred = np.asarray(bm.forward(params, bm.one_hot_octamer(codes)))
    target = np.log(table.probs[8][np.asarray(codes)])
    corr = np.corrcoef(pred, target)[0, 1]
    assert corr > 0.3, corr  # surrogate demo: positional MLP captures part of the table


def test_train_step_jit_stable():
    import optax

    table = load_default_query_table()
    opt = optax.adam(1e-3)
    step = bm.make_train_step(opt)
    params = bm.init_params(jax.random.key(0), hidden=32)
    state = opt.init(params)
    logp = jnp.log(jnp.asarray(table.probs[8], jnp.float32))
    codes = jax.random.randint(jax.random.key(1), (128,), 0, logp.shape[0])
    p1, s1, l1 = step(params, state, codes, logp[codes])
    p2, s2, l2 = step(p1, s1, codes, logp[codes])
    assert np.isfinite(float(l1)) and float(l2) < float(l1)


def test_params_roundtrip(tmp_path):
    params = bm.init_params(jax.random.key(0), hidden=16)
    p = str(tmp_path / "ckpt" / "model.npz")
    bm.save_params(p, params)
    loaded = bm.load_params(p)
    assert set(loaded) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(loaded[k]), np.asarray(params[k]))
