"""Hash-sharded table lookup with all_to_all exchange vs direct gather."""

import numpy as np
import pytest
import jax.numpy as jnp

from genomeassembler_dev.core.querytable import load_default_query_table
from genomeassembler_dev.parallel.mesh import make_mesh
from genomeassembler_dev.parallel.table_sharding import make_sharded_table_lookup


@pytest.fixture(scope="module")
def table():
    return load_default_query_table()


@pytest.mark.parametrize("n_shard", [2, 4])
def test_matches_direct_gather(table, n_shard):
    mesh = make_mesh(seg=1, read=1, tp=n_shard)
    lookup = make_sharded_table_lookup(mesh, 65536, axis="tp")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 65536, size=(3, 8 * n_shard)).astype(np.int32)
    tbl = jnp.asarray(table.probs[8], jnp.float32)
    probs, overflow = lookup(jnp.asarray(codes), tbl)
    assert int(overflow) == 0
    np.testing.assert_allclose(
        np.asarray(probs), np.asarray(tbl)[codes], rtol=1e-6
    )


def test_skewed_distribution_overflow_detected(table):
    mesh = make_mesh(seg=1, read=1, tp=4)
    # tiny capacity forces overflow when every code routes to one shard
    lookup = make_sharded_table_lookup(mesh, 65536, axis="tp", cap=2)
    codes = np.zeros((1, 32), np.int32)  # all route to shard 0
    tbl = jnp.asarray(table.probs[8], jnp.float32)
    probs, overflow = lookup(jnp.asarray(codes), tbl)
    assert int(overflow) > 0
    assert np.isnan(np.asarray(probs)).any()
