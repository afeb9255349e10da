"""ops/tree.py: the plain route bits and leaf lookup equal the JAX
package's Pallas kernels (interpret mode). The CUDA kernels are held
against the plain versions in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import tree as tt
from ate_replication_causalml_tpu.ops import tree_pallas as jt

N_BINS = 64


def _route_case(seed, n, p, t, m):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)  # −1 and ≥ M give 0
    feat = rng.integers(0, p, size=(t, m)).astype(np.int32)
    thr = rng.integers(0, N_BINS, size=(t, m)).astype(np.int32)
    return codes, ids, feat, thr


@pytest.mark.parametrize("t,m", [(1, 1), (3, 8), (2, 256)])
def test_route_plain_equals_pallas_interpret(t, m):
    codes, ids, feat, thr = _route_case(t * 7 + m, 2500, 21, t, m)
    got = tt.route_bits(*(torch.as_tensor(a) for a in (codes, ids, feat, thr))).numpy()
    codes_t = jt.codes_transposed(jnp.asarray(codes))
    for i in range(t):
        ref = np.asarray(jt.route_bits(codes_t, jnp.asarray(ids[i]), jnp.asarray(feat[i]),
                                       jnp.asarray(thr[i]), backend="pallas_interpret"))
        assert np.array_equal(got[i], ref)
    assert np.all(got[ids < 0] == 0) and np.all(got[ids >= m] == 0)


@pytest.mark.parametrize("k,slots", [(1, 512), (3, 16)])
def test_lookup_plain_equals_pallas_interpret(k, slots):
    rng = np.random.default_rng(k * slots)
    t, n = 3, 2100
    table = rng.normal(size=(t, k, slots)).astype(np.float32)
    ids = rng.integers(-2, slots + 3, size=(t, n)).astype(np.int32)
    got = tt.table_lookup(torch.as_tensor(table), torch.as_tensor(ids)).numpy()
    assert got.shape == (t, k, n)
    for i in range(t):
        ref = np.asarray(jt.table_lookup(jnp.asarray(table[i]), jnp.asarray(ids[i]),
                                         backend="pallas_interpret"))
        assert np.array_equal(got[i], ref)


def test_wrappers_reject_wrong_dtypes():
    codes, ids, feat, thr = (torch.as_tensor(a) for a in _route_case(0, 50, 3, 1, 2))
    with pytest.raises(TypeError):
        tt.route_bits(codes, ids.long(), feat, thr)
    with pytest.raises(TypeError):
        tt.table_lookup(torch.zeros(1, 1, 4, dtype=torch.float64), ids)

