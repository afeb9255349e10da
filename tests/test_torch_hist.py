"""ops/hist.py: the plain histogram and node sums equal the JAX
package's Pallas kernels (run in interpret mode). The CUDA kernel is
held against the plain version in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_tpu.ops import hist_pallas as jh

N_BINS = 64


def _case(seed, n, p, t, k, m, integer=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)  # −1 and ≥ M drop out
    if integer:
        counts = rng.poisson(1.0, size=(t, n)).astype(np.float32)
        y = (rng.random(n) < 0.4).astype(np.float32)
        w = np.stack([counts, counts * y], axis=1)[:, :k]
    else:
        w = rng.normal(size=(t, k, n)).astype(np.float32)
    return codes, ids, w


def _jax_batched(codes, ids, w, m):
    return np.asarray(jh.bin_histogram_pallas_batched(
        jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(w),
        max_nodes=m, n_bins=N_BINS, interpret=True))


def _torch_batched(codes, ids, w, m):
    return th.bin_histogram_batched(torch.as_tensor(codes), torch.as_tensor(ids),
                                    torch.as_tensor(w), max_nodes=m, n_bins=N_BINS).numpy()


@pytest.mark.parametrize("t,m", [(1, 1), (3, 4), (4, 16)])
def test_plain_equals_pallas_interpret_integer_weights(t, m):
    codes, ids, w = _case(t * 100 + m, 1500, 21, t, 2, m)
    assert np.array_equal(_torch_batched(codes, ids, w, m), _jax_batched(codes, ids, w, m))


def test_plain_float_weights_within_bound():
    """Float weights: both sides sum the same products in another order.
    Bound: |Δ| ≤ 8·eps_f32·Σ|w| per cell (a sum of ≤1500 f32 terms)."""
    codes, ids, w = _case(5, 1500, 7, 2, 3, 8, integer=False)
    got, ref = _torch_batched(codes, ids, w, 8), _jax_batched(codes, ids, w, 8)
    scale = np.abs(w).sum(axis=2)[:, :, None, None, None]
    assert np.all(np.abs(got - ref) <= 8 * np.finfo(np.float32).eps * scale)


def test_single_tree_is_the_t1_case_of_the_batched_kernel():
    codes, ids, w = _case(11, 1200, 21, 1, 2, 8)
    ref = np.asarray(jh.bin_histogram_pallas(
        jnp.asarray(codes), jnp.asarray(ids[0]), jnp.asarray(w[0]),
        max_nodes=8, n_bins=N_BINS, interpret=True))
    got = th.bin_histogram(torch.as_tensor(codes), torch.as_tensor(ids[0]),
                           torch.as_tensor(w[0]), max_nodes=8, n_bins=N_BINS).numpy()
    assert np.array_equal(got, ref)


def test_result_independent_of_tree_batch():
    codes, ids, w = _case(12, 900, 21, 5, 2, 4)
    whole = _torch_batched(codes, ids, w, 4)
    for i in range(5):
        assert np.array_equal(whole[i], _torch_batched(codes, ids[i : i + 1], w[i : i + 1], 4)[0])


@pytest.mark.parametrize("m", [1, 16, 512])
def test_node_sums_equal_pallas_interpret(m):
    _, ids, w = _case(13 + m, 1300, 1, 3, 2, m)
    got = th.node_sums(torch.as_tensor(ids), torch.as_tensor(w), m).numpy()
    assert got.shape == (3, m, 2)
    for i in range(3):
        ref = np.asarray(jh.node_sums(jnp.asarray(ids[i]), jnp.asarray(w[i]), m,
                                      backend="pallas_interpret"))
        assert np.array_equal(got[i], ref)


def test_unported_modes_rejected():
    codes, ids, w = (torch.as_tensor(a) for a in _case(1, 100, 3, 1, 2, 2))
    for mode in ("partition", "partition+pack", "auto"):
        with pytest.raises(ValueError, match="not ported"):
            th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=N_BINS, mode=mode)


def test_kernel_path_refuses_float_weights():
    """Off the CPU the wrapper launches the kernel, which adds with
    unordered shared-memory atomics: it runs only for weights the caller
    states are integers (meta tensors reach that check without a card)."""
    codes, ids, w = (torch.as_tensor(a).to("meta") for a in _case(3, 100, 3, 2, 2, 4))
    with pytest.raises(ValueError, match="integer_weights=True"):
        th.bin_histogram_batched(codes, ids, w, max_nodes=4, n_bins=N_BINS)
    with pytest.raises(ValueError, match="integer_weights=True"):
        th.node_sums(ids, w, 4)
    with pytest.raises(ValueError, match="no histogram kernel for device meta"):
        th.bin_histogram_batched(codes, ids, w, max_nodes=4, n_bins=N_BINS, integer_weights=True)


def test_wrapper_rejects_wrong_dtypes():
    codes, ids, w = (torch.as_tensor(a) for a in _case(2, 100, 3, 1, 2, 2))
    with pytest.raises(TypeError):
        th.bin_histogram_batched(codes.long(), ids, w, max_nodes=2, n_bins=N_BINS)
    with pytest.raises(TypeError):
        th.bin_histogram_batched(codes, ids, w.double(), max_nodes=2, n_bins=N_BINS)

