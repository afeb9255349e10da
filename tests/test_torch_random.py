"""ops/random.py reproduces jax.random's threefry streams bit for bit
(partitionable layout, this image's default)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import random as rnd

SEEDS = [0, 1, 7, 12325, 1991, 2**31 - 1, 2**32 + 3, 2**40 + 12345]
SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 5), (257,), (16, 63)]


def _jkey(seed):
    return jax.random.key(seed)


def _tkey(seed):
    return rnd.key(seed, device="cpu")


def _data(k):
    return np.asarray(jax.random.key_data(k))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


def test_known_bits():
    got = rnd.bits(_tkey(12325), (3,)).numpy()
    assert got.tolist() == [1854893196, 987109823, 1758666526]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = _jkey(seed), _tkey(seed)
    assert np.array_equal(rnd.key_data(tk), _data(jk))
    for num in (1, 2, 3, 16, 100):
        assert np.array_equal(rnd.key_data(rnd.split(tk, num)), _data(jax.random.split(jk, num)))
    for d in (0, 1, 5, 2**31 + 7):
        assert np.array_equal(rnd.key_data(rnd.fold_in(tk, d)), _data(jax.random.fold_in(jk, d)))
    # split(key, n)[i] does not depend on n.
    assert np.array_equal(rnd.key_data(rnd.split(tk, 7)[:3]), rnd.key_data(rnd.split(tk, 3)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_randint(seed, shape):
    jk, tk = _jkey(seed), _tkey(seed)
    assert np.array_equal(rnd.bits(tk, shape).numpy(),
                          np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    assert np.array_equal(rnd.uniform(tk, shape).numpy(),
                          np.asarray(jax.random.uniform(jk, shape, jnp.float32)))
    assert np.array_equal(rnd.uniform(tk, shape, dtype=torch.float64).numpy(),
                          np.asarray(jax.random.uniform(jk, shape, jnp.float64)))
    for lo, hi in ((0, 11016), (0, 2), (-5, 1_000_003), (0, 2**31 - 1), (4, 4)):
        assert np.array_equal(rnd.randint(tk, shape, lo, hi).numpy(),
                              np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32)))


def test_batched_keys_match_per_key_draws():
    """A (T, 2) key batch draws T streams, each equal to its own key's."""
    keys = rnd.split(_tkey(3), 5)
    jkeys = jax.random.split(_jkey(3), 5)
    batch = rnd.bits(keys, (4, 6)).numpy()
    for i in range(5):
        assert np.array_equal(batch[i], np.asarray(jax.random.bits(jkeys[i], (4, 6), jnp.uint32)))
    u = rnd.uniform(keys, (3, 7)).numpy()
    for i in range(5):
        assert np.array_equal(u[i], np.asarray(jax.random.uniform(jkeys[i], (3, 7), jnp.float32)))


def test_key_from_jax_roundtrip():
    jk = jax.random.split(_jkey(99), 4)
    tk = rnd.key_from_jax(_data(jk), device="cpu")
    assert tk.shape == (4, 2) and tk.dtype == torch.int64
    assert np.array_equal(rnd.key_data(tk), _data(jk))


def test_bad_keys_rejected():
    with pytest.raises(ValueError):
        rnd.key(-1, device="cpu")
    with pytest.raises(ValueError):
        rnd.bits(torch.zeros(3, dtype=torch.int64), (2,))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bernoulli(seed, shape):
    """The causal forest's honesty draw, ``bernoulli(key, 0.5, (n,))``,
    and other probabilities; float32 as in production, float64 as jax
    draws it under x64."""
    jk, tk = _jkey(seed), _tkey(seed)
    for p in (0.5, 0.3, 0.9):
        with jax.enable_x64(False):
            ref = np.asarray(jax.random.bernoulli(jk, p, shape))
        got = rnd.bernoulli(tk, p, shape)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
        with jax.enable_x64(True):
            ref64 = np.asarray(jax.random.bernoulli(jk, p, shape))
        assert np.array_equal(rnd.bernoulli(tk, p, shape, dtype=torch.float64).numpy(), ref64)


def test_bernoulli_batched_keys():
    """A (T, 2) key batch draws T honesty masks, each its own key's."""
    keys = rnd.split(_tkey(21), 6)
    jkeys = jax.random.split(_jkey(21), 6)
    got = rnd.bernoulli(keys, 0.5, (300,)).numpy()
    with jax.enable_x64(False):
        for i in range(6):
            assert np.array_equal(got[i], np.asarray(jax.random.bernoulli(jkeys[i], 0.5, (300,))))
