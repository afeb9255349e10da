"""Counter-based threefry2x32 PRNG, bit-exact with ``jax.random``.

The JAX package draws every random number of the flagship path from
``jax.random``: Poisson(1) bootstrap counts and per-node mtry draws in
the forest grower, multinomial indices in the AIPW bootstrap. This
module reproduces those streams bit for bit, in the layout jax uses
when ``jax_threefry_partitionable`` is on (its default):

* a key is a pair of uint32 words ``(k1, k2)``; ``key(seed)`` is
  ``(seed >> 32, seed & 0xffffffff)``;
* ``split(key, n)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))`` — independent of ``n``;
* ``bits(key, shape)`` hashes the 64-bit flat index of every element
  (hi word, lo word) and returns ``out1 ^ out2``;
* ``uniform`` fills the mantissa of a number in [1, 2) and subtracts 1;
  ``randint`` folds two 32-bit draws into the span (jax's two-draw
  modulus, ``jax/_src/random.py::_randint``).

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 values; a
leading batch of keys draws a batch of streams at once (the forest's
tree axis). The uint32 arithmetic runs in int64 with explicit masking,
since torch has little uint32 arithmetic. Every element is hashed from
its own counter, so the same code runs on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ate_replication_causalml_torch import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    holding uint32 values. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data: a (2,) key on ``device``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return torch.tensor(
        [(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
        device=resolve_device(device),
    )


def key_from_jax(key_data: np.ndarray, device=None) -> torch.Tensor:
    """The port's key from ``jax.random.key_data(k)`` (uint32, (..., 2))."""
    a = np.asarray(key_data)
    if a.shape[-1:] != (2,):
        raise ValueError(f"key data must end in an axis of 2, got {a.shape}")
    return torch.as_tensor(a.astype(np.uint32).astype(np.int64)).to(resolve_device(device))


def key_data(k: torch.Tensor) -> np.ndarray:
    """The key's two uint32 words as numpy, the layout of ``jax.random.key_data``."""
    return k.cpu().numpy().astype(np.uint32)


def _words(k: torch.Tensor, n_new_dims: int):
    """The key words of a (..., 2) key batch, shaped to broadcast over
    ``n_new_dims`` trailing sample dimensions."""
    if k.dtype != torch.int64 or k.shape[-1] != 2:
        raise ValueError(f"a key is an int64 tensor of shape (..., 2), got {k.dtype} {tuple(k.shape)}")
    view = k.shape[:-1] + (1,) * n_new_dims
    return k[..., 0].reshape(view), k[..., 1].reshape(view)


def _hash_counters(k: torch.Tensor, shape: tuple[int, ...]):
    """threefry2x32 of every element's 64-bit flat index over ``shape``."""
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=k.device).reshape(shape)
    k1, k2 = _words(k, len(shape))
    return threefry2x32(k1, k2, idx >> 32, idx & _MASK)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) → (..., num, 2)."""
    b1, b2 = _hash_counters(k, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    k1, k2 = _words(k, 0)
    zero = torch.zeros_like(k1)
    b1, b2 = threefry2x32(k1, k2, zero, zero + (int(data) & _MASK))
    return torch.stack([b1, b2], dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0, 2**32)."""
    b1, b2 = _hash_counters(k, tuple(int(s) for s in shape))
    return b1 ^ b2


def uniform(k: torch.Tensor, shape, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 or float64."""
    shape = tuple(int(s) for s in shape)
    if dtype == torch.float32:
        mant = bits(k, shape) >> 9
        floats = (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        b1, b2 = _hash_counters(k, shape)  # 64-bit draw: b1 high, b2 low word
        mant = (b1 << 20) | (b2 >> 12)
        floats = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform supports float32 and float64, got {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``."""
    minval, maxval = int(minval), int(maxval)
    lim = np.iinfo(np.int32)
    if not (lim.min <= minval <= lim.max and lim.min <= maxval <= lim.max):
        raise ValueError("randint bounds must fit in int32")
    shape = tuple(int(s) for s in shape)
    k_hi, k_lo = split(k).unbind(dim=-2)
    higher, lower = bits(k_hi, shape), bits(k_lo, shape)
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = (1 << 16) % span
    # uint32 product: at span > 2**16 the square 2**32 wraps to 0, as in jax.
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    return (minval + offset).to(torch.int32)
