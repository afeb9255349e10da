"""Counter-based threefry2x32 PRNG, bit-exact with ``jax.random``.

The JAX package draws every random number of the flagship path from
``jax.random``: Poisson(1) bootstrap counts and per-node mtry draws in
the forest grower, multinomial indices in the AIPW bootstrap, the
causal forest's half-samples and honesty draws. This
module reproduces those streams bit for bit, in the layout jax uses
when ``jax_threefry_partitionable`` is on (its default):

* a key is a pair of uint32 words ``(k1, k2)``; ``key(seed)`` is
  ``(seed >> 32, seed & 0xffffffff)``;
* ``split(key, n)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))`` — independent of ``n``;
* ``bits(key, shape)`` hashes the 64-bit flat index of every element
  (hi word, lo word) and returns ``out1 ^ out2``;
* ``uniform`` fills the mantissa of a number in [1, 2) and subtracts 1;
  ``normal`` is ``√2·erf⁻¹(uniform(nextafter(−1, 0), 1))`` with XLA:CPU's
  float32 ``ErfInv`` (Giles' polynomial over its own ``log1p``, see
  :func:`erf_inv`): jax's bits;
  ``randint`` folds two 32-bit draws into the span (jax's two-draw
  modulus, ``jax/_src/random.py::_randint``); ``bernoulli`` compares a
  uniform draw with ``p``;
* ``permutation`` shuffles as jax's ``_shuffle`` does: not Fisher–Yates
  but ``ceil(3·ln n / ln(2**32 − 1))`` rounds, each splitting the key,
  drawing 32-bit sort keys and reordering by a **stable** sort of them
  (32-bit keys tie, and the tie order is part of the result).

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


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: an int, or
    an int64 tensor of uint32 values broadcast against the key batch
    (``vmap`` over ``data``)."""
    k1, k2 = _words(k, 0)
    if isinstance(data, torch.Tensor):
        d = (data.to(device=k.device, dtype=torch.int64) & _MASK)
        k1, k2, d = torch.broadcast_tensors(k1, k2, d)
    else:
        d = k1 * 0 + (int(data) & _MASK)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
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
        # graftlint: disable=TGL004 — jax.random.uniform's 64-bit draw for dtype=float64, bit for bit
        floats = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform supports float32 and float64, got {dtype}")
    # Filled on the device: a host scalar copied to the card would wait
    # for its queue at every draw (two syncs a grow level).
    lo = torch.full((), minval, dtype=dtype, device=floats.device)
    hi = torch.full((), maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as a fused multiply-add does, on
    any device. In float64 the product of two float32 values is exact;
    TwoSum gives the sum's rounding error, which decides the one case
    where rounding the float64 sum to float32 differs from rounding the
    exact value: a float64 sum halfway between two float32 values."""
    # graftlint: disable=TGL004 — the fused multiply-add rounded once: float64 holds the float32 product exactly (docstring above)
    a, b, c = (torch.as_tensor(v).to(torch.float64) for v in (a, b, c))
    prod = a * b
    s = prod + c
    bv = s - prod
    err = (prod - (s - bv)) + (c - bv)  # s + err == prod + c exactly
    r = s.to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    # graftlint: disable=TGL004 — the fused multiply-add rounded once: float64 holds the float32 product exactly (docstring above)
    other = torch.where(s > r.to(torch.float64), up, down)
    # graftlint: disable=TGL004 — the fused multiply-add rounded once: float64 holds the float32 product exactly (docstring above)
    tie = (s == (r.to(torch.float64) + other.to(torch.float64)) / 2) & (err != 0)
    return torch.where(tie, torch.where(err > 0, torch.maximum(r, other),
                                        torch.minimum(r, other)), r)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=like.device)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``c₀·xⁿ + … + cₙ`` in float32, one fused multiply-add a step
    (highest power first), as XLA:CPU contracts them."""
    p = _f32(coeffs[0], x).expand_as(x)
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(c, x))
    return p


#: XLA:CPU's float32 ``log`` (Cephes ``logf``): polynomial coefficients,
#: and ln 2 split in two.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def xla_log_f32(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``: frexp to [√½, √2) − 1, the Cephes
    polynomial in three interleaved Horner chains, each step a fused
    multiply-add, and ``y·x³ + q₁·e`` contracted the way LLVM contracts
    it. Positive finite inputs (the only ones :func:`erf_inv` gives it);
    0 gives −inf."""
    x = torch.maximum(a, _f32(np.finfo(np.float32).tiny, a))
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < _f32(0.707106781186547524, a)
    one = _f32(1.0, a)
    x = (m - one) + torch.where(small, m, torch.zeros_like(m))
    e = e - torch.where(small, one, torch.zeros_like(one))
    x2 = x * x
    x3 = x2 * x
    p = [_f32(c, a) for c in _LOG_P]
    y, y1, y2 = _fma(x, p[0], p[1]), _fma(x, p[3], p[4]), _fma(x, p[6], p[7])
    y, y1, y2 = _fma(y, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _f32(_LOG_Q1, a) * e)
    x = (x - x2 * _f32(0.5, a)) + y
    out = x + _f32(_LOG_Q2, a) * e
    return torch.where(a == 0.0, _f32(float("-inf"), a), out)


#: XLA's ``log1p`` rational approximation (Cephes) for |x| < √2 − 1,
#: numerator and denominator, highest power first.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def xla_log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p``: for |x| < √2 − 1 the Cephes rational
    ``x − x²/2 + x³·N(x)/D(x)`` (Horner steps fused), else
    :func:`xla_log_f32` of ``1 + x``. Neither correctly rounded nor
    ``log(1 + x)``: it is what ``jnp.log1p`` returns on the CPU, bit for
    bit (``tests/test_torch_scenarios.py``)."""
    x2 = x * x
    ratio = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + (_f32(-0.5, x) * x2 + (x * x2) * ratio)
    large = xla_log_f32(_f32(1.0, x) + x)
    return torch.where(torch.abs(x) < _f32(0.41421356237309504880, x), small, large)


#: XLA's float32 ErfInv coefficients (Giles, "Approximating the erfinv
#: function"), highest power first, for w < 5 and for w ≥ 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of float32 ``x`` as XLA:CPU computes it: ``w =
    −log1p(−x²)`` (:func:`xla_log1p_f32`); ``w − 2.5`` (w < 5) or ``√w −
    3``; nine Horner steps ``p = c + p·w``, each a fused multiply-add;
    ``p·x``; ±inf at |x| = 1. Every step is an IEEE float32 operation or
    a float64 one rounded once, so the bits are the same on every
    device."""
    if x.dtype != torch.float32:
        raise TypeError(f"erf_inv takes float32, got {x.dtype}")
    w = -xla_log1p_f32(-(x * x))
    lt = w < 5.0
    # √w correctly rounded (in float64, rounded once): PyTorch's float32
    # sqrt is an approximation on the CPU, not the card's.
    # graftlint: disable=TGL004 — float32 sqrt is not correctly rounded on the CPU; float64 rounded once gives XLA's bits on every device
    w = torch.where(lt, w - 2.5, torch.sqrt(w.to(torch.float64)).to(torch.float32) - 3.0)
    p = _f32(0.0, x).expand_as(x)
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        p = _fma(p, w, torch.where(lt, _f32(a, x), _f32(b, x)))
    out = p * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), out)


def normal(k: torch.Tensor, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (jax's ``_normal_real``):
    ``√2·erf⁻¹(u)`` with ``u = uniform(key, shape, lo=nextafter(−1, 0),
    hi=1)``: jax's bits on the CPU (``tests/test_torch_scenarios.py``)."""
    if dtype != torch.float32:
        raise TypeError(f"normal supports float32 (XLA's float32 ErfInv), got {dtype}")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, dtype, lo, 1.0)
    return torch.tensor(np.float32(np.sqrt(2.0)), device=u.device) * erf_inv(u)


def bernoulli(k: torch.Tensor, p: float = 0.5, shape=(),
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (its default ``mode="low"``):
    ``uniform(key, shape, dtype) < p``, a bool tensor. ``dtype`` is the
    float type jax gives ``p``: float32, or float64 under x64."""
    return uniform(k, shape, dtype) < torch.tensor(p, dtype=dtype)


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


def shuffle_rounds(n: int) -> int:
    """The number of sort rounds jax's ``_shuffle`` takes for ``n``
    elements (``jax/_src/random.py::_shuffle``: exponent 3)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(k: torch.Tensor, x) -> torch.Tensor:
    """``jax.random.permutation(key, x)``: an int ``x`` shuffles
    ``arange(x)`` (int64 here, int32 in jax without x64: the same
    values), a 1-D tensor is shuffled itself. jax's ``_shuffle``: each
    round splits the key, draws one uint32 sort key per element from the
    second half, and reorders by a stable sort of those keys. A batch of
    keys (B, 2) gives B permutations, (B, n): ``vmap`` of the one-key
    form."""
    if isinstance(x, int):
        x = torch.arange(x, device=k.device)
    if x.ndim != 1:
        raise ValueError(f"permutation takes an int or a 1-D tensor, got shape {tuple(x.shape)}")
    batch = tuple(k.shape[:-1])
    for _ in range(shuffle_rounds(x.shape[-1])):
        k, sub = split(k).unbind(dim=-2)
        order = torch.sort(bits(sub, x.shape[-1:]), stable=True).indices.to(x.device)
        x = torch.gather(x.expand(*batch, -1), -1, order) if batch else x[order]
    return x.expand(*batch, -1) if batch else x
