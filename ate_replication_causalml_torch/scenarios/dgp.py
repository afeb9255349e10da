"""Seeded synthetic DGP library for the Monte-Carlo scenario matrix.

Port of ``ate_replication_causalml_tpu/scenarios/dgp.py``. Every cell's
data is a pure function of ``fold_in(root_key, cell_id)``:
:func:`generate` takes a key and a frozen :class:`DGPSpec` and returns
the replicate's ``(x, w, y, tau_true)`` with no ambient state. A batch
of keys (B, 2) draws B replicates at once, (B, n, p) and so on: the
batched columns of ``scenarios/batched.py`` draw their lanes in one
call, and a lane's bits are those of the one-key call (threefry hashes
every element from its own counter; every sum is
:func:`~..ops.linalg.fixed_sum`'s), on either device.

The knobs stress what the literature proves: ``tau="hetero"`` (Wager &
Athey, arXiv:1510.04342, smooth heterogeneous surfaces),
``confounding`` (the propensity's loading γ on x₁, Chernozhukov et al.,
arXiv:1608.00060), ``overlap`` (η, the least propensity, the regime of
residual balancing, arXiv:1604.07125) and ``sparsity``/large ``p``
(Belloni-style decaying coefficients, arXiv:1201.0224).

The outcome is binary through a logit link, so the per-replicate truth
``tau_true = mean(p₁(x) − p₀(x))`` is exact: the sample-average effect
on the probability scale, from the potential probabilities.

The sigmoids, ``exp`` and ``sqrt`` are taken in float64 and rounded
once, every other step is an IEEE float32 operation: a draw is the same
bits on the card and on the CPU. Against the JAX package on the CPU: x
is ``jax.random.normal``'s bits but in the far tail
(:func:`~..ops.random.normal`); ``w`` and ``y`` are equal (a flip needs a
uniform within an ulp of the propensity or the outcome probability); the
sigmoids, ``x·β`` and ``tau_true`` differ by a few ulps (XLA's own
``exp`` and summation orders).
"""

from __future__ import annotations

import dataclasses
import zlib

import torch

from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.linalg import fixed_sum

_DTYPES = {"float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class DGPSpec:
    """One synthetic design, fully determined by its fields (the fields
    ARE the column cache key, ``scenarios.batched.column_cache_key``).

    ``tau``: ``"constant"`` (τ(x) ≡ ``tau_scale`` on the logit scale, the
    calibration design every correctly specified estimator must cover at
    nominal rate) or ``"hetero"`` (the Wager–Athey-style surface)."""

    name: str
    n: int = 512
    p: int = 4
    tau: str = "constant"
    tau_scale: float = 0.8
    confounding: float = 0.0
    overlap: float = 0.5
    sparsity: int = 0
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.tau not in ("constant", "hetero"):
            raise ValueError(f"tau must be 'constant' or 'hetero', got {self.tau!r}")
        if not (0.0 < self.overlap <= 0.5):
            raise ValueError(f"overlap must be in (0, 0.5], got {self.overlap!r}")
        if self.sparsity < 0 or self.sparsity > self.p:
            raise ValueError(f"sparsity must be in [0, p], got {self.sparsity!r}")

    def fields(self) -> tuple:
        """The spec as a flat tuple: the hashable identity the column
        cache key and the checkpoint fingerprint are built from."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def data_cell_id(dgp_name: str, rep: int) -> int:
    """Stable uint32 id of one replicate's data, shared by every
    estimator of the (DGP, rep) row: ``fold_in(root_key, data_cell_id)``
    is the replicate's data key."""
    return zlib.crc32(f"dgp={dgp_name}|rep={rep}".encode())


def estimator_salt(estimator_name: str) -> int:
    """Stable uint32 fold-in constant deriving an estimator's private key
    from the replicate's data key."""
    return zlib.crc32(f"est={estimator_name}".encode())


def torch_dtype(spec: DGPSpec) -> torch.dtype:
    try:
        return _DTYPES[spec.dtype]
    except KeyError:
        raise ValueError(f"DGP dtype must be one of {sorted(_DTYPES)}, got {spec.dtype!r}") from None


def _f64(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn`` in float64, rounded once to ``t``'s dtype: the same bits on
    the card and on the CPU (PyTorch's float32 sigmoid, exp and sqrt are
    each device's own approximation)."""
    return fn(t.to(torch.float64)).to(t.dtype)


def _beta(spec: DGPSpec, dtype, device) -> torch.Tensor:
    """Dense designs load every column at 1/√p; sparse designs
    (``sparsity`` = s > 0) use the Belloni-style 1/(j+1) decay on the
    first s columns and exact zeros elsewhere."""
    idx = torch.arange(spec.p, dtype=dtype, device=device)
    if spec.sparsity > 0:
        return torch.where(idx < spec.sparsity, 1.0 / (idx + 1.0), torch.zeros_like(idx))
    return torch.full((spec.p,), 1.0, dtype=dtype, device=device) / _f64(
        torch.sqrt, torch.tensor(float(spec.p), dtype=dtype, device=device))


def propensity(spec: DGPSpec, x: torch.Tensor) -> torch.Tensor:
    """``e(x) = η + (1−2η)·σ(γ·x₁)`` over the last two axes of x (…, n, p)."""
    eta = torch.tensor(spec.overlap, dtype=x.dtype, device=x.device)
    gamma = torch.tensor(spec.confounding, dtype=x.dtype, device=x.device)
    return eta + (1.0 - 2.0 * eta) * _f64(torch.sigmoid, gamma * x[..., 0])


def tau_surface(spec: DGPSpec, x: torch.Tensor) -> torch.Tensor:
    """τ(x) on the logit scale. ``"hetero"``: the Wager–Athey bump
    ``ς(v) = 1 + 1/(1+exp(−20(v−1/3)))`` over ``σ(x₁)`` and ``σ(x₂)``."""
    scale = torch.tensor(spec.tau_scale, dtype=x.dtype, device=x.device)
    if spec.tau == "constant":
        return scale.expand(x.shape[:-1])

    def varsigma(v):
        return 1.0 + 1.0 / (1.0 + _f64(torch.exp, -20.0 * (v - 1.0 / 3.0)))

    u1 = _f64(torch.sigmoid, x[..., 0])
    u2 = _f64(torch.sigmoid, x[..., 1 % spec.p])
    return scale * varsigma(u1) * varsigma(u2) / 4.0


def generate(spec: DGPSpec, key: torch.Tensor):
    """One replicate ``(x, w, y, tau_true)`` per key, a pure function of
    ``(spec, key)``; a key batch (B, 2) gives (B, n, p), (B, n), (B, n),
    (B,). Binary outcome through a logit link, ``p₀ = σ(x·β)``, ``p₁ =
    σ(x·β + τ(x))``; realized ``y`` uses one shared uniform for both
    potential outcomes. ``tau_true`` is the exact sample-average effect
    ``mean(p₁ − p₀)``."""
    dtype = torch_dtype(spec)
    kx, kw, ky = rnd.split(key, 3).unbind(dim=-2)
    x = rnd.normal(kx, (spec.n, spec.p), dtype)
    e = propensity(spec, x)
    w = (rnd.uniform(kw, (spec.n,), dtype) < e).to(dtype)
    eta0 = fixed_sum(x * _beta(spec, dtype, x.device))
    p0 = _f64(torch.sigmoid, eta0)
    p1 = _f64(torch.sigmoid, eta0 + tau_surface(spec, x))
    u = rnd.uniform(ky, (spec.n,), dtype)
    y = torch.where(w == 1.0, u < p1, u < p0).to(dtype)
    # A tensor divisor: the card divides by a host scalar as a multiply by
    # its reciprocal, which is not the CPU's quotient for n = 96.
    tau_true = fixed_sum(p1 - p0) / torch.tensor(float(spec.n), dtype=dtype, device=x.device)
    return x, w, y, tau_true


#: The stock designs the micro matrix, the chip smoke and the tests draw
#: from: ``calibration`` is the randomized correctly specified design
#: whose coverage must sit at nominal; the others turn one knob each.
STOCK_DGPS: dict[str, DGPSpec] = {
    d.name: d
    for d in (
        DGPSpec(name="calibration", n=512, p=4, tau="constant",
                tau_scale=0.8, confounding=0.0, overlap=0.5),
        DGPSpec(name="hetero_confounded", n=512, p=4, tau="hetero",
                tau_scale=0.8, confounding=1.0, overlap=0.1),
        DGPSpec(name="overlap_violation", n=512, p=4, tau="constant",
                tau_scale=0.8, confounding=2.0, overlap=0.02),
        DGPSpec(name="sparse_highdim", n=128, p=384, tau="constant",
                tau_scale=0.8, confounding=0.5, overlap=0.2, sparsity=4),
    )
}
