"""R-compatible random number generation (host-side, NumPy).

The reference's data pipeline is seeded with R's Mersenne-Twister
(``set.seed(1991)``, ``ate_replication.Rmd:42``) and draws the 50k-row
subsample via ``dplyr::sample_n`` (``Rmd:67``) and bootstrap indices via
``sample(n, n, replace = TRUE)`` (``ate_functions.R:269``). Bit-matching
the R point estimates to 1e-4 (BASELINE.md) therefore requires reproducing

  * R's ``set.seed`` scrambling + MT19937 stream (R's ``RNG.c``
    semantics: 50 LCG warm-up steps, 625 LCG-filled state words, block
    generation with standard MT19937 tempering, output scaled by
    2^-32 with endpoint fixup), and
  * R's ``sample.int`` index algorithms — both the pre-3.6 "Rounding"
    default (``floor(n * unif_rand())``, the one active when the
    reference was written in 2018) and the 3.6+ "Rejection" method.

This is deliberately a **host-side** component: it feeds data prep, not
the device hot path. Device-resident sampling (the bootstrap, the
forest) uses the threefry keys of ``ops/random.py``; ``RCompatRNG`` is
the validation mode (SURVEY.md §7.3 item 3). A copy of the JAX
package's ``utils/rrandom.py``: the port imports nothing from it.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)
_I2_32M1 = 2.3283064365386963e-10  # 1 / (2^32 - 1) as used by R's MT scaling


class RCompatRNG:
    """MT19937 stream matching R's ``set.seed(seed)`` / ``runif`` exactly."""

    def __init__(self, seed: int, sample_kind: str = "rounding"):
        if sample_kind not in ("rounding", "rejection"):
            raise ValueError(f"sample_kind must be 'rounding' or 'rejection', got {sample_kind!r}")
        self.sample_kind = sample_kind
        self._set_seed(seed)

    # -- seeding ---------------------------------------------------------
    def _set_seed(self, seed: int) -> None:
        s = np.uint32(seed)
        # R RNG_Init: 50 warm-up LCG steps, then 625 state words
        # (word 0 is the MT position counter, forced to N by FixupSeeds).
        with np.errstate(over="ignore"):
            for _ in range(50):
                s = np.uint32(69069) * s + np.uint32(1)
            state = np.empty(_N + 1, dtype=np.uint32)
            for j in range(_N + 1):
                s = np.uint32(69069) * s + np.uint32(1)
                state[j] = s
        self._mt = state[1:].copy()
        self._mti = _N  # FixupSeeds(initial=True): position = N => regenerate on first draw
        self._block = np.empty(0, dtype=np.float64)
        self._pos = 0

    # -- core generation -------------------------------------------------
    def _regenerate(self) -> None:
        """One MT19937 block update, vectorized (three dependency stages)."""
        mt = self._mt
        nxt = np.roll(mt, -1)
        with np.errstate(over="ignore"):
            # Stage 1: kk in [0, N-M) — depends only on old state.
            y = (mt[: _N - _M] & _UPPER_MASK) | (nxt[: _N - _M] & _LOWER_MASK)
            mt[: _N - _M] = mt[_M:_N] ^ (y >> np.uint32(1)) ^ np.where(
                y & np.uint32(1), _MATRIX_A, np.uint32(0)
            )
            # Stage 2: kk in [N-M, N-1) — mt[kk] depends on mt[kk-227],
            # which for kk >= 2*(N-M) was itself rewritten earlier in
            # stage 2. The dependency stride is N-M = 227, so two
            # sub-slices of width <= 227 are each internally dependency-
            # free: [227, 454) reads stage-1 results, [454, 623) reads
            # the first sub-slice's results.
            for lo, hi in ((_N - _M, 2 * (_N - _M)), (2 * (_N - _M), _N - 1)):
                y = (mt[lo:hi] & _UPPER_MASK) | (mt[lo + 1 : hi + 1] & _LOWER_MASK)
                mt[lo:hi] = mt[lo - (_N - _M) : hi - (_N - _M)] ^ (
                    y >> np.uint32(1)
                ) ^ np.where(y & np.uint32(1), _MATRIX_A, np.uint32(0))
            # Stage 3: the last word wraps to updated mt[0].
            y = (mt[_N - 1] & _UPPER_MASK) | (mt[0] & _LOWER_MASK)
            mt[_N - 1] = mt[_M - 1] ^ (y >> np.uint32(1)) ^ (
                _MATRIX_A if (y & np.uint32(1)) else np.uint32(0)
            )
            # Tempering (vectorized over the whole block).
            t = mt.copy()
            t ^= t >> np.uint32(11)
            t ^= (t << np.uint32(7)) & np.uint32(0x9D2C5680)
            t ^= (t << np.uint32(15)) & np.uint32(0xEFC60000)
            t ^= t >> np.uint32(18)
        u = t.astype(np.float64) * _I2_32M1
        # R's fixup(): keep draws strictly inside (0, 1).
        u = np.where(u <= 0.0, 0.5 * _I2_32M1, u)
        u = np.where(1.0 - u <= 0.0, 1.0 - 0.5 * _I2_32M1, u)
        self._block = u
        self._pos = 0

    def runif(self, n: int) -> np.ndarray:
        """``runif(n)`` — n doubles in (0, 1) from the MT stream."""
        out = np.empty(n, dtype=np.float64)
        filled = 0
        while filled < n:
            if self._pos >= self._block.shape[0]:
                self._regenerate()
            take = min(n - filled, self._block.shape[0] - self._pos)
            out[filled : filled + take] = self._block[self._pos : self._pos + take]
            self._pos += take
            filled += take
        return out

    # -- R sample() ------------------------------------------------------
    def _unif_index(self, dn: int) -> int:
        """R_unif_index for the 'rejection' sample kind (R >= 3.6)."""
        if dn <= 0:
            return 0
        bits = int(np.ceil(np.log2(dn)))
        while True:
            v = 0
            nb = 0
            while nb <= bits:
                v = 65536 * v + int(self.runif(1)[0] * 65536)
                nb += 16
            v &= (1 << bits) - 1
            if v < dn:
                return v

    def _rejection_sample_with_replacement(self, n: int, size: int) -> np.ndarray:
        """Vectorized R>=3.6 rejection sampling with replacement.

        The rejection loop's stream consumption is data-dependent, so a
        deep-copied probe stream first discovers exactly how many
        attempts the serial algorithm would make; the attempt values are
        then computed in bulk and the real stream advanced by precisely
        that many draws — bit-identical to the per-draw loop at
        vectorized speed (the B=1000 x 9k-row R-compat bootstrap needs
        ~1e7 attempts).
        """
        import copy

        bits = int(np.ceil(np.log2(n))) if n > 1 else 0
        count = bits // 16 + 1  # uniforms consumed per attempt
        mask = (1 << bits) - 1
        probe = copy.deepcopy(self)
        chunks: list[np.ndarray] = []
        accepted = 0
        while accepted < size:
            m = max(1024, int((size - accepted) * 2.2))
            u = probe.runif(m * count).reshape(m, count)
            v = np.zeros(m, dtype=np.int64)
            for c in range(count):
                v = 65536 * v + np.floor(u[:, c] * 65536.0).astype(np.int64)
            v &= mask
            chunks.append(v)
            accepted += int((v < n).sum())
        v = np.concatenate(chunks)
        ok_pos = np.nonzero(v < n)[0]
        total_attempts = int(ok_pos[size - 1]) + 1
        self.runif(total_attempts * count)  # advance the real stream
        return v[ok_pos[:size]]

    def sample_int(self, n: int, size: int | None = None, replace: bool = False) -> np.ndarray:
        """R ``sample.int(n, size, replace)`` — 0-based indices.

        R returns 1-based; we return 0-based for direct NumPy indexing.
        """
        if size is None:
            size = n
        if replace:
            if self.sample_kind == "rounding":
                u = self.runif(size)
                return np.floor(n * u).astype(np.int64)
            return self._rejection_sample_with_replacement(n, size)
        if size > n:
            raise ValueError("cannot take a sample larger than the population without replacement")
        # R SampleNoReplace: partial Fisher–Yates with a shrinking pool.
        x = np.arange(n, dtype=np.int64)
        out = np.empty(size, dtype=np.int64)
        if self.sample_kind == "rounding":
            u = self.runif(size)  # exactly one draw per iteration
            m = n
            for i in range(size):
                j = int(m * u[i])
                out[i] = x[j]
                m -= 1
                x[j] = x[m]
        else:
            m = n
            for i in range(size):
                j = self._unif_index(m)
                out[i] = x[j]
                m -= 1
                x[j] = x[m]
        return out

    def sample_n_rows(self, n_rows: int, size: int) -> np.ndarray:
        """``dplyr::sample_n(df, size)`` row indices (0-based): a
        without-replacement ``sample.int(n_rows, size)``."""
        return self.sample_int(n_rows, size, replace=False)
