"""The crc32-jittered exponential backoff of the port's retry loops.

Port of ``ate_replication_causalml_tpu/resilience/backoff.py``:
exponential in the attempt, a deterministic jitter in [0, 25%) from a
crc32 of the key, capped at ``cap_mult × base_s`` (and optionally an
absolute ceiling). A pure function of its arguments, equal to the JAX
package's for every input, so retries de-herd across sites with no
nondeterminism and tests can assert the exact sleep schedule.
"""

from __future__ import annotations

import zlib

#: Backoff growth is capped at this multiple of the base delay: after a
#: few doublings a longer sleep buys no recovery, only burns the run's
#: time.
BACKOFF_CAP_MULT = 8.0


def jittered_backoff_delay(
    key: str,
    attempt: int,
    base_s: float,
    cap_mult: float = BACKOFF_CAP_MULT,
    cap_s: float | None = None,
) -> float:
    """Seconds to sleep before retry ``attempt`` (1-based) of the work
    identified by ``key``."""
    if base_s <= 0.0:
        return 0.0
    raw = base_s * (2.0 ** (attempt - 1))
    jitter = zlib.crc32(key.encode()) / 2.0**32
    delay = min(raw * (1.0 + 0.25 * jitter), cap_mult * base_s)
    return delay if cap_s is None else min(delay, cap_s)
