"""The chaos campaign's delta-debugging minimizer.

Port of ``_ddmin``/``ddmin`` of
``ate_replication_causalml_tpu/resilience/campaign.py`` (its lines
922-953). The campaign itself (its workloads, episodes and invariant
registry) is not ported yet; the failure-frontier search
(``scenarios/frontier.py``) shrinks failing knob vectors through this
same minimizer.
"""

from __future__ import annotations

from typing import Callable


def _ddmin(atoms: list, fails: Callable[[list], bool]) -> list:
    """Classic delta debugging over an atom list: returns a 1-minimal
    failing subset (removing any single tested chunk makes the failure
    disappear). ``fails`` must be deterministic."""
    cur = list(atoms)
    n = 2
    while len(cur) >= 2:
        chunk = max(1, len(cur) // n)
        subsets = [cur[i:i + chunk] for i in range(0, len(cur), chunk)]
        reduced = False
        for s in subsets:
            if len(s) < len(cur) and fails(s):
                cur, n, reduced = s, 2, True
                break
        if not reduced:
            for s in subsets:
                comp = [a for a in cur if a not in s]
                if comp and len(comp) < len(cur) and fails(comp):
                    cur, n, reduced = comp, max(n - 1, 2), True
                    break
        if not reduced:
            if n >= len(cur):
                break
            n = min(len(cur), n * 2)
    return cur


#: Public name: the frontier search shrinks failing knob vectors through
#: the delta-debugging core the chaos campaign shrinks fault specs with.
ddmin = _ddmin
