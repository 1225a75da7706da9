"""Decorrelated-jitter backoff: the retry pacing for lighthouse failover.

When the active lighthouse dies, EVERY replica group in the cluster loses
it at the same instant, and plain exponential backoff keeps their retries
phase-locked: each round, N managers slam the new leader simultaneously —
the classic thundering herd.  Decorrelated jitter (sleep_{k+1} =
uniform(base, 3 * sleep_k), capped) spreads each client's next attempt
across the whole interval, so the reconnect wave arrives smeared instead
of spiked.

A copy of ``torchft_tpu/ha/backoff.py``: the same seeded ``random.Random``
gives the same delays.  The port's Manager paces its heal retries with it
(``TPUFT_HEAL_BACKOFF_BASE_S``, ``TPUFT_HEAL_BACKOFF_CAP_S``).
"""

from __future__ import annotations

import random

__all__ = ["DecorrelatedBackoff"]


class DecorrelatedBackoff:
    """sleep_{k+1} = min(cap, uniform(base, 3 * sleep_k)).

    Args:
        base_s: minimum (and first) sleep, seconds.
        cap_s: maximum sleep, seconds.
        rng: injectable ``random.Random`` for deterministic tests.
    """

    def __init__(
        self,
        base_s: float = 0.05,
        cap_s: float = 2.0,
        rng: random.Random | None = None,
    ) -> None:
        if base_s <= 0:
            raise ValueError("base_s must be > 0")
        self._base = base_s
        self._cap = max(cap_s, base_s)
        self._prev = base_s
        self._rng = rng or random.Random()

    def next(self) -> float:
        """The next sleep duration in seconds (does not sleep)."""
        sleep = self._rng.uniform(self._base, max(self._base, self._prev * 3.0))
        sleep = min(self._cap, sleep)
        self._prev = max(self._base, sleep)
        return sleep

    def reset(self) -> None:
        self._prev = self._base
