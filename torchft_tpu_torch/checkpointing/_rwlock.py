"""Timed readers-writer lock.

A copy of ``torchft_tpu/checkpointing/_rwlock.py``: a condition variable
with writer preference and timeouts.  The HTTP transport holds the write
lock while its serving window is closed; the threads serving checkpoint
requests take timed read locks.
"""

from __future__ import annotations

import threading
from typing import Optional


class RWLock:
    """A writer-preferring readers-writer lock with timeout support."""

    def __init__(self, timeout: Optional[float] = None) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._default_timeout = timeout

    # -- read side ----------------------------------------------------------

    def r_acquire(self, timeout: Optional[float] = None) -> bool:
        timeout = timeout if timeout is not None else self._default_timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._writer and self._writers_waiting == 0, timeout=timeout
            )
            if not ok:
                return False
            self._readers += 1
            return True

    def r_release(self) -> None:
        with self._cond:
            assert self._readers > 0, "r_release without matching r_acquire"
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    # -- write side ---------------------------------------------------------

    def w_acquire(self, timeout: Optional[float] = None) -> bool:
        timeout = timeout if timeout is not None else self._default_timeout
        with self._cond:
            self._writers_waiting += 1
            try:
                ok = self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0, timeout=timeout
                )
                if not ok:
                    return False
                self._writer = True
                return True
            finally:
                self._writers_waiting -= 1
                # Readers block on writers_waiting == 0; a timed-out writer
                # must wake them or they stall until their own timeout.
                self._cond.notify_all()

    def w_release(self) -> None:
        with self._cond:
            assert self._writer, "w_release without matching w_acquire"
            self._writer = False
            self._cond.notify_all()

    def w_locked(self) -> bool:
        with self._cond:
            return self._writer

    class _ReadGuard:
        def __init__(self, lock: "RWLock", timeout: Optional[float]) -> None:
            self._lock = lock
            self._timeout = timeout

        def __enter__(self) -> None:
            if not self._lock.r_acquire(self._timeout):
                raise TimeoutError("timed out acquiring read lock")

        def __exit__(self, *args: object) -> None:
            self._lock.r_release()

    def r_lock(self, timeout: Optional[float] = None) -> "RWLock._ReadGuard":
        return RWLock._ReadGuard(self, timeout)
