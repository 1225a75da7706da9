"""Future plumbing: deadlines on futures, and deadline-guarded device reads.

The counterpart of ``torchft_tpu/futures.py``.  A single timer thread arms
deadlines so that a stuck collective or RPC surfaces as a ``TimeoutError``
on the wrapped future instead of hanging the train loop.  The JAX package's
device watchdog (a materializer thread that fetches device arrays) becomes
:func:`device_get`: a copy from the card into pinned host memory, enqueued
on the current stream, that the caller waits on with a deadline by polling
a CUDA event (:func:`event_wait`, which the gradient averager's pipelined
copies wait through too).
"""

from __future__ import annotations

import concurrent.futures
import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional, TypeVar

import torch

T = TypeVar("T")


class _TimeoutManager:
    """Deadline scheduler: one daemon thread over a heap of deadlines,
    started at the first registration."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._heap: list = []
        self._counter = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._cancelled: set = set()

    def register(self, delay: float, callback: Callable[[], None]) -> int:
        with self._cond:
            handle = next(self._counter)
            heapq.heappush(self._heap, (time.monotonic() + delay, handle, callback))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="tpuft_torch_timeouts", daemon=True
                )
                self._thread.start()
            self._cond.notify()
        return handle

    def cancel(self, handle: int) -> None:
        with self._cond:
            self._cancelled.add(handle)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._heap:
                    self._cond.wait()
                deadline, handle, callback = self._heap[0]
                if handle in self._cancelled:
                    heapq.heappop(self._heap)
                    self._cancelled.discard(handle)
                    continue
                now = time.monotonic()
                if deadline > now:
                    self._cond.wait(timeout=deadline - now)
                    continue
                heapq.heappop(self._heap)
            callback()


_TIMEOUTS = _TimeoutManager()


def completed_future(value: Any = None) -> Future:
    """A future already resolved with ``value``."""
    fut: Future = Future()
    fut.set_result(value)
    return fut


def failed_future(exc: BaseException) -> Future:
    """A future already resolved to ``exc``."""
    fut: Future = Future()
    fut.set_exception(exc)
    return fut


def future_timeout(fut: Future, timeout: float) -> Future:
    """A future mirroring ``fut`` that fails with ``TimeoutError`` if ``fut``
    has not completed within ``timeout`` seconds."""
    out: Future = Future()

    def on_timeout() -> None:
        if not out.done():
            try:
                out.set_exception(TimeoutError(f"future did not complete within {timeout}s"))
            except concurrent.futures.InvalidStateError:
                pass  # completed concurrently

    handle = _TIMEOUTS.register(timeout, on_timeout)

    def on_done(f: Future) -> None:
        _TIMEOUTS.cancel(handle)
        exc = f.exception()
        try:
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(f.result())
        except concurrent.futures.InvalidStateError:
            pass  # the deadline fired first

    fut.add_done_callback(on_done)
    return out


def future_wait(fut: Future, timeout: float) -> Any:
    """Blocking wait with a deadline; raises the builtin ``TimeoutError``."""
    try:
        return fut.result(timeout=timeout)
    except concurrent.futures.TimeoutError as e:
        if isinstance(e, TimeoutError):
            raise
        raise TimeoutError(f"future did not complete within {timeout}s") from None


@contextmanager
def context_timeout(callback: Callable[[], None], timeout: float) -> Iterator[None]:
    """Runs ``callback`` (an abort, typically) if the with-block has not
    finished within ``timeout`` seconds."""
    handle = _TIMEOUTS.register(timeout, callback)
    try:
        yield
    finally:
        _TIMEOUTS.cancel(handle)


def then(fut: Future, fn: Callable[[Any], T]) -> Future:
    """Chains ``fn`` onto ``fut``: a new future with ``fn``'s result."""
    out: Future = Future()

    def on_done(f: Future) -> None:
        exc = f.exception()
        if exc is not None:
            out.set_exception(exc)
            return
        try:
            out.set_result(fn(f.result()))
        except Exception as e:  # noqa: BLE001 - delivered through the future
            out.set_exception(e)

    fut.add_done_callback(on_done)
    return out


def event_wait(event: "torch.cuda.Event", timeout: float, what: str = "device work") -> None:
    """Waits for ``event`` by polling it, raising ``TimeoutError`` after
    ``timeout`` seconds: the deadline a blocking synchronize cannot give."""
    deadline = time.monotonic() + timeout
    while not event.query():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} did not complete within {timeout}s")
        time.sleep(5e-5)


def device_get(tensor: torch.Tensor, timeout: float, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A host copy of ``tensor``, raising ``TimeoutError`` if the card has not
    produced it within ``timeout`` seconds (a wedged kernel surfaces as an
    error the Manager latches, not a hung train loop).

    For a CUDA tensor the copy goes into pinned memory (``out`` when given,
    which must match in shape and dtype), enqueued on the current stream
    behind the kernels that produce the tensor; the wait polls an event so
    the deadline holds.  A CPU tensor is returned as it is."""
    if tensor.device.type != "cuda":
        return tensor
    if out is None:
        out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    out.copy_(tensor, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    event_wait(done, timeout, "device copy")
    return out
