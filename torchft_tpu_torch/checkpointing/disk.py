"""Durable disk checkpoints: asynchronous atomic saves, cold-start resume.

The counterpart of ``torchft_tpu/checkpointing/disk.py``.  The peer
transports heal a restarted group from a live one; they cannot help when
every group is gone (host maintenance, a whole-job preemption).  Here each
group persists its state on a cadence, and a job started cold resumes from
the newest complete checkpoint instead of step 0.

- The file is the port's own frame (:func:`write_state_dict`), the one the
  HTTP transport serves: one flatten and one restore path for a heal and a
  resume.  A JAX package file is not one: its header raises
  :class:`ForeignFrameError`.
- ``save`` flattens on the caller's thread: every tensor is copied to host
  memory on the caller's current CUDA stream, so called on the train
  thread after the optimizer step it captures the updated weights.  One
  daemon worker writes the file, so training overlaps the disk.
- Atomic: ``.tmp`` + ``fsync`` + ``os.replace`` + a directory ``fsync``.  A
  crash mid-write leaves a ``.tmp`` that restore ignores and the next save
  of that step overwrites; no partial file ever has a final name.
- Retention keeps the newest ``keep`` checkpoints and deletes only after the
  newer save is durable, so once the first save lands a complete
  checkpoint is always on disk.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from torchft_tpu_torch.checkpointing.serialization import (
    ForeignFrameError,
    StateDictMeta,
    flatten_state_dict,
    read_state_dict,
    sharding_restorer,
    unflatten_state_dict,
    write_state_dict,
)

__all__ = ["DiskCheckpointer", "ManagedDiskCheckpoint"]

logger = logging.getLogger("torchft_tpu_torch.checkpointing.disk")

_CKPT_RE = re.compile(r"^step_(\d{12})\.tpuft$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:012d}.tpuft")


class DiskCheckpointer:
    """Persists one replica group's state dict to a local directory.

    Typical wiring (``examples/train_ddp.py``)::

        ckpt = DiskCheckpointer(dir, keep=3)
        step, sd = ckpt.restore_latest(template_fn=save)   # cold start
        if sd is not None: load(sd); manager.load_state_dict(...)
        ...
        if committed and step % every == 0:
            ckpt.save(step, save())                        # asynchronous

    ``save`` may be called from the train loop; writes run on one daemon
    worker.  A second ``save`` while one is writing blocks until the worker
    drains it (backpressure: checkpoints are ordered and never dropped).  A
    write failure is raised from the next ``save`` or ``wait``.
    ``last_save`` holds the last save's step, bytes, flatten (enqueue) ms,
    backpressure stall ms and, once durable, write ms.
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        if keep < 1:
            raise ValueError("must retain at least one checkpoint")
        self._dir = directory
        self._keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Condition()
        self._pending: Optional[Tuple[int, StateDictMeta, List[np.ndarray]]] = None
        self._error: Optional[BaseException] = None
        self._shutdown = False
        self.last_save: dict = {}
        self._worker = threading.Thread(target=self._run, name="tpuft_torch_disk_ckpt",
                                        daemon=True)
        self._worker.start()

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state_dict: Any) -> None:
        """Snapshots ``state_dict`` (the copies off the device happen here,
        on the caller's stream, so the caller decides what step it
        captures) and enqueues the disk write.  Returns once the write is
        enqueued, not durable: ``wait()`` for durability."""
        t0 = time.monotonic()
        meta, buffers = flatten_state_dict(state_dict, step=step)
        t1 = time.monotonic()
        with self._lock:
            self._raise_pending_error()
            while self._pending is not None and not self._shutdown:
                self._lock.wait(timeout=0.1)
            if self._shutdown:
                raise RuntimeError("DiskCheckpointer is shut down")
            # A write failure seen while blocked surfaces from this save.
            self._raise_pending_error()
            self._pending = (step, meta, buffers)
            self.last_save = {"step": step, "bytes": sum(int(b.nbytes) for b in buffers),
                              "flatten_ms": (t1 - t0) * 1e3,
                              "stall_ms": (time.monotonic() - t1) * 1e3}
            self._lock.notify_all()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Blocks until every enqueued save is durable (or raises its
        failure)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._pending is not None:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("checkpoint write still in flight")
                self._lock.wait(timeout=remaining)
            self._raise_pending_error()

    # -- restore --------------------------------------------------------------

    def steps(self) -> List[int]:
        """Completed checkpoint steps on disk, ascending."""
        out = []
        try:
            for name in os.listdir(self._dir):
                m = _CKPT_RE.match(name)
                if m:
                    out.append(int(m.group(1)))
        except FileNotFoundError:
            pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template_fn: Optional[Callable[[], Any]] = None) -> Any:
        """Loads the checkpoint at ``step``.  With ``template_fn`` (a
        zero-argument callable returning the live state dict, the callable
        the Manager is given) each restored tensor lands on its live twin's
        device (:func:`sharding_restorer`); without one, tensors stay on
        the CPU."""
        restore_fn = sharding_restorer(template_fn) if template_fn else None
        with open(_path(self._dir, step), "rb") as f:
            meta, buffers = read_state_dict(f)
        return unflatten_state_dict(meta, buffers, restore_fn)

    def restore_latest(self, template_fn: Optional[Callable[[], Any]] = None
                       ) -> Tuple[Optional[int], Any]:
        """(step, state dict) of the newest complete checkpoint, or (None,
        None) on a cold start.  A checkpoint of this package that fails to
        parse (torn by a crash of a writer that was not atomic) is skipped
        with a warning and the next newest is tried.  A frame of another
        program raises :class:`ForeignFrameError`: the JAX package skips
        it, which here would turn a directory the JAX package wrote into a
        silent cold start, and its retention would then delete each new,
        lower-numbered checkpoint right after writing it."""
        for step in reversed(self.steps()):
            try:
                return step, self.restore(step, template_fn=template_fn)
            except ForeignFrameError:
                raise
            except Exception as e:  # noqa: BLE001 - a torn file; try the next newest
                logger.warning("skipping unreadable checkpoint step %d: %s", step, e)
        return None, None

    # -- lifecycle ------------------------------------------------------------

    def shutdown(self) -> None:
        """Drains in-flight writes, then stops the worker."""
        try:
            self.wait()
        finally:
            with self._lock:
                self._shutdown = True
                self._lock.notify_all()
            self._worker.join(timeout=5.0)

    # -- worker ---------------------------------------------------------------

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"previous checkpoint write failed: {err!r}") from err

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._shutdown:
                    self._lock.wait()
                if self._shutdown and self._pending is None:
                    return
                step, meta, buffers = self._pending  # type: ignore[misc]
            t0 = time.monotonic()
            try:
                self._write(step, meta, buffers)
                self._retain()
            except Exception as e:  # noqa: BLE001 - raised from the next save or wait
                logger.error("checkpoint write for step %d failed: %s", step, e)
                with self._lock:
                    self._error = e
            finally:
                with self._lock:
                    if self.last_save.get("step") == step:
                        self.last_save["write_ms"] = (time.monotonic() - t0) * 1e3
                    self._pending = None
                    self._lock.notify_all()

    def _write(self, step: int, meta: StateDictMeta, buffers: List[np.ndarray]) -> None:
        final = _path(self._dir, step)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            write_state_dict(meta, buffers, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        # The rename itself is durable once the directory is synced.
        try:
            dfd = os.open(self._dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        logger.info("wrote checkpoint step %d (%s)", step, final)

    def _retain(self) -> None:
        for step in self.steps()[: -self._keep]:
            try:
                os.remove(_path(self._dir, step))
            except OSError:
                pass


class ManagedDiskCheckpoint:
    """The train loop's wiring of a :class:`DiskCheckpointer` to a Manager.

    The disk state wraps the state the Manager heals with (its ``save_fn``)
    and the Manager's own ``{step, batches_committed}``, which advances by
    the participants a committed step and so cannot be derived from the
    step.  Usage::

        mdc = ManagedDiskCheckpoint(manager, save, load, ckpt_dir, every=10)
        resumed = mdc.restore()          # before the first quorum
        ...
        committed = opt.step()
        mdc.maybe_save(committed)        # in the loop, on the train thread
        ...
        mdc.shutdown()                   # never raises; manager.shutdown()
                                         # after it always runs
    """

    def __init__(self, manager: Any, save_fn: Callable[[], Any],
                 load_fn: Callable[[Any], None], directory: str, *, every: int = 10,
                 keep: int = 3) -> None:
        if every < 1:
            raise ValueError("checkpoint cadence must be >= 1 step")
        self._manager = manager
        self._save_fn = save_fn
        self._load_fn = load_fn
        self._every = every
        self._ckpt = DiskCheckpointer(directory, keep=keep)

    @property
    def checkpointer(self) -> DiskCheckpointer:
        return self._ckpt

    def _disk_state(self) -> dict:
        return {"user": self._save_fn(), "manager": self._manager.state_dict()}

    def restore(self) -> Optional[int]:
        """Restores the newest complete checkpoint (tensors on their live
        twins' devices) and returns its step, or None on a cold start.  Run
        it before the first quorum, so the group asks for its quorum at the
        resumed step."""
        step, sd = self._ckpt.restore_latest(template_fn=self._disk_state)
        if sd is None:
            return None
        self._load_fn(sd["user"])
        self._manager.load_state_dict(sd["manager"])
        logger.info("resumed from disk checkpoint step=%d", step)
        return step

    def maybe_save(self, committed: bool) -> None:
        """Enqueues a checkpoint on the cadence, of committed steps only (an
        uncommitted step's state may be rolled back)."""
        step = self._manager.current_step()
        if committed and step % self._every == 0:
            self._ckpt.save(step, self._disk_state())

    def shutdown(self) -> None:
        """Drains in-flight writes.  Never raises: a deferred write failure
        at exit must not mask the loop's own outcome or skip the caller's
        remaining teardown."""
        try:
            self._ckpt.shutdown()
        except Exception as e:  # noqa: BLE001 - reported, never raised
            logger.error("disk checkpoint shutdown failed: %s", e)
