"""Crash-isolated collective: the communicator runs in a child process.

The counterpart of ``torchft_tpu/baby.py`` (the reference's
ProcessGroupBaby): a hard wedge, a crash or a poisoned thread inside
communication code must not take down the training process.  The real
collective (the port's :class:`~torchft_tpu_torch.collectives.TCPCollective`,
so a Baby rank and a plain rank share one ring and one wire) lives in a
child process; commands travel over monitored pipes, and a reader thread
completes the parent's per-op futures as results land.  If the child dies
or wedges, the parent latches an error, every op fails within the timeout,
and the next ``configure()`` (the next quorum) spawns a fresh child.  Each
``configure`` spawns one, so the ring's incremental reconfigure never
applies under a Baby: every quorum change is a full rendezvous.

Host buffers only cross the pipe: numpy arrays, and CPU tensors (bf16
included), which travel as numpy arrays and come back as tensors.  A CUDA
tensor is refused, as ``TCPCollective.send`` refuses one; the child never
touches a device.  The crossing is one copy each way on a path bound by
the network, the price of isolation.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.forkserver
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from torchft_tpu_torch.collectives import WIRE_CODECS, Collective, TCPCollective, Work
from torchft_tpu_torch.futures import completed_future, failed_future, future_timeout

__all__ = ["MonitoredPipe", "BabyCollective", "BabyTCPCollective"]


# Arrays from this size on cross the pipe as raw bytes after their message.
_BULK_MIN_BYTES = 1 << 20


class _Bulk:
    """A large array's place in a pipe message; its bytes follow the
    message, raw."""

    __slots__ = ("dtype", "shape")

    def __init__(self, dtype: Any, shape: tuple) -> None:
        self.dtype, self.shape = dtype, shape

    def __reduce__(self) -> tuple:
        return _Bulk, (self.dtype, self.shape)


def _split(obj: Any, out: list) -> Any:
    """``obj`` with every large array replaced by a :class:`_Bulk`, the
    arrays appended to ``out`` in walk order."""
    if isinstance(obj, np.ndarray):
        if obj.nbytes < _BULK_MIN_BYTES or obj.dtype.hasobject:
            return obj
        arr = np.ascontiguousarray(obj)
        out.append(arr)
        return _Bulk(arr.dtype, arr.shape)
    if isinstance(obj, _HostTensor):
        h = _HostTensor.__new__(_HostTensor)
        h.dtype, h.array = obj.dtype, _split(obj.array, out)
        return h
    if isinstance(obj, (list, tuple)):
        return type(obj)(_split(o, out) for o in obj)
    return obj


def _join(obj: Any, read: Callable[[_Bulk], np.ndarray]) -> Any:
    """Inverse of :func:`_split`: each :class:`_Bulk`, in walk order, by
    ``read``."""
    if isinstance(obj, _Bulk):
        return read(obj)
    if isinstance(obj, _HostTensor):
        obj.array = _join(obj.array, read)
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_join(o, read) for o in obj)
    return obj


class MonitoredPipe:
    """A pipe whose ``recv(timeout)`` polls, and whose exceptions sent as
    payloads re-raise at the receiver.  An array of a MiB or more travels as
    its raw bytes after the pickled message, written from and read into
    its own buffer: a multi-hundred-MB gradient is never pickled, nor read
    back through the connection's growing buffer."""

    def __init__(self, pipe: Any) -> None:
        self._pipe = pipe
        self._send_lock = threading.Lock()

    def send(self, obj: Any) -> None:
        bulks: list = []
        msg = _split(obj, bulks)
        with self._send_lock:
            self._pipe.send(msg)
            fd = self._pipe.fileno()
            for arr in bulks:
                view = memoryview(arr.reshape(-1).view(np.uint8))
                sent = 0
                while sent < len(view):
                    sent += os.write(fd, view[sent:])

    def _read(self, bulk: _Bulk) -> np.ndarray:
        arr = np.empty(bulk.shape, bulk.dtype)
        view = memoryview(arr.reshape(-1).view(np.uint8))
        fd, got = self._pipe.fileno(), 0
        while got < len(view):
            n = os.readv(fd, [view[got:]])
            if n == 0:
                raise EOFError("pipe closed inside a message")
            got += n
        return arr

    def recv(self, timeout: Optional[float] = None) -> Any:
        if timeout is not None and not self._pipe.poll(timeout):
            raise TimeoutError(f"pipe recv timed out after {timeout}s")
        out = _join(self._pipe.recv(), self._read)
        if isinstance(out, Exception):
            raise out
        return out

    def close(self) -> None:
        # Under the send lock: a send captures the raw fd once per call, so a
        # close in the middle would free the fd number for reuse while the
        # sender writes on.  (A recv has the same hazard, so reader threads
        # close the pipes they block on: BabyCollective._teardown_child.)
        with self._send_lock:
            self._pipe.close()

    def closed(self) -> bool:
        return self._pipe.closed


def _mp_context() -> Any:
    """Children come from a forkserver where there is one: each is a fork
    of a small server process exec'd fresh (so the parent's threads and CUDA
    context are not inherited) that preloaded this module.  A child still
    replays the parent's ``__main__`` as ``__mp_main__``, so an entry point
    that builds a Baby keeps its device work under ``if __name__``."""
    try:
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(["torchft_tpu_torch.baby"])
        return ctx
    except (ValueError, AttributeError):  # a platform without forkserver
        return multiprocessing.get_context("spawn")


def _tcp_collective_factory(kwargs: dict) -> Collective:
    return TCPCollective(**kwargs)


class _HostTensor:
    """A CPU tensor on the pipe: its bytes as a numpy array and its dtype.
    Tensors are never pickled as tensors, which would move their storage
    into shared memory."""

    __slots__ = ("array", "dtype")

    def __init__(self, t: torch.Tensor) -> None:
        t = t.detach().contiguous()
        self.dtype = str(t.dtype).removeprefix("torch.")
        self.array = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()

    def __getstate__(self) -> tuple:
        return self.array, self.dtype

    def __setstate__(self, state: tuple) -> None:
        self.array, self.dtype = state

    def tensor(self) -> torch.Tensor:
        t = torch.from_numpy(self.array)
        return t.view(torch.bfloat16) if self.dtype == "bfloat16" else t


def _to_pipe(obj: Any) -> Any:
    """``obj`` with every tensor as a :class:`_HostTensor`; a tensor off
    the CPU raises ``ValueError``."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            raise ValueError(f"the baby collective takes host buffers, got a tensor on "
                             f"{obj.device}")
        return _HostTensor(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_pipe(o) for o in obj)
    return obj


def _from_pipe(obj: Any) -> Any:
    if isinstance(obj, _HostTensor):
        return obj.tensor()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_pipe(o) for o in obj)
    return obj


def _send_result(results: MonitoredPipe, op_id: int, exc: Optional[BaseException],
                 value: Any) -> None:
    try:
        results.send(("op", op_id, exc, _to_pipe(value)))
    except (OSError, ValueError):
        pass  # the parent is gone: nothing to report to
    except Exception as send_exc:  # noqa: BLE001 - an exception or value that does not pickle
        try:
            results.send(("op", op_id, RuntimeError(
                f"result not picklable ({send_exc!r}); original exc={exc!r}"), None))
        except Exception:  # noqa: BLE001
            pass


def _child_main(factory: Callable[[dict], Collective], factory_kwargs: dict, cmd_pipe: Any,
                result_pipe: Any) -> None:
    """The child's loop: it owns the real collective.  Ops are submitted to
    it and each completion is shipped back as it lands (a done callback on
    its Work), so overlapping parent ops (a ring allreduce beside point to
    point sends) stay concurrent across the process boundary."""
    inner: Collective = factory(factory_kwargs)
    cmds = MonitoredPipe(cmd_pipe)
    results = MonitoredPipe(result_pipe)
    try:
        while True:
            msg = cmds.recv()
            kind = msg[0]
            if kind == "shutdown":
                inner.shutdown()
                return
            if kind == "configure":
                _, store_addr, rank, world_size = msg
                try:
                    inner.configure(store_addr, rank, world_size)
                    results.send(("configured", None))
                except Exception as e:  # noqa: BLE001 - the parent raises it
                    results.send(("configured", e))
                continue
            if kind == "op":
                _, op_id, name, args, kwargs = msg

                def complete(fut: Future, op_id: int = op_id) -> None:
                    exc = fut.exception()
                    _send_result(results, op_id, exc, None if exc is not None else fut.result())

                try:
                    work: Work = getattr(inner, name)(*_from_pipe(args), **kwargs)
                except Exception as e:  # noqa: BLE001 - the parent's future fails with it
                    _send_result(results, op_id, e, None)
                    continue
                # The completion runs on the collective's worker thread; the
                # result pipe's sends are serialized by its lock.
                work.add_done_callback(complete)
    except (EOFError, OSError, KeyboardInterrupt):
        # The parent went away, or is tearing this child down.
        try:
            inner.shutdown()
        except Exception:  # noqa: BLE001
            pass


class BabyCollective(Collective):
    """Runs an inner collective in a child process, so that a crash or a
    hard wedge in communication code cannot take down the training
    process.

    Args:
        factory: builds the inner collective in the child from
            ``factory_kwargs`` (a module-level function: it is pickled).
        factory_kwargs: the inner collective's arguments.
        timeout: the deadline of a configure and of every op.
    """

    # Forwarded to the inner collective, which quantizes the wire.
    wire_codecs = WIRE_CODECS

    def __init__(self, factory: Callable[[dict], Collective] = _tcp_collective_factory,
                 factory_kwargs: Optional[dict] = None, timeout: float = 60.0) -> None:
        self._factory = factory
        self._factory_kwargs = factory_kwargs or {}
        self._timeout = timeout
        self._lock = threading.Lock()
        # Serializes every poll of the child: a forkserver child's exit code
        # is read once from the server's pipe, and a second thread reading
        # it at the same time finds the pipe empty and records 255 instead.
        self._proc_lock = threading.Lock()
        self._proc: Optional[Any] = None
        self._cmds: Optional[MonitoredPipe] = None
        self._results: Optional[MonitoredPipe] = None
        self._reader: Optional[threading.Thread] = None
        self._futures: Dict[int, Future] = {}
        self._next_op = 0
        self._rank = 0
        self._world_size = 1
        self._error: Optional[Exception] = None
        # The last configure's mode (every one spawns a child) and its ms.
        self.last_configure: Dict[str, Any] = {}
        # The forkserver starts now: its import of this module (and of
        # torch) overlaps the caller's start-up instead of the first
        # configure.
        if _mp_context().get_start_method() == "forkserver":
            multiprocessing.forkserver.ensure_running()

    # -- lifecycle ------------------------------------------------------------

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        t0 = time.monotonic()
        self._teardown_child()
        ctx = _mp_context()
        cmd_parent, cmd_child = ctx.Pipe()
        res_parent, res_child = ctx.Pipe()
        proc = ctx.Process(target=_child_main,
                           args=(self._factory, self._factory_kwargs, cmd_child, res_child),
                           daemon=True, name=f"tpuft_torch_baby_{rank}")
        proc.start()
        cmd_child.close()
        res_child.close()
        cmds, results = MonitoredPipe(cmd_parent), MonitoredPipe(res_parent)
        with self._lock:
            self._proc = proc
            self._cmds = cmds
            self._results = results
            self._futures = {}
            self._error = None
            self._rank = rank
            self._world_size = world_size
        t_spawn = time.monotonic()
        cmds.send(("configure", store_addr, rank, world_size))
        kind, exc = results.recv(timeout=self._timeout)
        if kind != "configured":
            raise RuntimeError(f"unexpected child response {kind!r}")
        if exc is not None:
            self._latch(exc)
            raise exc
        reader = threading.Thread(target=self._read_loop, args=(results,),
                                  name="tpuft_torch_baby_reader", daemon=True)
        reader.start()
        self._reader = reader
        t1 = time.monotonic()
        self.last_configure = {"mode": "respawn", "configure_ms": (t1 - t0) * 1e3,
                               "spawn_ms": (t_spawn - t0) * 1e3, "pid": proc.pid}

    def child_pid(self) -> Optional[int]:
        """The live child's process id (None before the first configure)."""
        with self._lock:
            return self._proc.pid if self._proc is not None else None

    def _teardown_child(self) -> None:
        with self._lock:
            proc, self._proc = self._proc, None
            cmds, self._cmds = self._cmds, None
            results, self._results = self._results, None
            reader, self._reader = self._reader, None
            futures, self._futures = self._futures, {}
        for fut in futures.values():
            if not fut.done():
                fut.set_exception(RuntimeError("collective reconfigured"))
        if cmds is not None:
            try:
                cmds.send(("shutdown",))
            except OSError:
                pass
            cmds.close()
        # The results pipe is closed by its reader thread, never here: the
        # reader may be blocked in Connection.recv(), which captures the raw
        # fd once a call; closing it under the reader would free the fd
        # number for the next configure's Pipe(), and the stale reader would
        # consume the new generation's bytes.  The reader wakes and closes
        # it itself once the child's end closes.  Only a pipe no reader ever
        # took (the configure failed first) is ours to close.
        if results is not None and reader is None:
            results.close()
        if proc is not None:
            with self._proc_lock:
                proc.join(timeout=2.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=2.0)

    def _died(self, proc: Any) -> RuntimeError:
        """The error of a child that died: it names the exit code."""
        code = None
        if proc is not None:
            with self._proc_lock:
                proc.join(timeout=1.0)
                code = proc.exitcode
        return RuntimeError(f"collective subprocess died (exit code {code})")

    def _alive(self, proc: Any) -> bool:
        with self._proc_lock:
            return proc.is_alive()

    def _read_loop(self, results: MonitoredPipe) -> None:
        """Completes the parent's futures from the child's results."""
        while True:
            try:
                msg = results.recv()
            except (EOFError, OSError):
                # The child died (its end closed): fail everything in flight,
                # unless a newer configure replaced this reader's child.
                with self._lock:
                    stale = self._results is not results
                    proc = self._proc
                err = self._died(None if stale else proc)
                with self._lock:
                    stale = self._results is not results
                    futures: Dict[int, Future] = {}
                    if not stale:
                        futures, self._futures = self._futures, {}
                        if self._error is None:
                            self._error = err
                # No recv can run on this pipe again: closing it is safe now.
                try:
                    results.close()
                except Exception:  # noqa: BLE001
                    pass
                for fut in futures.values():
                    if not fut.done():
                        fut.set_exception(err)
                return
            except Exception:  # noqa: BLE001 - a message that does not unpickle
                continue
            if msg[0] == "op":
                _, op_id, exc, value = msg
                with self._lock:
                    fut = self._futures.pop(op_id, None)
                if fut is None or fut.done():
                    continue
                if exc is not None:
                    self._latch(exc)
                    fut.set_exception(exc)
                else:
                    fut.set_result(_from_pipe(value))

    def _latch(self, exc: Exception) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc

    def errored(self) -> Optional[Exception]:
        with self._lock:
            if self._error is not None:
                return self._error
            proc = self._proc
        if proc is not None and not self._alive(proc):
            self._latch(self._died(proc))
            return self._error
        return None

    def abort(self) -> None:
        # The NCCL-abort analogue: kill the child; in-flight ops fail through
        # the reader's EOF path, and the next configure spawns a new one.
        with self._lock:
            proc = self._proc
            if self._error is None:
                self._error = RuntimeError("collective aborted")
        if proc is not None and self._alive(proc):
            proc.kill()

    def shutdown(self) -> None:
        self._teardown_child()

    # -- ops ------------------------------------------------------------------

    def _submit(self, name: str, *args: Any, **kwargs: Any) -> Work:
        try:
            args = _to_pipe(args)
        except ValueError as e:
            return Work(failed_future(e))
        with self._lock:
            if self._error is not None:
                return Work(failed_future(self._error))
            cmds, proc = self._cmds, self._proc
            if cmds is None:
                return Work(failed_future(RuntimeError("collective not configured")))
            op_id = self._next_op
            self._next_op += 1
            fut: Future = Future()
            self._futures[op_id] = fut
        try:
            cmds.send(("op", op_id, name, args, kwargs))
        except OSError as e:
            # A broken pipe: the child died before the reader saw its end.
            with self._lock:
                self._futures.pop(op_id, None)
            err = self._died(proc)
            err.__cause__ = e
            self._latch(err)
            return Work(failed_future(self.errored() or err))
        # A wedged child surfaces as a timeout, never a hang.
        return Work(future_timeout(fut, self._timeout))

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        """As ``TCPCollective.allreduce``; ``donate`` is moot (the buffers
        cross the pipe as copies), and the child's ring reduces its copy in
        place."""
        kwargs: Dict[str, Any] = {"donate": True}
        if wire_codec is not None:
            kwargs["wire_codec"] = wire_codec
        return self._submit("allreduce", list(arrays), op, allow_wire_compression, **kwargs)

    def allgather(self, array: Any) -> Work:
        return self._submit("allgather", array)

    def broadcast(self, array: Any, root: int = 0) -> Work:
        return self._submit("broadcast", array, root)

    def reduce_scatter(self, arrays: Sequence[Any], op: str = "sum") -> Work:
        return self._submit("reduce_scatter", list(arrays), op)

    def alltoall(self, arrays: Sequence[Any]) -> Work:
        return self._submit("alltoall", list(arrays))

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        return self._submit("send", array, dst, tag)

    def recv(self, shape: tuple, dtype: Any, src: int, tag: int = 0) -> Work:
        return self._submit("recv", tuple(shape), dtype, src, tag)

    def barrier(self) -> Work:
        if self._world_size == 1:
            return Work(completed_future(None))
        return self._submit("barrier")

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank


def BabyTCPCollective(timeout: float = 60.0, chunk_bytes: int = 4 << 20,
                      wire_dtype: str = "f32", **kwargs: Any) -> BabyCollective:
    """A crash-isolated :class:`TCPCollective` (the BabyNCCL analogue);
    ``kwargs`` (``lanes``, ``engine``, ``host``, ``topology``,
    ``transport``) go to the ring in the child."""
    return BabyCollective(
        factory=_tcp_collective_factory,
        factory_kwargs={"timeout": timeout, "chunk_bytes": chunk_bytes,
                        "wire_dtype": wire_dtype, **kwargs},
        timeout=timeout,
    )
