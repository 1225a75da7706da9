"""Fault-tolerance Manager: the per-replica-group training-loop state machine.

The counterpart of ``torchft_tpu/manager.py``, cut to what the fault-tolerant
training loop needs:

  - async quorum: each step's quorum runs on a background thread that
    overlaps the forward and backward passes;
  - reconfiguration: a new quorum id rebuilds the cross-group collective
    under a fresh store prefix;
  - healing: a group that is behind fetches the state of a group at the
    quorum's max step through the checkpoint transport (one donor), while
    up-to-date groups serve theirs; the healer then fast-forwards its step;
  - error latching: failures never raise into the train loop; they fail
    the step's commit vote;
  - commit protocol: an optimizer step lands only when every local rank of
    the group voted success.

:meth:`Manager.allreduce` takes a CUDA tensor (copied to pinned host memory
under the timeout) or a host buffer (a CPU tensor or numpy array, handed
to the collective with no copy), rings it across groups, divides by the
number of participating groups and returns the result as the input's
type, on its device.

Observability, as the JAX Manager's: with ``TPUFT_METRICS_PATH`` set, each
phase runs inside a span (``quorum`` with its minted trace id on the quorum
RPC, ``configure``, ``heal``, ``allreduce_merge``, ``commit_vote``), the
lifecycle events (``quorum``, ``reconfigure``, ``membership_change``,
``heal_start``, ``heal_fetched``, ``error``, ``commit``) go into the stream,
and a ``step_summary`` follows each vote with the step's phases, its wall
and busy time and its goodput-ledger causes.  The busy-time EWMA rides the
lighthouse heartbeats (``set_status``) and the ledger's counters fields
14-16 (``set_ledger``) whether or not a stream is written.  One difference
from the JAX package: the port's HTTP transport takes the donor's snapshot
synchronously on the quorum thread, so the train thread's wait for it is a
``snapshot_wait`` span (charged, unlike the overlapped ``snapshot``).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, cast

import numpy as np
import torch

from torchft_tpu_torch._native import ManagerClient, ManagerServer, StoreClient, StoreServer
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.collectives import Collective
from torchft_tpu_torch.futures import completed_future, device_get, future_timeout, then
from torchft_tpu_torch.metrics import MetricsLogger
from torchft_tpu_torch.obs.flight import mint_trace_id
from torchft_tpu_torch.obs.ledger import StepLedger
from torchft_tpu_torch.obs.spans import SpanTracker, StepTimeStats

MANAGER_ADDR_KEY = "manager_addr"
REPLICA_ID_KEY = "replica_id"
TPUFT_LIGHTHOUSE_ENV = "TPUFT_LIGHTHOUSE"

logger = logging.getLogger("torchft_tpu_torch.manager")


class ExceededMaxRetriesError(RuntimeError):
    """Raised by should_commit after max_retries consecutive failed commits."""


def _ms(t: timedelta) -> int:
    return int(t.total_seconds() * 1000)


def _divide(out: Any, num: int, in_place: bool) -> Any:
    """``out / num`` in ``out``'s dtype, as the JAX Manager's
    ``(out / num).astype(dtype)`` (for bf16: the f32 quotient rounded to
    nearest even, as ``ml_dtypes`` does); in place when the caller owns
    ``out``."""
    if isinstance(out, torch.Tensor):
        if out.dtype == torch.bfloat16:
            return out.div_(num) if in_place else out / num
        return torch.from_numpy(_divide(out.numpy(), num, in_place))
    if in_place and out.flags.writeable and np.issubdtype(out.dtype, np.floating):
        return np.divide(out, num, out=out)
    return (out / num).astype(out.dtype, copy=False)


class Manager:
    """Fault-tolerance manager for one local rank of one replica group.

    Args:
        collective: reconfigurable cross-group collective (data plane).
        load_state_dict: applies a state dict fetched from a peer.
        state_dict: captures the state dict to serve to peers.
        min_replica_size: minimum replica groups for a committable step.
        use_async_quorum: run the quorum concurrently with the step.
        rank/world_size: local rank / ranks per group (env RANK, WORLD_SIZE).
        store_addr/store_port: host and port of the group's rendezvous
            store, created by local rank 0 (env MASTER_ADDR / MASTER_PORT).
            An explicit ``store_addr`` is also where the store listens.
        lighthouse_addr: lighthouse address (env TPUFT_LIGHTHOUSE).
        replica_id: stable group id; a ":uuid" suffix makes a restarted
            group a new member.
        manager_bind: host:port for the native manager server.
        checkpoint_transport: moves state to recovering groups.
        init_sync: sync weights from a max-step group at step 0.
        max_retries: consecutive failed commits before should_commit raises.
    """

    def __init__(
        self,
        collective: Collective,
        load_state_dict: Optional[Callable[[Any], None]],
        state_dict: Optional[Callable[[], Any]],
        min_replica_size: int,
        use_async_quorum: bool = True,
        timeout: timedelta = timedelta(seconds=60),
        quorum_timeout: timedelta = timedelta(seconds=60),
        connect_timeout: timedelta = timedelta(seconds=10),
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        store_addr: Optional[str] = None,
        store_port: Optional[int] = None,
        lighthouse_addr: Optional[str] = None,
        replica_id: Optional[str] = None,
        manager_bind: Optional[str] = None,
        heartbeat_interval: timedelta = timedelta(milliseconds=100),
        checkpoint_transport: Optional[CheckpointTransport] = None,
        init_sync: bool = True,
        max_retries: Optional[int] = None,
    ) -> None:
        self._load_state_dict_fns: Dict[str, Callable] = {}
        self._user_state_dicts: Dict[str, Callable] = {}
        if load_state_dict is not None:
            self._load_state_dict_fns["default"] = load_state_dict
        if state_dict is not None:
            self._user_state_dicts["default"] = state_dict

        self._collective = collective
        self._min_replica_size = min_replica_size
        self._use_async_quorum = use_async_quorum
        self._timeout = timeout
        self._quorum_timeout = quorum_timeout
        self._init_sync = init_sync
        self._max_retries = max_retries
        self._commit_failures = 0
        self._checkpoint_transport = checkpoint_transport

        self._rank = rank if rank is not None else int(os.environ.get("RANK", 0))
        group_world_size = (
            world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
        )
        lighthouse_addr = lighthouse_addr or os.environ.get(TPUFT_LIGHTHOUSE_ENV, "")

        self._store_server: Optional[StoreServer] = None
        self._manager_server: Optional[ManagerServer] = None
        store_host = store_addr or os.environ.get("MASTER_ADDR", "localhost")
        port = store_port if store_port is not None else int(os.environ.get("MASTER_PORT", 0))
        if self._rank == 0:
            bind_host = store_addr if store_addr else "[::]"
            self._store_server = StoreServer(bind=f"{bind_host}:{port}")
            port = int(self._store_server.address().rsplit(":", 1)[1])
        elif port == 0:
            raise ValueError("non-zero store_port (or MASTER_PORT) required for rank > 0")
        self._store_address = f"{store_host}:{port}"
        self._store = StoreClient(self._store_address, connect_timeout_ms=_ms(connect_timeout))

        if self._rank == 0:
            if not lighthouse_addr:
                raise ValueError(f"lighthouse_addr or ${TPUFT_LIGHTHOUSE_ENV} must be set")
            base_id = replica_id or os.environ.get("REPLICA_GROUP_ID", socket.gethostname())
            full_id = f"{base_id}:{uuid.uuid4()}" if base_id else str(uuid.uuid4())
            self._manager_server = ManagerServer(
                replica_id=full_id,
                lighthouse_addr=lighthouse_addr,
                bind=manager_bind or "[::]:0",
                store_addr=self._store_address,
                world_size=group_world_size,
                heartbeat_interval_ms=_ms(heartbeat_interval),
                connect_timeout_ms=_ms(connect_timeout),
            )
            self._store.set(MANAGER_ADDR_KEY, self._manager_server.address().encode())
            self._store.set(REPLICA_ID_KEY, full_id.encode())
        addr = self._store.get(MANAGER_ADDR_KEY, wait=True, timeout_ms=_ms(connect_timeout))
        rid = self._store.get(REPLICA_ID_KEY, wait=True, timeout_ms=_ms(connect_timeout))
        if addr is None or rid is None:
            raise TimeoutError("the group's rank 0 never published its manager address")
        self._connect_timeout = connect_timeout
        self._client = ManagerClient(addr.decode(), connect_timeout_ms=_ms(connect_timeout))
        self._replica_id = rid.decode()

        self._step = 0
        self._quorum_id = -1
        self._batches_committed = 0
        self._healing = False
        self._errored: Optional[Exception] = None
        self._pending_work: List[Future] = []
        self._pending_state_dict: Optional[Dict[str, Any]] = None
        self._quorum_future: Optional[Future] = None
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuft_quorum")
        self._participating_replica_rank: Optional[int] = None
        self._participating_replica_world_size = 0
        self._last_participants: Optional[List[int]] = None

        # The metrics stream (a no-op without TPUFT_METRICS_PATH), the step
        # spans over it, the busy-time statistics and the goodput ledger.
        self._metrics = MetricsLogger.from_env(self._replica_id)
        self._spans = SpanTracker(self._metrics)
        self._step_stats = StepTimeStats()
        self._last_commit_mono: Optional[float] = None
        self._ledger = StepLedger()
        # The ledger charges a retried step's failed votes to the step that
        # finally commits: its own last-commit mark and the failed attempts'
        # phases.
        self._ledger_prev_commit_mono: Optional[float] = None
        self._ledger_pending_phases: Dict[str, float] = {}
        self._trace_id = ""
        # The step in flight's allreduce bytes and first-issue / last-settle
        # times (allreduce_gb_per_s), transfer bytes noted by the averager,
        # and fields noted for its step_summary; reset at start_quorum.
        self._ar_lock = threading.Lock()
        self._ar_bytes = 0
        self._ar_t_first: Optional[float] = None
        self._ar_t_last: Optional[float] = None
        self._ar_gbps = 0.0
        self._d2h_bytes = 0
        self._h2d_bytes = 0
        self._summary_extra: Dict[str, object] = {}
        # Per-neighbour link health from the ring's hop deltas (heartbeat
        # fields 11-13).
        self._link_prev: Optional[Dict[str, float]] = None
        self._link_ewma: Dict[str, float] = {}
        # The quorum thread's donor snapshot of the step in flight
        # (monotonic start and end), which the train thread may wait for.
        self._snapshot_window: Optional[tuple] = None
        if checkpoint_transport is not None and hasattr(checkpoint_transport,
                                                        "set_span_tracker"):
            checkpoint_transport.set_span_tracker(self._spans)

    def _log(self, level: int, msg: str) -> None:
        logger.log(level, f"[{self._replica_id}/{self._rank} - step {self._step}] {msg}")

    # -- quorum -------------------------------------------------------------

    def start_quorum(self) -> None:
        """Starts the next step's quorum (asynchronously by default).  Call
        at the top of every step."""
        if self._quorum_future is not None:
            self._quorum_future.result()
        self._errored = None
        self._healing = False
        self._pending_work = []
        self._snapshot_window = None
        with self._ar_lock:
            self._ar_bytes = 0
            self._ar_t_first = self._ar_t_last = None
            self._d2h_bytes = self._h2d_bytes = 0
            self._summary_extra = {}
        self._quorum_future = self._executor.submit(self._async_quorum)
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing:
                # Sync mode applies the fetched state at once; the step then
                # runs with good weights.
                self._apply_pending_state_dict()
                self._healing = False

    def wait_quorum(self) -> None:
        assert self._quorum_future is not None, "call start_quorum before wait_quorum"
        if self._quorum_future.done():
            self._quorum_future.result()
            return
        t_wait = time.monotonic()
        self._quorum_future.result()
        window = self._snapshot_window
        if window is not None:
            # The part of this wait that the donor's synchronous snapshot
            # took (the quorum RPC's share stays in the quorum span).
            self._snapshot_window = None
            waited_ms = max(0.0, window[1] - max(t_wait, window[0])) * 1e3
            if waited_ms > 0.0:
                self._spans.record("snapshot_wait", self._step, waited_ms)

    def _async_quorum(self) -> None:
        try:
            self._quorum_inner()
        except Exception as e:  # noqa: BLE001 - latched; the step's vote fails
            logger.exception("quorum failed: %s", e)
            self.report_error(e)
            self._participating_replica_rank = None
            self._participating_replica_world_size = 0

    def _quorum_inner(self) -> None:
        transport = self._checkpoint_transport
        self._set_status("quorum")
        # This step's causal trace id: on the quorum and commit RPCs and on
        # the span, so a report joins the client's wait with the servers'
        # flight records.
        self._trace_id = mint_trace_id(self._spans.slice_gen, self._replica_id, self._step)
        with self._spans.span("quorum", step=self._step, trace_id=self._trace_id) as sp_quorum:
            quorum = self._client._quorum(
                group_rank=self._rank,
                step=self._step,
                checkpoint_metadata=transport.metadata() if transport else "",
                shrink_only=False,
                timeout_ms=_ms(self._quorum_timeout),
                init_sync=self._init_sync,
                commit_failures=self._commit_failures,
                trace_id=self._trace_id,
            )
        # With async quorum only the up-to-date groups take part in this
        # step: a healing group's max_replica_rank is None.  With sync
        # quorum every group is healed before the step runs.
        if self._use_async_quorum:
            self._participating_replica_rank = quorum.max_replica_rank
            self._participating_replica_world_size = quorum.max_world_size
        else:
            self._participating_replica_rank = quorum.replica_rank
            self._participating_replica_world_size = quorum.replica_world_size
        self._metrics.emit(
            "quorum", step=self._step, quorum_id=quorum.quorum_id,
            replica_rank=quorum.replica_rank, replica_world_size=quorum.replica_world_size,
            participating=self._participating_replica_world_size, heal=quorum.heal,
            quorum_ms=sp_quorum.duration_ms,
        )

        if quorum.quorum_id != self._quorum_id:
            # Local rank r of every group forms one ring, under a prefix
            # unique to this quorum.
            self._log(logging.INFO, f"reconfiguring collective for quorum {quorum.quorum_id} "
                      f"(rank {quorum.replica_rank}/{quorum.replica_world_size})")
            with self._spans.span("configure", step=self._step) as sp_cfg:
                self._collective.configure(
                    f"{quorum.store_address}/tpuft/{quorum.quorum_id}/{self._rank}",
                    quorum.replica_rank, quorum.replica_world_size,
                )
            self._quorum_id = quorum.quorum_id
            lc = getattr(self._collective, "last_configure", None) or {}
            self._metrics.emit(
                "reconfigure", step=self._step, quorum_id=quorum.quorum_id,
                replica_rank=quorum.replica_rank, replica_world_size=quorum.replica_world_size,
                configure_ms=sp_cfg.duration_ms, mode=lc.get("mode", "unknown"),
                reused_lanes=lc.get("reused_lanes", 0), opened_lanes=lc.get("opened_lanes", 0),
            )
            self._on_membership_change(quorum, sp_cfg.duration_ms, lc)

        if transport is not None:
            serve_dsts = (
                list(quorum.recover_dst_replica_ranks_all)
                if transport.serves_all_donors else list(quorum.recover_dst_replica_ranks)
            )
            if serve_dsts:
                self._log(logging.INFO, f"serving checkpoint at step {quorum.max_step} "
                          f"to replicas {serve_dsts}")
                t_snap = time.monotonic()
                transport.send_checkpoint(
                    dst_ranks=serve_dsts, step=quorum.max_step,
                    state_dict=self._manager_state_dict(),
                    timeout=self._timeout.total_seconds(),
                )
                self._snapshot_window = (t_snap, time.monotonic())
            if quorum.heal:
                self._healing = True
                src_rank = cast(int, quorum.recover_src_replica_rank)
                self._set_status("heal")
                self._log(logging.INFO, f"healing from replica {src_rank} at step {quorum.max_step}")
                self._metrics.emit("heal_start", src_rank=src_rank, max_step=quorum.max_step,
                                   n_donors=1)
                with self._spans.span("heal", step=quorum.max_step,
                                      src_rank=src_rank) as sp_heal:
                    donor = ManagerClient(
                        quorum.recover_src_manager_address,
                        connect_timeout_ms=_ms(self._connect_timeout),
                    )
                    try:
                        meta = donor._checkpoint_metadata(
                            self._rank, timeout_ms=_ms(self._timeout), trace_id=self._trace_id
                        )
                    finally:
                        donor.close()
                    self._pending_state_dict = transport.recv_checkpoint(
                        src_rank=src_rank, metadata=meta, step=quorum.max_step,
                        timeout=self._timeout.total_seconds(),
                    )
                    fetched = getattr(transport, "last_fetch", None) or {}
                    sp_heal.fields.update(fetched)
                self._metrics.emit("heal_fetched", src_rank=src_rank, step=quorum.max_step,
                                   heal_ms=sp_heal.duration_ms, n_donors=1, **fetched)
                self._step = quorum.max_step
        elif quorum.heal:
            self._healing = True
        # Quorum and heal resolved: the group trains until the vote.
        self._set_status("step")

    def _on_membership_change(self, quorum: Any, configure_ms: float,
                              last_configure: Dict[str, Any]) -> None:
        """Emits ``membership_change`` (and notes it on the step's summary)
        when the quorum's participant set differs from the last one."""
        new = sorted(list(quorum.participant_replica_ranks)
                     or range(quorum.replica_world_size))
        old, self._last_participants = self._last_participants, new
        if old == new:
            return
        joined, left = sorted(set(new) - set(old or [])), sorted(set(old or []) - set(new))
        mode = last_configure.get("mode", "unknown")
        self._metrics.emit(
            "membership_change", step=self._step, quorum_id=quorum.quorum_id,
            old_participants=old, new_participants=new, joined=joined, left=left,
            transition_s=configure_ms / 1e3, mode=mode, elastic_plan=None,
        )
        self.note_summary_fields(membership_change={
            "joined": joined, "left": left, "transition_s": configure_ms / 1e3, "mode": mode,
        })

    def _manager_state_dict(self) -> Dict[str, Any]:
        return {
            "user": {k: fn() for k, fn in self._user_state_dicts.items()},
            "tpuft": self.state_dict(),
        }

    def _apply_pending_state_dict(self) -> None:
        assert self._healing, "apply_pending_state_dict called without healing"
        self.wait_quorum()
        if self._pending_state_dict is None:
            # The fetch failed and latched its error; this step's vote fails
            # and the next quorum retries the heal.
            if self._errored is None:
                self.report_error(RuntimeError("healing checkpoint was not fetched"))
            return
        self._log(logging.INFO, "applying healed state dict")
        for key, value in self._pending_state_dict["user"].items():
            if key in self._load_state_dict_fns:
                self._load_state_dict_fns[key](value)
        self.load_state_dict(self._pending_state_dict["tpuft"])
        self._pending_state_dict = None

    # -- allreduce ----------------------------------------------------------

    def allreduce(
        self,
        tensor: Any,
        should_average: bool = True,
        allow_wire_compression: bool = True,
        donate: bool = False,
    ) -> Future:
        """Fault-tolerant sum (average by default) across replica groups.

        ``tensor`` is a CUDA tensor, which is copied to pinned host memory
        under the timeout, or a host buffer (a CPU tensor, pinned or not, or
        a numpy array), which goes to the collective as it is.  The future
        resolves to the participants' sum, divided by the number of
        participating groups when ``should_average``, of the input's type,
        device and dtype.  A group that is not participating (healing)
        contributes zeros.

        ``allow_wire_compression=False`` keeps the call full width under a
        bf16 wire.  ``donate=True`` hands a host buffer to the collective:
        it may reduce (and average) in place and return the same storage;
        the caller must not read it again except through the result.

        Never raises: a failure resolves to ``tensor`` itself and latches
        the step's error (so a caller that donated tells a failure by
        identity, and must not trust the buffer's contents)."""
        if self.errored() is not None:
            return completed_future(tensor)
        self.wait_quorum()
        if self._collective.size() == 1 and self.is_participating():
            return completed_future(tensor)
        on_card = isinstance(tensor, torch.Tensor) and tensor.device.type == "cuda"
        host, owned = tensor, donate
        if on_card:
            try:
                host, owned = device_get(tensor, self._timeout.total_seconds()), True
            except TimeoutError as e:
                logger.exception("allreduce input copy: %s", e)
                self.report_error(e)
                return completed_future(tensor)
        if not self.is_participating():
            host = torch.zeros_like(host) if isinstance(host, torch.Tensor) else np.zeros_like(host)
            owned = True
        wire_nbytes = getattr(self._collective, "wire_nbytes", None)
        ar_nbytes = (int(wire_nbytes(host, allow_wire_compression)) if callable(wire_nbytes)
                     else int(host.nbytes))
        with self._ar_lock:
            if self._ar_t_first is None:
                self._ar_t_first = time.monotonic()
            self._ar_bytes += ar_nbytes
        try:
            work = self._collective.allreduce(
                [host], op="sum", allow_wire_compression=allow_wire_compression, donate=owned
            )

            def normalize(results: List[Any]) -> Any:
                out = results[0]
                if should_average:
                    out = _divide(out, max(1, self.num_participants()), in_place=owned)
                return out.to(tensor.device) if on_card else out

            return self.wrap_future(then(work.future(), normalize), default=tensor)
        except Exception as e:  # noqa: BLE001 - latched, never raised
            logger.exception("allreduce failed: %s", e)
            self.report_error(e)
            return completed_future(tensor)

    def wrap_future(self, fut: Future, default: Any) -> Future:
        """Arms a deadline and turns failure into (default, latched error)."""
        timed = future_timeout(fut, self._timeout.total_seconds())
        out: Future = Future()

        def settle(f: Future) -> None:
            # The step's last settle ends its allreduce window.
            with self._ar_lock:
                self._ar_t_last = time.monotonic()
            exc = f.exception()
            if exc is not None:
                logger.error("async work failed: %s", exc)
                self.report_error(cast(Exception, exc))
                out.set_result(default)
            else:
                out.set_result(f.result())

        timed.add_done_callback(settle)
        self._pending_work.append(out)
        return out

    def note_d2h(self, nbytes: int) -> None:
        """Adds bytes copied off the device to the step in flight
        (``d2h_bytes`` on its ``step_summary``)."""
        with self._ar_lock:
            self._d2h_bytes += int(nbytes)

    def note_h2d(self, nbytes: int) -> None:
        """Adds bytes copied back onto the device to the step in flight
        (``h2d_bytes`` on its ``step_summary``)."""
        with self._ar_lock:
            self._h2d_bytes += int(nbytes)

    def note_summary_fields(self, **fields: object) -> None:
        """Merges fields into the step in flight's ``step_summary``."""
        with self._ar_lock:
            self._summary_extra.update(fields)

    # -- errors and the commit vote ----------------------------------------

    def report_error(self, e: Exception) -> None:
        """Latches an error for this step (cleared by the next start_quorum)."""
        self._errored = e
        self._metrics.emit("error", step=self._step, error=repr(e))

    def errored(self) -> Optional[Exception]:
        return self._errored

    def should_commit(self, timeout: Optional[timedelta] = None) -> bool:
        """Two-phase commit vote across the group's local ranks.  Applies a
        healed state dict first; on success advances the step."""
        if self._quorum_future is not None:
            self.wait_quorum()
        # The merge wait: how long the vote waited on gradient traffic the
        # step did not already drain.
        with self._spans.span("allreduce_merge", step=self._step):
            for work in self._pending_work:
                work.result()  # resolves to a value: failures are already latched
            self._pending_work = []
        ar_fields, lanes = self._take_allreduce_fields()
        if self._collective.errored() is not None:
            self.report_error(cast(Exception, self._collective.errored()))
        if self._healing:
            self._apply_pending_state_dict()

        enough = self.num_participants() >= self._min_replica_size
        local = enough and self._errored is None
        vote_step = self._step
        with self._spans.span("commit_vote", step=vote_step) as sp_vote:
            committed = self._client.should_commit(
                self._rank, vote_step, local, timeout_ms=_ms(timeout or self._timeout),
                trace_id=self._trace_id,
            )
        self._log(logging.INFO, f"should_commit={committed} (local={local}, "
                  f"enough_replicas={enough}, error={self._errored})")
        self._metrics.emit(
            "commit", step=vote_step, committed=committed, local=local,
            participants=self.num_participants(),
            error=repr(self._errored) if self._errored else None, vote_ms=sp_vote.duration_ms,
        )
        step_fields = self._observe_step(vote_step, committed, lanes)
        self._spans.step_summary(vote_step, committed=committed, **step_fields, **ar_fields)
        if self._checkpoint_transport is not None:
            # The weights are about to change: stop serving the snapshot.
            self._checkpoint_transport.disallow_checkpoint()
        if committed:
            self._step += 1
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
            self._ar_gbps = ar_fields.get("allreduce_gb_per_s", 0.0)  # type: ignore[assignment]
            self._set_status("step")
        else:
            self._commit_failures += 1
            if self._max_retries is not None and self._commit_failures > self._max_retries:
                raise ExceededMaxRetriesError(
                    f"exceeded max_retries={self._max_retries} consecutive failed commits"
                )
        return committed

    def _take_allreduce_fields(self) -> tuple:
        """The step in flight's data-plane fields for its ``step_summary``
        (noted fields, transfer bytes, allreduce bytes and GB/s from the
        first issue to the last settle, the ring's lane statistics and
        link health), and the lane statistics the ledger reads; resets
        the step's accounting."""
        with self._ar_lock:
            ar_bytes, t_first, t_last = self._ar_bytes, self._ar_t_first, self._ar_t_last
            fields: Dict[str, object] = dict(self._summary_extra)
            if self._d2h_bytes or self._h2d_bytes:
                fields["d2h_bytes"] = self._d2h_bytes
                fields["h2d_bytes"] = self._h2d_bytes
            self._ar_bytes, self._ar_t_first, self._ar_t_last = 0, None, None
            self._d2h_bytes = self._h2d_bytes = 0
            self._summary_extra = {}
        lanes: Optional[dict] = None
        if ar_bytes and t_first is not None:
            if t_last is None or t_last <= t_first:
                t_last = time.monotonic()
            dur = max(1e-9, t_last - t_first)
            fields.update({"allreduce_bytes": ar_bytes, "allreduce_s": round(dur, 4),
                           "allreduce_gb_per_s": round(ar_bytes / 1e9 / dur, 4)})
            lane_stats = getattr(self._collective, "lane_stats", None)
            if callable(lane_stats):
                lanes = lane_stats()
                fields["allreduce_lanes"] = lanes
                fields.update(self._observe_link(lanes))
        return fields, lanes

    def _observe_step(self, vote_step: int, committed: bool, lanes: Optional[dict]) -> dict:
        """Step-time and ledger accounting of one vote, read from the span
        accumulation before ``step_summary`` flushes it.  A committed step's
        busy time is its commit-to-commit wall minus the FT phases spanned
        in it; a failed vote resets that clock, and its phases wait for the
        step that commits, where the ledger charges them."""
        fields: Dict[str, object] = {}
        phases = self._spans.phases_ms()
        if not committed:
            for k, v in phases.items():
                self._ledger_pending_phases[k] = self._ledger_pending_phases.get(k, 0.0) + v
            self._ledger.observe_step(vote_step, 0.0, phases, lanes=lanes, committed=False)
            self._last_commit_mono = None
            return fields
        now = time.monotonic()
        if self._last_commit_mono is not None:
            wall_ms = (now - self._last_commit_mono) * 1e3
            busy_ms = max(0.0, wall_ms - self._spans.ft_accounted_ms())
            self._step_stats.observe(busy_ms)
            snap = self._step_stats.snapshot()
            fields.update({"step_wall_ms": round(wall_ms, 3), "step_time_ms": round(busy_ms, 3),
                           "step_time_ms_ewma": snap["ewma"], "step_time_ms_p50": snap["p50"],
                           "step_time_ms_p99": snap["p99"]})
        if self._ledger_prev_commit_mono is not None:
            merged = dict(self._ledger_pending_phases)
            for k, v in phases.items():
                merged[k] = merged.get(k, 0.0) + v
            # The server's share of a long quorum wait, from this group's
            # own flight recorder; short waits are charged whole.
            server_ms = self._quorum_server_ms() if merged.get("quorum", 0.0) > 50.0 else None
            causes = self._ledger.observe_step(
                vote_step, now - self._ledger_prev_commit_mono, merged, lanes=lanes,
                committed=True, quorum_server_ms=server_ms,
            )
            if causes is not None:
                fields["ledger"] = {"causes": {k: round(v, 4) for k, v in causes.items()},
                                    "goodput_ratio": self._ledger.goodput_ratio()}
            self._push_ledger()
        self._ledger_pending_phases = {}
        self._ledger_prev_commit_mono = self._last_commit_mono = now
        return fields

    _LINK_ALPHA = 0.5

    def _observe_link(self, lanes: dict) -> Dict[str, float]:
        """Per-neighbour link health from this step's deltas of the ring's
        cumulative hop aggregates, EWMA'd (the JAX Manager's estimate:
        bytes per second of send-blocked and of receive-wait time, each
        floored at 5 ms a window, and the mean receive wait a hop); {} on
        the first window, after a counter reset, or with no traffic."""
        hops = lanes.get("hops") or {}
        cur = {
            "sent": float(sum(lanes.get("sent") or [])),
            "recv": float(sum(lanes.get("recv") or [])),
            "send_block": float(sum(h.get("send_block_s", 0.0) for h in hops.values())),
            "recv_wait": float(sum(h.get("recv_wait_s", 0.0) for h in hops.values())),
            "hops": float(sum(h.get("hops", 0) for h in hops.values())),
        }
        prev, self._link_prev = self._link_prev, cur
        if prev is None or cur["hops"] < prev["hops"]:
            return {}
        d = {k: cur[k] - prev[k] for k in cur}
        if d["hops"] <= 0 or (d["sent"] <= 0 and d["recv"] <= 0):
            return {}
        floor_s, cap = 5e-3, 1e4
        obs = {
            "recv_gbps": min(d["recv"] / 1e9 / max(d["recv_wait"], floor_s), cap),
            "send_gbps": min(d["sent"] / 1e9 / max(d["send_block"], floor_s), cap),
            "rtt_ms": d["recv_wait"] / d["hops"] * 1e3,
        }
        ew, a = self._link_ewma, self._LINK_ALPHA
        for key, value in obs.items():
            ew[key] = value if key not in ew else a * value + (1 - a) * ew[key]
        return {"link_recv_gbps": round(ew["recv_gbps"], 4),
                "link_send_gbps": round(ew["send_gbps"], 4),
                "link_hop_rtt_ms": round(ew["rtt_ms"], 3)}

    def _quorum_server_ms(self) -> Optional[float]:
        """The server-side share of this step's quorum wait: the
        ``ManagerQuorum`` RPC spans of this trace id in the group's own
        manager server's flight recorder (None on rank > 0 or without
        one)."""
        srv = self._manager_server
        if srv is None or not self._trace_id:
            return None
        total, seen = 0.0, False
        for ev in srv.flight(limit=32).get("events", []):
            if (isinstance(ev, dict) and ev.get("kind") == "rpc"
                    and ev.get("method") == "ManagerQuorum" and ev.get("trace_id") == self._trace_id):
                total += max(0.0, float(ev.get("dur_us", 0)) / 1e3)
                seen = True
        return total if seen else None

    def _push_ledger(self) -> None:
        """The ledger's cumulative counters onto heartbeat fields 14-16
        (rank 0 only: the other ranks run no server)."""
        if self._manager_server is not None:
            ratio, compute_s, lost = self._ledger.heartbeat_vector()
            self._manager_server.set_ledger(ratio, compute_s, lost)

    def _set_status(self, state: str) -> None:
        """(step, state), the busy-time EWMA and last step, the last
        committed step's allreduce GB/s and the link health onto this
        group's heartbeats (rank 0 only)."""
        if self._manager_server is None:
            return
        lk = self._link_ewma
        self._manager_server.set_status(
            self._step, state, self._step_stats.ewma_ms, self._step_stats.last_ms,
            self._ar_gbps, -1, -1, -1, lk.get("recv_gbps", -1.0), lk.get("send_gbps", -1.0),
            lk.get("rtt_ms", -1.0),
        )

    # -- state --------------------------------------------------------------

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    def collective(self) -> Collective:
        """The cross-group collective (the averager reads its wire)."""
        return self._collective

    @property
    def metrics(self) -> MetricsLogger:
        """The metrics stream, for wrappers that emit into it."""
        return self._metrics

    @property
    def spans(self) -> SpanTracker:
        """The step spans, for wrappers that block the train thread on FT
        work outside the Manager's phases (the averager's copies and waits):
        what is not spanned counts as busy time."""
        return self._spans

    @property
    def ledger(self) -> StepLedger:
        """The goodput ledger's cumulative cause totals."""
        return self._ledger

    @property
    def timeout(self) -> timedelta:
        """The deadline of every data-plane wait."""
        return self._timeout

    def current_step(self) -> int:
        return self._step

    def batches_committed(self) -> int:
        return self._batches_committed

    def num_participants(self) -> int:
        """Replica groups participating in the current step."""
        return self._participating_replica_world_size

    def participating_rank(self) -> Optional[int]:
        """This group's rank among the participants, None while healing."""
        self.wait_quorum()
        return self._participating_replica_rank

    def is_participating(self) -> bool:
        return self._participating_replica_rank is not None

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)
        self._metrics.close()
        if self._checkpoint_transport is not None:
            self._checkpoint_transport.shutdown(wait=False)
        self._client.close()
        self._store.close()
        self._collective.shutdown()
        if self._manager_server is not None:
            self._manager_server.shutdown()
        if self._store_server is not None:
            self._store_server.shutdown()
