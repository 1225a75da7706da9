"""Fault-tolerance Manager: the per-replica-group training-loop state machine.

The counterpart of ``torchft_tpu/manager.py``, cut to what the fault-tolerant
training loop needs:

  - async quorum: each step's quorum runs on a background thread that
    overlaps the forward and backward passes;
  - reconfiguration: a new quorum id rebuilds the cross-group collective
    under a fresh store prefix;
  - healing: a group that is behind fetches the state of the groups at the
    quorum's max step through the checkpoint transport, striped over up to
    ``TPUFT_MAX_HEAL_DONORS`` donors (4; 0 for no cap; one for a
    point-to-point transport), while up-to-date groups serve theirs; the
    healer then fast-forwards its step.  A failed fetch latches, and the
    next quorum's retry waits a decorrelated-jitter backoff
    (``TPUFT_HEAL_BACKOFF_BASE_S``, 0.2; ``TPUFT_HEAL_BACKOFF_CAP_S``, 5);
  - erasure-coded state (``TPUFT_EC_K`` > 0, :mod:`torchft_tpu_torch.ec`):
    each committed step's state is also encoded into k + m shards on the
    transport's background snapshotter and spread over the participants, so
    a healer whose donors are gone (``TPUFT_EC_MODE=fallback``) or any
    healer (``prefer``) rebuilds the max-step state from any k holders;
  - error latching: failures never raise into the train loop; they fail
    the step's commit vote;
  - commit protocol: an optimizer step lands only when every local rank of
    the group voted success;
  - world-size modes: ``WorldSizeMode.FIXED_WITH_SPARES`` pins the number of
    participants to ``fixed_world_size`` (default ``min_replica_size``);
    a group ranked at or above it is a spare that contributes zeros;
  - cooperative drain (:mod:`torchft_tpu_torch.drain`): ``begin_drain``
    tells the lighthouse at once so the next quorum leaves this group out,
    the train loop finishes the step in flight and leaves through
    ``complete_drain``; the lighthouse's ``"is draining"`` refusal of a
    quorum begins one too;
  - the elastic batch engine (``TPUFT_ELASTIC_GLOBAL_BATCH``,
    :class:`~torchft_tpu_torch.ddp.ElasticBatchScaler`): ``elastic_plan()``
    splits a constant global batch over the participating groups, and
    every committed ``step_summary`` carries the plan it trained under;
  - membership callbacks (``register_membership_callback``): each change
    of the participant set hands every callback a copy of the
    ``membership_change`` event's payload, on the quorum thread;
  - the checkpoint transport may be given after construction
    (``set_checkpoint_transport``); with a point-to-point one
    (``serves_all_donors`` false, the collective transport) a donor serves
    only the healers the quorum assigns it and a healer fetches from its
    primary alone.

:meth:`Manager.allreduce` takes a CUDA tensor (copied to pinned host memory
under the timeout) or a host buffer (a CPU tensor or numpy array, handed
to the collective with no copy), rings it across groups, divides by the
number of participating groups and returns the result as the input's
type, on its device.

Observability, as the JAX Manager's: with ``TPUFT_METRICS_PATH`` set, each
phase runs inside a span (``quorum`` with its minted trace id on the quorum
RPC, ``configure``, ``heal``, ``allreduce_merge``, ``commit_vote``), the
lifecycle events (``quorum``, ``reconfigure``, ``membership_change``,
``heal_start``, ``heal_fetched``, ``ec_push``, ``ec_reconstruct``,
``error``, ``commit``) go into the stream (the ``ec_reconstruct`` and
overlapped ``ec_encode`` spans too),
and a ``step_summary`` follows each vote with the step's phases, its wall
and busy time and its goodput-ledger causes.  The busy-time EWMA rides the
lighthouse heartbeats (``set_status``) and the ledger's counters fields
14-16 (``set_ledger``) whether or not a stream is written.  The donor's
``send_checkpoint`` runs on the quorum thread under the train thread's CUDA
stream (captured at ``start_quorum``), so the HTTP transport's device copy
of the state is ordered before the step's optimizer update; the train
thread's wait for that call is a ``snapshot_wait`` span (charged), the
transport's background flatten the overlapped ``snapshot``.  With
``TPUFT_WORKER_METRICS_PORT`` set the Manager serves the worker
``/metrics`` endpoint (:attr:`Manager.worker_metrics`, the JAX Manager's
series), and with ``TPUFT_HOP_DUMP_DIR`` set it leaves the ring's hop
timeline there at shutdown.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import re
import socket
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, cast

import numpy as np
import torch

from torchft_tpu_torch._native import ManagerClient, ManagerServer, StoreClient, StoreServer
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.collectives import Collective
from torchft_tpu_torch.drain import DrainNotice, DrainWatcher
from torchft_tpu_torch.ec import ECConfig, ECPlane
from torchft_tpu_torch.futures import completed_future, device_get, future_timeout, then
from torchft_tpu_torch.ha.backoff import DecorrelatedBackoff
from torchft_tpu_torch.metrics import MetricsLogger
from torchft_tpu_torch.obs.flight import mint_trace_id
from torchft_tpu_torch.obs.ledger import StepLedger
from torchft_tpu_torch.obs.prom import (
    HOP_BYTES_BOUNDS,
    HOP_LATENCY_BOUNDS,
    WorkerMetrics,
    bucketize,
    render_histogram_counts,
)
from torchft_tpu_torch.obs.spans import SpanTracker, StepTimeStats

MANAGER_ADDR_KEY = "manager_addr"
REPLICA_ID_KEY = "replica_id"
TPUFT_LIGHTHOUSE_ENV = "TPUFT_LIGHTHOUSE"
# Donors one heal stripes over (0: no cap).
TPUFT_MAX_HEAL_DONORS_ENV = "TPUFT_MAX_HEAL_DONORS"
# The heal-retry backoff's first (and least) and largest sleep, seconds.
TPUFT_HEAL_BACKOFF_BASE_ENV = "TPUFT_HEAL_BACKOFF_BASE_S"
TPUFT_HEAL_BACKOFF_CAP_ENV = "TPUFT_HEAL_BACKOFF_CAP_S"

logger = logging.getLogger("torchft_tpu_torch.manager")


# The transport's last_fetch fields that ride the heal span and event.
_FETCH_FIELDS = ("bytes", "fetch_s", "mode", "n_stripes", "workers", "crc_ms", "failovers")


class WorldSizeMode(Enum):
    """How the number of participating groups follows membership: with
    ``DYNAMIC`` every up-to-date group takes part; with
    ``FIXED_WITH_SPARES`` at most ``fixed_world_size`` do and the rest are
    spares that contribute zeros."""

    DYNAMIC = 0
    FIXED_WITH_SPARES = 1


class ExceededMaxRetriesError(RuntimeError):
    """Raised by should_commit after max_retries consecutive failed commits."""


def _ms(t: timedelta) -> int:
    return int(t.total_seconds() * 1000)


def _env_float(name: str, default: float) -> float:
    """A float knob; a malformed value falls back (it must not abort
    recovery)."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        logger.warning("ignoring malformed %s", name)
        return default


def _max_heal_donors() -> int:
    try:
        return int(os.environ.get(TPUFT_MAX_HEAL_DONORS_ENV, "4"))
    except ValueError:
        return 4


def _divide(out: Any, num: int, in_place: bool) -> Any:
    """``out / num`` in ``out``'s dtype, as the JAX Manager's
    ``(out / num).astype(dtype)`` (for bf16: the f32 quotient rounded to
    nearest even, as ``ml_dtypes`` does); in place when the caller owns
    ``out``."""
    if isinstance(out, torch.Tensor):
        if out.dtype == torch.bfloat16:
            return out.div_(num) if in_place else out / num
        return torch.from_numpy(np.asarray(_divide(out.numpy(), num, in_place)))
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
        world_size_mode: ``DYNAMIC`` or ``FIXED_WITH_SPARES``.
        fixed_world_size: the participants ``FIXED_WITH_SPARES`` pins to
            (default ``min_replica_size``).
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
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        fixed_world_size: Optional[int] = None,
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
        self._world_size_mode = world_size_mode
        self._fixed_world_size = fixed_world_size

        self._rank = rank if rank is not None else int(os.environ.get("RANK", 0))
        group_world_size = (
            world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
        )
        lighthouse_addr = lighthouse_addr or os.environ.get(TPUFT_LIGHTHOUSE_ENV, "")
        # Kept for the drain notice, which dials the lighthouse with this
        # incarnation's exact id.
        self._lighthouse_addr = lighthouse_addr

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
        self._membership_callbacks: List[Callable[[Dict[str, Any]], None]] = []
        # The drain notice (set once) and the watcher that delivers it.
        self._drain_notice: Optional[DrainNotice] = None
        self._drain_watcher: Optional[DrainWatcher] = None
        self._drain_lock = threading.Lock()
        # The elastic batch engine (None: off) and the plan of the current
        # participating world, with the (participants, rank) it was made
        # for.
        from torchft_tpu_torch.ddp import ElasticBatchScaler  # ddp imports this module

        self._elastic: Optional[ElasticBatchScaler] = ElasticBatchScaler.from_env()
        self._elastic_plan: Optional[Dict[str, Any]] = None
        self._elastic_key: Optional[tuple] = None

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
        # Lifetime transfer totals (the worker endpoint's counters).
        self._d2h_bytes_total = 0
        self._h2d_bytes_total = 0
        self._summary_extra: Dict[str, object] = {}
        # Per-neighbour link health from the ring's hop deltas (heartbeat
        # fields 11-13).
        self._link_prev: Optional[Dict[str, float]] = None
        self._link_ewma: Dict[str, float] = {}
        # The quorum thread's donor snapshot of the step in flight
        # (monotonic start and end), which the train thread may wait for,
        # and the train thread's CUDA stream it is ordered on.
        self._snapshot_window: Optional[tuple] = None
        self._train_stream: Optional[Any] = None

        # The erasure-coded plane, where the transport can host shards.
        self._ec: Optional[ECPlane] = None
        ec_cfg = ECConfig.from_env()
        if ec_cfg.enabled and hasattr(checkpoint_transport, "attach_shard_store"):
            self._ec = ECPlane(ec_cfg, spans=self._spans, metrics=self._metrics,
                               resolve_peer=self._dial_peer_transport,
                               push_timeout=timeout.total_seconds())
        self._ec_enqueued_step = -1
        # Heal-retry pacing after consecutive failed fetches.
        heal_base_s = _env_float(TPUFT_HEAL_BACKOFF_BASE_ENV, 0.2)
        if heal_base_s <= 0:
            logger.warning("ignoring non-positive %s=%s; using 0.2",
                           TPUFT_HEAL_BACKOFF_BASE_ENV, heal_base_s)
            heal_base_s = 0.2
        self._heal_backoff = DecorrelatedBackoff(
            base_s=heal_base_s, cap_s=_env_float(TPUFT_HEAL_BACKOFF_CAP_ENV, 5.0))
        self._heal_failures = 0
        if checkpoint_transport is not None and hasattr(checkpoint_transport,
                                                        "set_span_tracker"):
            checkpoint_transport.set_span_tracker(self._spans)
        if self._ec is not None:
            checkpoint_transport.attach_shard_store(self._ec.store)
            checkpoint_transport.set_snapshot_hook(self._ec.on_snapshot)

        # The worker /metrics endpoint (obs/prom.py): step pace, transfer
        # totals, the ring's monotonic lane and hop counters, the link-health
        # EWMAs, the ledger, and the subsystems' sections (the semi-sync
        # plane's tpuft_semisync_*).  The provider runs at scrape time, on
        # the HTTP thread, and reads host counters only.  serve() is a no-op
        # unless TPUFT_WORKER_METRICS_PORT (or the deprecated
        # TPUFT_SEMISYNC_METRICS_PORT) is set.
        self._worker_metrics = WorkerMetrics(replica_id=self._replica_id,
                                             provider=self._worker_metrics_snapshot)
        # The hop histograms' cumulative buckets, per (tier, lane), folded at
        # scrape time from the ring's retained hop timeline.
        self._hop_hist: Dict[tuple, dict] = {}
        self._hop_hist_last_ts = 0.0
        self._hop_hist_lock = threading.Lock()
        self._worker_metrics.add_section(self._render_hop_histograms)
        self._worker_metrics.serve()

    def _dial_peer_transport(self, manager_addr: str) -> str:
        """A peer manager's checkpoint-transport URL for this local rank
        (its shard endpoints live on the same server)."""
        client = ManagerClient(manager_addr, connect_timeout_ms=_ms(self._connect_timeout))
        try:
            return client._checkpoint_metadata(self._rank, timeout_ms=_ms(self._timeout),
                                               trace_id=self._trace_id)
        finally:
            client.close()

    def _log(self, level: int, msg: str) -> None:
        logger.log(level, f"[{self._replica_id}/{self._rank} - step {self._step}] {msg}")

    @property
    def checkpoint_transport(self) -> Optional[CheckpointTransport]:
        """The transport that serves and fetches heals (its ``last_fetch``
        describes the last heal)."""
        return self._checkpoint_transport

    def set_checkpoint_transport(self, transport: CheckpointTransport) -> None:
        """Replaces the transport that serves and fetches heals.  The
        erasure-coded plane is set up by the constructor's transport only."""
        self._checkpoint_transport = transport
        if hasattr(transport, "set_span_tracker"):
            transport.set_span_tracker(self._spans)

    def register_membership_callback(self, cb: Callable[[Dict[str, Any]], None]) -> None:
        """Registers ``cb`` to run on every quorum transition that changes
        the participant set, with a copy of the ``membership_change`` event's
        payload: ``quorum_id``, ``old_participants``, ``new_participants``,
        ``joined``, ``left``, ``transition_s``, ``mode`` and ``elastic_plan``
        (None with the elastic batch engine off).  It runs on the quorum
        thread after the collective is reconfigured and before the step goes
        on, so a data loader can re-shard before the next batch is drawn.
        An exception in it is logged and swallowed: a resize hook never
        fails the step."""
        self._membership_callbacks.append(cb)

    def register_state_dict_fn(self, key: str, load: Callable[[Any], None],
                               save: Callable[[], Any]) -> None:
        """Registers a named state provider whose state travels with every
        heal, saved on the donor and loaded on the healer (the semi-sync
        wrappers register their outer state here)."""
        self._load_state_dict_fns[key] = load
        self._user_state_dicts[key] = save

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
        self._train_stream = (torch.cuda.current_stream()
                              if torch.cuda.is_available() and torch.cuda.is_initialized()
                              else None)
        with self._ar_lock:
            self._ar_bytes = 0
            self._ar_t_first = self._ar_t_last = None
            self._d2h_bytes = self._h2d_bytes = 0
            self._summary_extra = {}
        # The erasure encoder's feed: at the top of a step the state is the
        # last committed one (a failed vote left it unchanged), snapshotted
        # here on the train thread's stream as a non-serving snapshot; the
        # flatten, encode and parity pushes run on the transport's thread.
        transport = self._checkpoint_transport
        if (self._ec is not None and self._step != self._ec_enqueued_step
                and self._ec.wants_snapshot(self._step)
                and hasattr(transport, "enqueue_snapshot")):
            transport.enqueue_snapshot(self._step, self._manager_state_dict(), serve=False)
            self._ec_enqueued_step = self._step
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
            if "is draining" in str(e):
                # The lighthouse marked this incarnation draining and refuses
                # its quorums: a drain notice by another path.  "is draining"
                # is the lighthouse's refusal text (native/src/lighthouse.cc);
                # a "deadline_ms=N" in it is the grace left.
                m = re.search(r"deadline_ms=(\d+)", str(e))
                grace_s = int(m.group(1)) / 1000.0 if m else 30.0
                self._log(logging.WARNING, "lighthouse declared this replica draining; "
                          f"beginning cooperative exit (grace {grace_s:.1f}s)")
                self.begin_drain(DrainNotice(source="lighthouse", deadline=time.time() + grace_s))
            else:
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
        if self._ec is not None:
            # The shard placement's membership: every participant.
            p_ranks = list(quorum.participant_replica_ranks)
            p_addrs = list(quorum.participant_manager_addresses)
            if p_ranks and len(p_ranks) == len(p_addrs):
                self._ec.set_peers(p_ranks, p_addrs, quorum.replica_rank)
        # With async quorum only the up-to-date groups take part in this
        # step: a healing group's max_replica_rank is None.  With sync
        # quorum every group is healed before the step runs.
        if self._use_async_quorum:
            self._participating_replica_rank = quorum.max_replica_rank
            self._participating_replica_world_size = quorum.max_world_size
        else:
            self._participating_replica_rank = quorum.replica_rank
            self._participating_replica_world_size = quorum.replica_world_size
        if self._world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            # The divisor is pinned; groups ranked past it are spares.
            fixed = self._fixed_world_size or self._min_replica_size
            self._participating_replica_world_size = min(
                self._participating_replica_world_size, fixed)
            if (self._participating_replica_rank is not None
                    and self._participating_replica_rank >= fixed):
                self._participating_replica_rank = None
        self._refresh_elastic_plan(quorum)
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
            if (transport.serves_all_donors and not serve_dsts and quorum.heal
                    and quorum.max_step == self._step):
                # A group re-fetching after failed commits holds the max-step
                # state itself, and so may its peers: every group the quorum
                # names as its donors may be re-fetching from it, and none
                # is told to serve.  Serving a copy is always safe.
                serve_dsts = (list(quorum.recover_src_replica_ranks)
                              or [cast(int, quorum.recover_src_replica_rank)])
            if serve_dsts:
                self._log(logging.INFO, f"serving checkpoint at step {quorum.max_step} "
                          f"to replicas {serve_dsts}")
                t_snap = time.monotonic()
                # On the train thread's stream: a transport's device copy of
                # the state then precedes the step's in-place update.
                stream = self._train_stream
                with torch.cuda.stream(stream) if stream is not None else nullcontext():
                    transport.send_checkpoint(
                        dst_ranks=serve_dsts, step=quorum.max_step,
                        state_dict=self._manager_state_dict(),
                        timeout=self._timeout.total_seconds(),
                    )
                self._snapshot_window = (t_snap, time.monotonic())
            if quorum.heal:
                self._healing = True
                self._heal(quorum)
        elif quorum.heal:
            self._healing = True
        # Quorum and heal resolved: the group trains until the vote.
        self._set_status("step")

    def _heal(self, quorum: Any) -> None:
        """Fetches the quorum's max-step state: striped over the donors the
        quorum lists (capped; the primary alone for a point-to-point
        transport), or rebuilt from erasure shards when the donors fail
        (``fallback``) or first (``prefer``); raises when neither works."""
        transport = self._checkpoint_transport
        max_step = quorum.max_step
        src_rank = cast(int, quorum.recover_src_replica_rank)
        donor_ranks = list(quorum.recover_src_replica_ranks) or [src_rank]
        donor_addrs = [a for a in (list(quorum.recover_src_manager_addresses)
                                   or [quorum.recover_src_manager_address]) if a]
        max_donors = _max_heal_donors()
        if max_donors > 0:
            donor_ranks, donor_addrs = donor_ranks[:max_donors], donor_addrs[:max_donors]
        if not transport.serves_all_donors:
            # Only the primary sends to this group on a point-to-point transport.
            donor_ranks, donor_addrs = donor_ranks[:1], donor_addrs[:1]
        if self._heal_failures > 0:
            delay = self._heal_backoff.next()
            self._log(logging.WARNING, f"heal retry #{self._heal_failures}: backing off "
                      f"{delay:.2f}s before re-fetching")
            time.sleep(delay)
        self._set_status("heal")
        prefer_ec = self._ec is not None and self._ec.config.mode == "prefer"
        state: Optional[Dict[str, Any]] = None
        fetch_err: Optional[Exception] = None
        if not prefer_ec and donor_addrs:
            state, fetch_err = self._heal_from_donors(src_rank, max_step, donor_ranks, donor_addrs)
        elif not donor_addrs:
            fetch_err = RuntimeError("quorum response names no reachable donor")
        if state is None and self._ec is not None:
            state = self._heal_from_shards(max_step, fetch_err)
        if state is None and prefer_ec and donor_addrs:
            # prefer falls back to the donors when the shards do not cover.
            state, fetch_err = self._heal_from_donors(src_rank, max_step, donor_ranks, donor_addrs)
        if state is None:
            self._heal_failures += 1
            raise fetch_err if fetch_err is not None else RuntimeError(
                "heal failed with no donors and no shard coverage")
        self._heal_failures = 0
        self._heal_backoff.reset()
        self._pending_state_dict = state
        self._step = max_step

    def _heal_from_donors(self, src_rank: int, max_step: int, donor_ranks: List[int],
                          donor_addrs: List[str]) -> tuple:
        """(state, None) from a striped donor fetch, or (None, error)."""
        transport = self._checkpoint_transport
        assert transport is not None
        # "healing from replica" is a grep contract of the kill drives.
        self._log(logging.INFO, f"healing from replica {src_rank} at step {max_step} via "
                  f"{len(donor_addrs)} donor(s) {list(zip(donor_ranks, donor_addrs))}")
        self._metrics.emit("heal_start", src_rank=src_rank, max_step=max_step,
                           n_donors=len(donor_addrs))
        try:
            with self._spans.span("heal", step=max_step, src_rank=src_rank) as sp_heal:
                metas, used = self._resolve_donor_metadatas(donor_ranks, donor_addrs)
                state = transport.recv_checkpoint(
                    src_rank=used[0], metadata=metas if len(metas) > 1 else metas[0],
                    step=max_step, timeout=self._timeout.total_seconds(),
                )
                fetched = {k: v for k, v in (getattr(transport, "last_fetch", None) or {}).items()
                           if k in _FETCH_FIELDS}
                sp_heal.fields.update(fetched)
            fetched["n_donors"] = len(metas)
            self._metrics.emit("heal_fetched", src_rank=used[0], step=max_step,
                               heal_ms=sp_heal.duration_ms, **fetched)
            return state, None
        except Exception as e:  # noqa: BLE001 - the shards may still heal this round
            self._log(logging.WARNING, f"donor heal fetch failed: {e}")
            return None, e

    def _heal_from_shards(self, max_step: int, fetch_err: Optional[Exception]
                          ) -> Optional[Dict[str, Any]]:
        """The max-step state from any k shard holders, built as a donor
        fetch builds it (bitwise the same); None when the shards never
        covered k (the caller latches the donor error)."""
        assert self._ec is not None
        if max_step <= 0:
            # No generation of step 0 exists (the groups' initial states
            # differ until the first sync).
            return None
        if fetch_err is not None:
            self._log(logging.WARNING, f"donor path exhausted ({fetch_err}); reconstructing "
                      f"step {max_step} from erasure shards")
        transport = self._checkpoint_transport
        try:
            with self._spans.span("ec_reconstruct", step=max_step) as sp:
                meta, buffers, stats = self._ec.reconstruct_state(
                    max_step, timeout=self._timeout.total_seconds())
                state = transport.materialize(meta, buffers)
            self._metrics.emit(
                "ec_reconstruct", step=max_step, reconstruct_ms=sp.duration_ms,
                **{k: v for k, v in stats.items()
                   if k in ("holders", "probes", "corrupt", "fetch_errors", "shards_used",
                            "parity_used")},
            )
            self._log(logging.INFO, f"reconstructed step {max_step} from erasure shards "
                      f"{stats.get('shards_used')} ({stats['holders']} holders, "
                      f"{stats.get('parity_used', 0)} parity)")
            return state
        except Exception as e:  # noqa: BLE001 - latched by the caller
            self._log(logging.WARNING, f"erasure reconstruction failed: {e}")
            return None

    def _resolve_donor_metadatas(self, donor_ranks: List[int], donor_addrs: List[str]
                                 ) -> tuple:
        """Each donor's transport URL, dialled in parallel (one hung donor
        costs one timeout); an unreachable donor is left out.  Raises when
        none answers."""
        pairs = list(zip(donor_ranks, donor_addrs))

        def dial(pair: tuple) -> tuple:
            try:
                return self._dial_peer_transport(pair[1]), None
            except Exception as e:  # noqa: BLE001 - reported per donor
                return None, e

        if len(pairs) == 1:
            outcomes = [dial(pairs[0])]
        else:
            with ThreadPoolExecutor(max_workers=len(pairs),
                                    thread_name_prefix="tpuft_donor_dial") as pool:
                outcomes = list(pool.map(dial, pairs))
        metas: List[str] = []
        used: List[int] = []
        last_err: Optional[Exception] = None
        for (rank_i, addr_i), (meta, err) in zip(pairs, outcomes):
            if err is None:
                metas.append(meta)
                used.append(rank_i)
            else:
                last_err = err
                self._log(logging.WARNING, f"donor {rank_i} ({addr_i}) unreachable: {err}")
        if not metas:
            raise RuntimeError(f"no heal donor reachable (tried {len(pairs)}): {last_err}")
        return metas, used

    def _on_membership_change(self, quorum: Any, configure_ms: float,
                              last_configure: Dict[str, Any]) -> None:
        """Emits ``membership_change`` (and notes it on the step's summary)
        and runs the membership callbacks when the quorum's participant set
        differs from the last one; a new quorum id alone does neither."""
        new = sorted(list(quorum.participant_replica_ranks)
                     or range(quorum.replica_world_size))
        old, self._last_participants = self._last_participants, new
        if old == new:
            return
        if self._ec is not None:
            # Re-place the newest shard generation under the new membership
            # now, not at the next encode.
            try:
                self._ec.reshard()
            except Exception as e:  # noqa: BLE001 - best effort
                self._log(logging.WARNING, f"ec reshard failed: {e}")
        payload: Dict[str, Any] = {
            "quorum_id": quorum.quorum_id,
            "old_participants": old,
            "new_participants": new,
            "joined": sorted(set(new) - set(old or [])),
            "left": sorted(set(old or []) - set(new)),
            "transition_s": configure_ms / 1e3,
            "mode": last_configure.get("mode", "unknown"),
            "elastic_plan": self._elastic_plan,
        }
        self._metrics.emit("membership_change", step=self._step, **payload)
        self.note_summary_fields(membership_change={
            k: payload[k] for k in ("joined", "left", "transition_s", "mode")})
        for cb in self._membership_callbacks:
            try:
                cb(copy.deepcopy(payload))
            except Exception as e:  # noqa: BLE001 - a resize hook never fails the step
                self._log(logging.WARNING, f"membership callback failed: {e}")

    def _refresh_elastic_plan(self, quorum: Any) -> None:
        """Plans the constant global batch over the participating world
        (a healing group takes no share: it contributes zeros) whenever that
        world or this group's rank in it changed.  The JAX Manager plans
        only when the quorum id changes, so after an asynchronous heal it
        keeps the heal step's participant count."""
        if self._elastic is None:
            return
        participants = self._participating_replica_world_size or len(
            list(quorum.participant_replica_ranks) or range(quorum.replica_world_size))
        key = (participants, self._participating_replica_rank)
        if key != self._elastic_key:
            self._elastic_plan = self._elastic.plan(participants,
                                                    rank=self._participating_replica_rank)
            self._elastic_key = key

    def elastic_plan(self) -> Optional[Dict[str, Any]]:
        """The elastic batch plan of the current participating world (keys
        ``participants``, ``global_batch``, ``group_batch`` (this group's
        share), ``microbatch``, ``accum_steps``, ``lr_scale``), or None when
        the engine is off (``TPUFT_ELASTIC_GLOBAL_BATCH`` unset) or no
        quorum has formed.  Read it after ``wait_quorum``."""
        return self._elastic_plan

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
        wire_codec: Optional[str] = None,
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
        bf16 wire.  ``wire_codec`` (``"int8"`` or ``"int4"``, the
        collective's ``wire_codecs``) quantizes every hop with a per-chunk
        scale: the semisync pseudogradients' wire; it is passed on only
        when set.  ``donate=True`` hands a host buffer to the collective:
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
        codec_arg = {} if wire_codec is None else {"wire_codec": wire_codec}
        ar_nbytes = (int(wire_nbytes(host, allow_wire_compression, **codec_arg))
                     if callable(wire_nbytes) else int(host.nbytes))
        with self._ar_lock:
            if self._ar_t_first is None:
                self._ar_t_first = time.monotonic()
            self._ar_bytes += ar_nbytes
        try:
            work = self._collective.allreduce(
                [host], op="sum", allow_wire_compression=allow_wire_compression, donate=owned,
                **codec_arg,
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
            self._d2h_bytes_total += int(nbytes)

    def note_h2d(self, nbytes: int) -> None:
        """Adds bytes copied back onto the device to the step in flight
        (``h2d_bytes`` on its ``step_summary``)."""
        with self._ar_lock:
            self._h2d_bytes += int(nbytes)
            self._h2d_bytes_total += int(nbytes)

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
        if committed and self._checkpoint_transport is not None:
            # The weights are about to change: close the serving window.  A
            # failed vote leaves the state, and so the served copy, as it
            # is: a healer still fetching (or failing a stripe over to this
            # group after another donor died) goes on.
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
        plan = self._elastic_plan
        if plan is not None:
            # Every committed step's record carries the plan it trained
            # under: the global batch must not move across churn.
            for key in ("global_batch", "group_batch", "accum_steps", "participants"):
                fields.setdefault(f"elastic_{key}", plan[key])
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
                committed=True, draining=self.drain_requested(), quorum_server_ms=server_ms,
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
        ec_held, ec_step, ec_k = -1, -1, -1
        if self._ec is not None:
            # The shard coverage: shards held at the newest step held (an
            # empty store reports 0 at step 0), and k.
            step, count = self._ec.coverage()
            ec_held, ec_step, ec_k = count, max(0, step), self._ec.config.k
        lk = self._link_ewma
        self._manager_server.set_status(
            self._step, state, self._step_stats.ewma_ms, self._step_stats.last_ms,
            self._ar_gbps, ec_held, ec_step, ec_k, lk.get("recv_gbps", -1.0),
            lk.get("send_gbps", -1.0), lk.get("rtt_ms", -1.0),
        )

    # -- cooperative drain ---------------------------------------------------

    def attach_drain_watcher(self, watcher: Optional[DrainWatcher] = None) -> DrainWatcher:
        """Wires a :class:`~torchft_tpu_torch.drain.DrainWatcher` (by
        default one from the environment: SIGTERM, the
        ``TPUFT_DRAIN_DIR`` notice file, the opt-in GCE poll) to
        :meth:`begin_drain` and starts it; :meth:`shutdown` stops it."""
        if watcher is None:
            watcher = DrainWatcher(on_notice=self.begin_drain)
        else:
            watcher._on_notice = self.begin_drain
        self._drain_watcher = watcher
        watcher.start()
        return watcher

    def begin_drain(self, notice: Optional[DrainNotice] = None) -> None:
        """Takes a drain notice: records it for the train loop and tells the
        lighthouse at once (wire method 5, on its own thread, retried with
        a decorrelated backoff until shortly before the deadline), so the
        next quorum leaves this group out while its step in flight
        finishes.  Idempotent; callable from any thread."""
        if notice is None:
            notice = DrainNotice(source="manual", deadline=time.time() + 30.0)
        with self._drain_lock:
            if self._drain_notice is not None:
                return
            self._drain_notice = notice
        self._log(logging.WARNING, f"drain notice ({notice.source}): finishing in-flight "
                  f"step, deadline in {notice.remaining_s():.1f}s")
        self._metrics.emit("drain_notice", step=self._step, source=notice.source,
                           deadline_ms=notice.deadline_ms_from_now())
        self._set_status("draining")
        if self._rank == 0 and self._lighthouse_addr:
            threading.Thread(target=self._notify_lighthouse_drain, args=(notice,),
                             name="tpuft_drain_notify", daemon=True).start()

    def _notify_lighthouse_drain(self, notice: DrainNotice) -> None:
        """The drain notice over the wire; a notice that cannot be delivered
        by the deadline (less 2 s, within 2-10 s) degrades to the crash
        path (the heartbeat timeout), never to a failed step."""
        from torchft_tpu_torch._native import LighthouseClient

        deadline = time.monotonic() + min(10.0, max(2.0, notice.remaining_s() - 2.0))
        backoff = DecorrelatedBackoff(base_s=0.1, cap_s=1.5)
        last_err: Optional[Exception] = None
        # One client for every attempt: a failed attempt leaves it rotated
        # past the address that failed, so under an HA address list the
        # next attempt dials the next replica.  (A client made afresh each
        # attempt dialled the dead leader first every time, and its 2 s
        # connect budget, the attempt's whole timeout, left the others
        # untried whenever the refused connect's retries ran past it.)
        client = LighthouseClient(self._lighthouse_addr, connect_timeout_ms=2000)
        try:
            while time.monotonic() < deadline:
                try:
                    client.drain(self._replica_id, deadline_ms=notice.deadline_ms_from_now(),
                                 timeout_ms=2000, trace_id=self._trace_id)
                    return
                except Exception as e:  # noqa: BLE001 - retried, then logged
                    last_err = e
                    sleep_s = backoff.next()
                    if time.monotonic() + sleep_s >= deadline:
                        break
                    time.sleep(sleep_s)
        finally:
            client.close()
        self._log(logging.WARNING, f"lighthouse drain notice failed: {last_err}")

    def drain_requested(self) -> bool:
        """True once a drain notice arrived: the train loop finishes the
        current step, then leaves through :meth:`complete_drain`."""
        return self._drain_notice is not None

    def drain_notice(self) -> Optional[DrainNotice]:
        return self._drain_notice

    def complete_drain(self) -> None:
        """Marks the departure done (after the last committed step, before
        :meth:`shutdown`); the transport serves until shutdown, so a heal
        already assigned to this donor can finish."""
        notice = self._drain_notice
        self._metrics.emit("drain_complete", step=self._step,
                           batches_committed=self._batches_committed,
                           source=notice.source if notice is not None else None)
        self._log(logging.INFO, f"drain complete at step {self._step}; exiting cleanly")

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

    # -- the worker /metrics endpoint -------------------------------------------

    @property
    def worker_metrics(self) -> WorkerMetrics:
        """The worker ``/metrics`` endpoint; subsystems with an exposition
        of their own (the semi-sync engine) add a section here instead of
        opening a second port."""
        return self._worker_metrics

    def _worker_metrics_snapshot(self) -> list:
        """The endpoint's series, read at scrape time (the JAX Manager's
        names, kinds, labels and help strings)."""
        series: list = []

        def g(name, help_, value, kind="gauge", labels=()):
            series.append((name, kind, help_, labels, value))

        g("tpuft_worker_step", "current training step", self._step)
        g("tpuft_worker_step_time_ms_ewma", "rolling per-step busy-time EWMA, ms",
          self._step_stats.snapshot()["ewma"])
        with self._ar_lock:
            d2h, h2d = self._d2h_bytes_total, self._h2d_bytes_total
        g("tpuft_worker_d2h_bytes_total", "device->host fetch bytes (lifetime)", d2h,
          kind="counter")
        g("tpuft_worker_h2d_bytes_total", "host->device scatter-back bytes (lifetime)", h2d,
          kind="counter")
        lane_totals = getattr(self._collective, "lane_totals", None)
        lt = None
        if callable(lane_totals):
            try:
                lt = lane_totals()
            except Exception:  # noqa: BLE001 - telemetry only
                lt = None
        if lt:
            g("tpuft_worker_reconfigures_total", "collective reconfigurations banked",
              lt["reconfigures"], kind="counter")
            # Metric-major, so each family renders contiguous.
            tiers = sorted((lt.get("tiers") or {}).items())
            for tname, t in tiers:
                g("tpuft_worker_lane_sent_bytes_total",
                  "ring wire bytes sent per tier (monotonic across reconfigures — banked at "
                  "the source)", t["sent_bytes"], kind="counter", labels=(("tier", tname),))
            for tname, t in tiers:
                g("tpuft_worker_lane_recv_bytes_total",
                  "ring wire bytes received per tier (monotonic)", t["recv_bytes"],
                  kind="counter", labels=(("tier", tname),))
            hop_tiers = sorted((lt.get("hops") or {}).items())
            for tname, h in hop_tiers:
                g("tpuft_worker_hops_total", "ring hops per tier (monotonic)", h["hops"],
                  kind="counter", labels=(("tier", tname),))
            for key, metric in (("send_block_s", "tpuft_worker_hop_send_block_seconds_total"),
                                ("recv_wait_s", "tpuft_worker_hop_recv_wait_seconds_total"),
                                ("combine_s", "tpuft_worker_hop_combine_seconds_total"),
                                ("shape_s", "tpuft_worker_hop_shaping_seconds_total")):
                for tname, h in hop_tiers:
                    g(metric, "per-hop stall seconds per tier (monotonic)",
                      round(float(h.get(key, 0.0)), 6), kind="counter",
                      labels=(("tier", tname),))
        ew = self._link_ewma
        if ew:
            g("tpuft_link_recv_gbps", "inbound ring-edge goodput EWMA (worker-side view)",
              round(ew.get("recv_gbps", 0.0), 4))
            g("tpuft_link_send_gbps", "outbound ring-edge goodput EWMA (worker-side view)",
              round(ew.get("send_gbps", 0.0), 4))
            g("tpuft_link_hop_rtt_ms", "mean per-hop recv-wait, ms",
              round(ew.get("rtt_ms", 0.0), 3))
        led = self._ledger.snapshot()
        if led["steps"]:
            g("tpuft_worker_goodput_ratio",
              "cumulative productive fraction of accounted step wall",
              led["goodput_ratio"] if led["goodput_ratio"] is not None else -1.0)
            g("tpuft_worker_compute_seconds_total",
              "productive seconds accounted by the goodput ledger", led["compute_s"],
              kind="counter")
            for cause, v in sorted(led["lost_s"].items()):
                g("tpuft_worker_lost_seconds_total",
                  "lost seconds per ledger cause (pinned taxonomy, obs/ledger.py CAUSES)",
                  v, kind="counter", labels=(("cause", cause),))
        return series

    def _render_hop_histograms(self) -> str:
        """The endpoint's hop latency and wire-byte histograms per ring
        tier (and bytes per lane), folded from the ring's retained hop
        timeline.  Monotonic across scrapes over that sliding ring: each
        scrape folds only the records newer than the last scrape's
        high-water timestamp into cumulative buckets (records that fall off
        the ring between scrapes are missed, never subtracted)."""
        hop_records = getattr(self._collective, "hop_records", None)
        if not callable(hop_records):
            return ""
        try:
            recs = hop_records()
        except Exception:  # noqa: BLE001 - telemetry only
            return ""
        with self._hop_hist_lock:
            last_ts = self._hop_hist_last_ts
            for r in recs:
                ts = float(r.get("ts", 0.0))
                if ts <= last_ts:
                    continue
                # A record without a lane field folds into lane 0.
                slot = self._hop_hist.setdefault(
                    (int(r.get("tier", 0)), int(r.get("lane", 0))),
                    {"lat": [0] * (len(HOP_LATENCY_BOUNDS) + 1), "lat_sum": 0.0,
                     "bytes": [0] * (len(HOP_BYTES_BOUNDS) + 1), "bytes_sum": 0.0})
                lat = (float(r.get("send_s", 0.0)) + float(r.get("recv_s", 0.0))
                       + float(r.get("comb_s", 0.0)))
                _, dsum = bucketize(HOP_LATENCY_BOUNDS, (lat,), slot["lat"])
                slot["lat_sum"] += dsum
                _, dsum = bucketize(HOP_BYTES_BOUNDS, (float(r.get("nbytes", 0)),),
                                    slot["bytes"])
                slot["bytes_sum"] += dsum
                self._hop_hist_last_ts = max(self._hop_hist_last_ts, ts)
            if not self._hop_hist:
                return ""
            # The tier families sum their lanes (sums of monotonic buckets
            # stay monotonic); the lane family has one series a slot.
            lat_series, byte_series, lane_byte_series = [], [], []
            for tier in sorted({t for t, _ in self._hop_hist}):
                labels = (("replica", self._replica_id), ("tier", str(tier)))
                lat = [0] * (len(HOP_LATENCY_BOUNDS) + 1)
                byts = [0] * (len(HOP_BYTES_BOUNDS) + 1)
                lat_sum = bytes_sum = 0.0
                for (t, _lane), slot in self._hop_hist.items():
                    if t != tier:
                        continue
                    lat = [a + b for a, b in zip(lat, slot["lat"])]
                    lat_sum += slot["lat_sum"]
                    byts = [a + b for a, b in zip(byts, slot["bytes"])]
                    bytes_sum += slot["bytes_sum"]
                lat_series.append((labels, lat, lat_sum))
                byte_series.append((labels, byts, bytes_sum))
            for tier, lane in sorted(self._hop_hist):
                slot = self._hop_hist[(tier, lane)]
                lane_byte_series.append(((("replica", self._replica_id), ("tier", str(tier)),
                                          ("lane", str(lane))),
                                         list(slot["bytes"]), slot["bytes_sum"]))
        out = render_histogram_counts(
            "tpuft_worker_hop_latency_seconds",
            "per-hop wall time (send-block + recv-wait + combine) from the retained hop "
            "timeline, per ring tier (sampled per TPUFT_HOP_SAMPLE; monotonic across scrapes)",
            HOP_LATENCY_BOUNDS, lat_series)
        out += render_histogram_counts(
            "tpuft_worker_hop_wire_bytes",
            "per-hop wire payload bytes from the retained hop timeline, per ring tier "
            "(monotonic across scrapes)",
            HOP_BYTES_BOUNDS, byte_series)
        out += render_histogram_counts(
            "tpuft_hop_bytes",
            "per-hop wire payload bytes split per ring tier AND lane, from the retained hop "
            "timeline (monotonic across scrapes) — the lane split exposes striped-ring byte "
            "skew the per-tier histogram averages away",
            HOP_BYTES_BOUNDS, lane_byte_series)
        return out

    def _dump_hops(self) -> None:
        """Writes the ring's retained hop timeline to
        ``$TPUFT_HOP_DUMP_DIR/hops_<replica_id>.json`` (best effort: the dump
        never fails shutdown).  The records carry wall-clock ``ts``, so the
        trace export and the incident bundles align them with the stream."""
        dump_dir = os.environ.get("TPUFT_HOP_DUMP_DIR", "")
        hop_records = getattr(self._collective, "hop_records", None)
        if not dump_dir or not callable(hop_records):
            return
        try:
            records = hop_records()
            path = os.path.join(
                dump_dir, f"hops_{self._replica_id.replace('/', '_').replace(':', '_')}.json")
            with open(path, "w") as f:
                json.dump({"replica_id": self._replica_id, "records": records}, f)
        except Exception:  # noqa: BLE001 - see the docstring
            pass

    @property
    def timeout(self) -> timedelta:
        """The deadline of every data-plane wait."""
        return self._timeout

    def current_step(self) -> int:
        return self._step

    def replica_id(self) -> str:
        """This group's replica id (with its per-incarnation suffix)."""
        return self._replica_id

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

    def is_healing(self) -> bool:
        """Whether this step heals: ``should_commit`` installs the state
        fetched at the quorum before it votes.  A group that re-fetches after
        failed commits heals while it participates; a synchronous quorum has
        installed the state in ``start_quorum`` already.  Waits for the
        quorum."""
        self.wait_quorum()
        return self._healing

    def shutdown(self) -> None:
        if self._drain_watcher is not None:
            self._drain_watcher.stop()
            self._drain_watcher = None
        self._dump_hops()
        self._worker_metrics.close()
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
