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
"""

from __future__ import annotations

import logging
import os
import socket
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
        self._quorum_future.result()

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
        quorum = self._client._quorum(
            group_rank=self._rank,
            step=self._step,
            checkpoint_metadata=transport.metadata() if transport else "",
            shrink_only=False,
            timeout_ms=_ms(self._quorum_timeout),
            init_sync=self._init_sync,
            commit_failures=self._commit_failures,
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

        if quorum.quorum_id != self._quorum_id:
            # Local rank r of every group forms one ring, under a prefix
            # unique to this quorum.
            self._log(logging.INFO, f"reconfiguring collective for quorum {quorum.quorum_id} "
                      f"(rank {quorum.replica_rank}/{quorum.replica_world_size})")
            self._collective.configure(
                f"{quorum.store_address}/tpuft/{quorum.quorum_id}/{self._rank}",
                quorum.replica_rank, quorum.replica_world_size,
            )
            self._quorum_id = quorum.quorum_id

        if transport is not None:
            serve_dsts = (
                list(quorum.recover_dst_replica_ranks_all)
                if transport.serves_all_donors else list(quorum.recover_dst_replica_ranks)
            )
            if serve_dsts:
                self._log(logging.INFO, f"serving checkpoint at step {quorum.max_step} "
                          f"to replicas {serve_dsts}")
                transport.send_checkpoint(
                    dst_ranks=serve_dsts, step=quorum.max_step,
                    state_dict=self._manager_state_dict(),
                    timeout=self._timeout.total_seconds(),
                )
            if quorum.heal:
                self._healing = True
                src_rank = cast(int, quorum.recover_src_replica_rank)
                self._log(logging.INFO, f"healing from replica {src_rank} at step {quorum.max_step}")
                donor = ManagerClient(
                    quorum.recover_src_manager_address,
                    connect_timeout_ms=_ms(self._connect_timeout),
                )
                try:
                    meta = donor._checkpoint_metadata(
                        self._rank, timeout_ms=_ms(self._timeout)
                    )
                finally:
                    donor.close()
                self._pending_state_dict = transport.recv_checkpoint(
                    src_rank=src_rank, metadata=meta, step=quorum.max_step,
                    timeout=self._timeout.total_seconds(),
                )
                self._step = quorum.max_step
        elif quorum.heal:
            self._healing = True

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

    # -- errors and the commit vote ----------------------------------------

    def report_error(self, e: Exception) -> None:
        """Latches an error for this step (cleared by the next start_quorum)."""
        self._errored = e

    def errored(self) -> Optional[Exception]:
        return self._errored

    def should_commit(self, timeout: Optional[timedelta] = None) -> bool:
        """Two-phase commit vote across the group's local ranks.  Applies a
        healed state dict first; on success advances the step."""
        if self._quorum_future is not None:
            self.wait_quorum()
        for work in self._pending_work:
            work.result()  # resolves to a value: failures are already latched
        self._pending_work = []
        if self._collective.errored() is not None:
            self.report_error(cast(Exception, self._collective.errored()))
        if self._healing:
            self._apply_pending_state_dict()

        enough = self.num_participants() >= self._min_replica_size
        local = enough and self._errored is None
        committed = self._client.should_commit(
            self._rank, self._step, local, timeout_ms=_ms(timeout or self._timeout)
        )
        self._log(logging.INFO, f"should_commit={committed} (local={local}, "
                  f"enough_replicas={enough}, error={self._errored})")
        if self._checkpoint_transport is not None:
            # The weights are about to change: stop serving the snapshot.
            self._checkpoint_transport.disallow_checkpoint()
        if committed:
            self._step += 1
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
        else:
            self._commit_failures += 1
            if self._max_retries is not None and self._commit_failures > self._max_retries:
                raise ExceededMaxRetriesError(
                    f"exceeded max_retries={self._max_retries} consecutive failed commits"
                )
        return committed

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
        if self._checkpoint_transport is not None:
            self._checkpoint_transport.shutdown(wait=False)
        self._client.close()
        self._store.close()
        self._collective.shutdown()
        if self._manager_server is not None:
            self._manager_server.shutdown()
        if self._store_server is not None:
            self._store_server.shutdown()
