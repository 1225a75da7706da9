"""ctypes bindings to the native coordination core (``libtpuft.so``).

The C ABI (``native/src/capi.cc``) and the wire (``proto/tpuft.proto``) are
framework-neutral and shared with the JAX package; this module is the
port's own binding layer over them, so a torch replica group and a JAX
replica group speak to the same lighthouse and to each other's managers.
Requests and responses cross the ABI as proto3 bytes built by
:mod:`torchft_tpu_torch._wire`.  ctypes releases the interpreter lock for
every native call.

The library is built (``_build.native_lib_path``) and loaded at first use,
not at import.  The port binds what the fault-tolerant training loop
needs: the lighthouse server (with its evict and drain, and its HA role,
replication snapshot and federation calls), the failover lighthouse
client over an address list (quorum, heartbeat, status, leader, replicate,
evict, drain), the manager server and client (quorum, checkpoint metadata, commit
vote, heartbeat telemetry and goodput ledger), the servers' flight
recorders, the rendezvous store, and the GIL-free ring data plane
(:class:`RingEngine`, ``native/src/ring.h``): the flat ring and the 2-D
topology's tiers, with its hop recorder, shm lanes and link pacers.
"""

from __future__ import annotations

import ctypes
import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from torchft_tpu_torch import _wire
from torchft_tpu_torch._build import native_lib_path

# Wire status codes (native/src/wire.h).
_OK = 0
_CANCELLED = 1
_DEADLINE_EXCEEDED = 4

# Method ids (native/src/wire.h).  Copied from the JAX package's binding
# layer; tests/test_torch_native.py pins that the two agree, so mixed
# JAX/torch quorums stay possible.
LIGHTHOUSE_QUORUM = 1
LIGHTHOUSE_HEARTBEAT = 2
LIGHTHOUSE_STATUS = 3
LIGHTHOUSE_EVICT = 4
LIGHTHOUSE_DRAIN = 5
LIGHTHOUSE_REPLICATE = 6
LIGHTHOUSE_LEADER_INFO = 7
LIGHTHOUSE_REGION_DIGEST = 8
LIGHTHOUSE_REGIONS = 9
MANAGER_QUORUM = 10
MANAGER_CHECKPOINT_METADATA = 11
MANAGER_SHOULD_COMMIT = 12
MANAGER_KILL = 13
STORE_SET = 20
STORE_GET = 21
STORE_ADD = 22
STORE_DELETE = 23

_lib_handle: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# Why the loaded library cannot run the ring engine ("" when it can).
_ring_unavailable = ""


def _declare(lib: ctypes.CDLL) -> None:
    vp, cp, u64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64
    errp = ctypes.POINTER(ctypes.c_char_p)
    lib.tf_free.argtypes = [vp]
    lib.tf_free.restype = None
    lib.tf_lighthouse_new.restype = vp
    lib.tf_lighthouse_new.argtypes = [cp, cp, u64, u64, u64, u64, errp]
    lib.tf_lighthouse_address.restype = vp
    lib.tf_lighthouse_address.argtypes = [vp]
    lib.tf_lighthouse_http_address.restype = vp
    lib.tf_lighthouse_http_address.argtypes = [vp]
    lib.tf_lighthouse_evict.restype = ctypes.c_int
    lib.tf_lighthouse_evict.argtypes = [vp, cp]
    lib.tf_lighthouse_drain.restype = ctypes.c_int
    lib.tf_lighthouse_drain.argtypes = [vp, cp, ctypes.c_int64]
    # HA and federation (docs/wire.md "HA lighthouse", "Federation").  The
    # port builds its library from the repo's sources, so a missing symbol
    # is a build fault and fails here.
    lib.tf_lighthouse_set_role.restype = None
    lib.tf_lighthouse_set_role.argtypes = [vp, ctypes.c_int, cp, cp, ctypes.c_int64,
                                           ctypes.c_int64]
    lib.tf_lighthouse_role.restype = ctypes.c_int
    lib.tf_lighthouse_role.argtypes = [vp]
    lib.tf_lighthouse_leader_epoch.restype = ctypes.c_int64
    lib.tf_lighthouse_leader_epoch.argtypes = [vp]
    lib.tf_lighthouse_snapshot.restype = None
    lib.tf_lighthouse_snapshot.argtypes = [vp, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                           ctypes.POINTER(ctypes.c_size_t)]
    lib.tf_lighthouse_link_state.restype = ctypes.c_int
    lib.tf_lighthouse_link_state.argtypes = [vp, cp]
    lib.tf_lighthouse_set_federation.restype = None
    lib.tf_lighthouse_set_federation.argtypes = [vp, cp, cp, ctypes.c_int64]
    lib.tf_lighthouse_regions_json.restype = vp
    lib.tf_lighthouse_regions_json.argtypes = [vp]
    lib.tf_lighthouse_shutdown.argtypes = [vp]
    lib.tf_lighthouse_shutdown.restype = None
    lib.tf_lighthouse_free.argtypes = [vp]
    lib.tf_lighthouse_free.restype = None
    lib.tf_manager_new.restype = vp
    lib.tf_manager_new.argtypes = [cp, cp, cp, cp, u64, u64, u64, errp]
    lib.tf_manager_address.restype = vp
    lib.tf_manager_address.argtypes = [vp]
    f64, i64 = ctypes.c_double, ctypes.c_int64
    lib.tf_manager_set_status.restype = None
    lib.tf_manager_set_status.argtypes = [vp, i64, cp, f64, f64, f64, i64, i64, i64, f64, f64,
                                          f64]
    lib.tf_manager_set_ledger.restype = None
    lib.tf_manager_set_ledger.argtypes = [vp, f64, f64, ctypes.POINTER(f64), ctypes.c_int32]
    lib.tf_manager_flight_json.restype = vp
    lib.tf_manager_flight_json.argtypes = [vp, u64]
    lib.tf_lighthouse_flight_json.restype = vp
    lib.tf_lighthouse_flight_json.argtypes = [vp, u64]
    lib.tf_manager_shutdown.argtypes = [vp]
    lib.tf_manager_shutdown.restype = None
    lib.tf_manager_free.argtypes = [vp]
    lib.tf_manager_free.restype = None
    lib.tf_store_new.restype = vp
    lib.tf_store_new.argtypes = [cp, errp]
    lib.tf_store_address.restype = vp
    lib.tf_store_address.argtypes = [vp]
    lib.tf_store_shutdown.argtypes = [vp]
    lib.tf_store_shutdown.restype = None
    lib.tf_store_free.argtypes = [vp]
    lib.tf_store_free.restype = None
    lib.tf_client_new.restype = vp
    lib.tf_client_new.argtypes = [cp, u64, errp]
    lib.tf_client_call.restype = ctypes.c_int
    lib.tf_client_call.argtypes = [
        vp, ctypes.c_uint16, cp, ctypes.c_size_t, u64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), errp,
    ]
    lib.tf_client_free.argtypes = [vp]
    lib.tf_client_free.restype = None


def _declare_ring(lib: ctypes.CDLL) -> str:
    """Declares the ``tf_ring_*`` symbols the port binds (the ring's
    tiers, its hop recorder, shm lanes and link pacers); returns why they
    are missing, or "" when every one is there."""
    vp, i32, u32, u64, dbl = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint32,
                              ctypes.c_uint64, ctypes.c_double)
    errp = ctypes.POINTER(ctypes.c_char_p)
    i32p, u32p, u64p = ctypes.POINTER(i32), ctypes.POINTER(u32), ctypes.POINTER(u64)
    sigs = {
        "tf_ring_new": (vp, [i32, dbl, dbl]),
        "tf_ring_set_tier": (ctypes.c_int, [vp, i32, i32, i32p, i32p, errp]),
        "tf_ring_exchange": (ctypes.c_int, [
            vp, i32, i32, u32, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
            dbl, errp,
        ]),
        "tf_ring_pass": (ctypes.c_int, [
            vp, i32, i32, i32, i32, u32, u32, u32, i32, i32, i32, u64p, u64p, dbl, errp,
        ]),
        "tf_ring_pass_multi": (ctypes.c_int, [
            vp, i32, i32, i32, i32, i32p, u32p, u32, u32, i32, i32, i32, u64p, u64p, dbl,
            errp,
        ]),
        "tf_ring_set_shm": (ctypes.c_int, [vp, i32, i32, i32, ctypes.c_char_p, u64, errp]),
        "tf_ring_counters": (ctypes.c_int, [vp, i32, u64p, u64p, i32]),
        "tf_ring_shaper_counters": (None, [vp, i32, i32, u64p, u64p]),
        "tf_ring_shaper_wait_s": (dbl, [vp, i32, i32]),
        "tf_ring_set_shaper": (None, [vp, i32, i32, dbl, dbl]),
        "tf_ring_link_bytes": (u64, [vp, i32, i32, i32]),
        "tf_ring_set_hop": (None, [vp, i32, i32]),
        "tf_ring_hop_stats": (ctypes.c_int, [vp, i32, ctypes.POINTER(dbl)]),
        "tf_ring_hop_records": (ctypes.c_int, [vp, ctypes.POINTER(dbl), i32]),
        "tf_ring_open_fds": (ctypes.c_int, [vp]),
        "tf_ring_close": (None, [vp]),
        "tf_ring_detach": (ctypes.c_int, [vp, errp]),
        "tf_ring_free": (None, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            return f"{native_lib_path()} lacks {name}"
        fn.restype = restype
        fn.argtypes = argtypes
    return ""


def _lib() -> ctypes.CDLL:
    """The loaded native core, built on first use."""
    global _lib_handle, _ring_unavailable
    with _lib_lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(native_lib_path())
            _declare(lib)
            _ring_unavailable = _declare_ring(lib)
            _lib_handle = lib
        return _lib_handle


def ring_engine_unavailable_reason() -> str:
    """Why the native ring engine cannot run here ("" when it can): the
    library failed to build or load, or lacks the ring symbols."""
    try:
        _lib()
    except Exception as e:  # noqa: BLE001 - reported to the caller
        return f"native library unavailable: {e}"
    return _ring_unavailable


def ring_engine_available() -> bool:
    """True when the native library exports the GIL-free ring engine."""
    return not ring_engine_unavailable_reason()


def _take_string(ptr: int) -> str:
    if not ptr:
        return ""
    value = ctypes.string_at(ptr).decode()
    _lib().tf_free(ptr)
    return value


def _take_error(err: "ctypes.c_char_p") -> str:
    if not err.value:
        return "unknown native error"
    msg = err.value.decode()
    _lib().tf_free(ctypes.cast(err, ctypes.c_void_p))
    return msg


def _raise_for_status(status: int, msg: str) -> None:
    """CANCELLED / DEADLINE_EXCEEDED -> TimeoutError, anything else ->
    RuntimeError; the wire status rides on the exception."""
    exc: Exception
    if status in (_CANCELLED, _DEADLINE_EXCEEDED):
        exc = TimeoutError(msg)
    else:
        exc = RuntimeError(msg)
    exc.wire_status = status  # type: ignore[attr-defined]
    raise exc


# Wire status UNAVAILABLE (native/src/wire.h): a transport failure or an HA
# standby's "not the leader" rejection, the two a multi-address client
# fails over on.
_UNAVAILABLE = 14

# The HA standby rejection (native/src/wire.h kNotLeaderPrefix):
# "not the leader; leader=<rpc_addr> http=<http_addr> epoch=<N>".
NOT_LEADER_PREFIX = "not the leader"


def parse_not_leader(msg: str) -> Optional[str]:
    """The leader RPC address a standby's rejection names, "" when the
    standby knows no leader yet, or None when ``msg`` is no such
    rejection."""
    if not msg.startswith(NOT_LEADER_PREFIX):
        return None
    m = re.search(r"leader=(\S*)", msg)
    return m.group(1) if m else ""


class _Client:
    """RPC client over one native connection (connects with retry)."""

    def __init__(self, addr: str, connect_timeout_ms: int = 10000) -> None:
        err = ctypes.c_char_p()
        self._ptr = _lib().tf_client_new(addr.encode(), connect_timeout_ms, ctypes.byref(err))
        if not self._ptr:
            raise TimeoutError(_take_error(err))

    def call(self, method: int, request: bytes, timeout_ms: int) -> bytes:
        lib = _lib()
        resp = ctypes.POINTER(ctypes.c_uint8)()
        resp_len = ctypes.c_size_t()
        err = ctypes.c_char_p()
        status = lib.tf_client_call(
            self._ptr, method, request, len(request), max(0, int(timeout_ms)),
            ctypes.byref(resp), ctypes.byref(resp_len), ctypes.byref(err),
        )
        if status != _OK:
            _raise_for_status(status, _take_error(err))
        data = ctypes.string_at(resp, resp_len.value)
        lib.tf_free(ctypes.cast(resp, ctypes.c_void_p))
        return data

    def close(self) -> None:
        if self._ptr:
            _lib().tf_client_free(self._ptr)
            self._ptr = None


@dataclass
class QuorumResult:
    """Per-rank recovery plan returned by :meth:`ManagerClient._quorum`."""

    quorum_id: int = 0
    replica_rank: int = 0
    replica_world_size: int = 1
    recover_src_manager_address: str = ""
    recover_src_replica_rank: Optional[int] = None
    recover_dst_replica_ranks: List[int] = field(default_factory=list)
    recover_dst_replica_ranks_all: List[int] = field(default_factory=list)
    recover_src_replica_ranks: List[int] = field(default_factory=list)
    recover_src_manager_addresses: List[str] = field(default_factory=list)
    participant_replica_ranks: List[int] = field(default_factory=list)
    participant_manager_addresses: List[str] = field(default_factory=list)
    store_address: str = ""
    max_step: int = 0
    max_replica_rank: Optional[int] = None
    max_world_size: int = 1
    heal: bool = False


class LighthouseServer:
    """In-process native lighthouse."""

    def __init__(
        self,
        bind: str = "[::]:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 100,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        http_bind: str = "[::]:0",
    ) -> None:
        err = ctypes.c_char_p()
        self._ptr = _lib().tf_lighthouse_new(
            bind.encode(), http_bind.encode(), min_replicas, join_timeout_ms,
            quorum_tick_ms, heartbeat_timeout_ms, ctypes.byref(err),
        )
        if not self._ptr:
            raise RuntimeError(_take_error(err))

    def address(self) -> str:
        return _take_string(_lib().tf_lighthouse_address(self._ptr))

    def http_address(self) -> str:
        """URL (``http://host:port``) of the dashboard and metrics server."""
        return _take_string(_lib().tf_lighthouse_http_address(self._ptr))

    def evict(self, replica_prefix: str) -> int:
        """Drops the heartbeat and pending join of every replica id matching
        ``replica_prefix`` (a full id, or a ``"<group>"`` family whose ids are
        ``"<group>:<uuid>"``), so the next quorum forms without waiting on a
        process a supervisor knows is dead.  Returns the number of ids
        dropped."""
        return int(_lib().tf_lighthouse_evict(self._ptr, replica_prefix.encode()))

    def drain(self, replica_prefix: str, deadline_ms: int = 0) -> int:
        """Marks every replica id matching ``replica_prefix`` (a full id or
        a ``"<group>"`` family) as a planned departure: left out of the next
        quorum at once while its step in flight finishes, and refused as
        ``"is draining"`` if it asks again; a replacement incarnation (a
        fresh ``":<uuid>"``) is admitted.  ``deadline_ms`` is advisory.
        Returns the number of ids marked."""
        return int(_lib().tf_lighthouse_drain(self._ptr, replica_prefix.encode(),
                                              int(deadline_ms)))

    def flight_json(self, limit: int = 0) -> str:
        """The flight recorder as a JSON document (newest event first;
        ``limit`` 0 keeps every retained one): the payload of this
        lighthouse's ``GET /debug/flight.json``."""
        if not self._ptr:
            return "{}"
        return _take_string(_lib().tf_lighthouse_flight_json(self._ptr, int(limit)))

    def flight(self, limit: int = 0) -> dict:
        """Parsed :meth:`flight_json` (``{"server", "id", "capacity",
        "recorded", "dropped", "events"}``); :mod:`torchft_tpu_torch.obs.flight`
        reads it."""
        return json.loads(self.flight_json(limit) or "{}")

    def set_role(self, leader: bool, leader_address: str = "", leader_http_address: str = "",
                 epoch: int = 0, lease_expires_ms: int = 0) -> None:
        """HA role control (docs/wire.md "HA lighthouse").  A standalone
        lighthouse is a permanent leader; under the lease election
        (:mod:`torchft_tpu_torch.ha`) the election loop flips the role here at every
        lease transition.  As leader, ``lease_expires_ms`` (epoch ms) is the
        serve-time guard: once it passes without a renewed call, Quorum and
        Heartbeat are refused, so a leader whose lease expired never
        answers beside the lease's next winner.  As follower, the
        ``leader_*`` addresses are where the redirect rejections and HTTP
        307s point clients."""
        if self._ptr:
            _lib().tf_lighthouse_set_role(self._ptr, 1 if leader else 0, leader_address.encode(),
                                          leader_http_address.encode(), int(epoch),
                                          int(lease_expires_ms))

    def role(self) -> int:
        """1 leader with a live lease, 0 follower (or a lapsed lease)."""
        return int(_lib().tf_lighthouse_role(self._ptr)) if self._ptr else 0

    def leader_epoch(self) -> int:
        return int(_lib().tf_lighthouse_leader_epoch(self._ptr)) if self._ptr else 0

    def snapshot(self) -> bytes:
        """The serialized ``LighthouseReplicateRequest`` of the whole
        replicable state (membership, live step and state, the sentinels'
        health, alerts, the previous quorum and its id): what the HA election loop
        pushes to each standby over wire method 6."""
        if not self._ptr:
            return b""
        lib = _lib()
        buf = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_size_t()
        lib.tf_lighthouse_snapshot(self._ptr, ctypes.byref(buf), ctypes.byref(length))
        data = ctypes.string_at(buf, length.value)
        lib.tf_free(ctypes.cast(buf, ctypes.c_void_p))
        return data

    def set_federation(self, region: str, root_addrs: str, push_interval_ms: int = 500) -> None:
        """Joins a two-tier federation as the child lighthouse of ``region``
        (docs/wire.md "Federation"): this instance keeps its local groups'
        heartbeats, sentinels and ledger, but stops forming quorums; a
        native loop pushes a membership and ledger digest to the root at
        ``root_addrs`` (comma-separated, leader and standbys) every
        ``push_interval_ms`` and installs the global quorum the root
        returns.  The root needs no call: any lighthouse that receives
        digests serves as root."""
        if self._ptr:
            _lib().tf_lighthouse_set_federation(self._ptr, region.encode(), root_addrs.encode(),
                                                int(push_interval_ms))

    def regions_json(self) -> str:
        """The federation rollup as a JSON document, the payload of
        ``GET /regions.json``: ``{"role", "region", "regions": [...]}``, role
        ``"root"``, ``"child"`` or ``"flat"``."""
        if not self._ptr:
            return '{"role":"flat","region":"","regions":[]}'
        return _take_string(_lib().tf_lighthouse_regions_json(self._ptr))

    def regions(self) -> dict:
        """Parsed :meth:`regions_json`."""
        return json.loads(self.regions_json() or "{}")

    def link_state(self, replica_id: str) -> int:
        """The slow-link sentinel's state of the replica's outbound edge (0
        healthy, 1 suspect, 2 degraded)."""
        if not self._ptr:
            return 0
        return int(_lib().tf_lighthouse_link_state(self._ptr, replica_id.encode()))

    def shutdown(self) -> None:
        if self._ptr:
            lib = _lib()
            lib.tf_lighthouse_shutdown(self._ptr)
            lib.tf_lighthouse_free(self._ptr)
            self._ptr = None


class LighthouseClient:
    """Lighthouse access over the wire.

    ``addr`` is one ``host:port`` or a comma-separated list (an HA replica
    set, docs/wire.md "HA lighthouse"): every call fails over across the
    list with decorrelated-jitter backoff, follows a standby's "not the
    leader; leader=<addr>" straight to the leader, and raises an error
    naming every address when none answers in time.  Connections are made
    at the first call."""

    def __init__(self, addr: str, connect_timeout_ms: int = 10000) -> None:
        self._addrs = [a.strip() for a in addr.split(",") if a.strip()]
        if not self._addrs:
            raise ValueError("empty lighthouse address")
        self._connect_timeout_ms = connect_timeout_ms
        self._cur = 0
        self._leader_override: Optional[str] = None
        self._clients: dict = {}

    def _client_for(self, addr: str, budget_ms: int) -> _Client:
        client = self._clients.get(addr)
        if client is None:
            # A short connect budget an attempt, so one dead address cannot
            # eat the failover window before the others are tried.
            client = _Client(addr, connect_timeout_ms=min(2000, max(250, budget_ms)))
            self._clients[addr] = client
        return client

    def _call_failover(self, method: int, payload: bytes, timeout_ms: int) -> bytes:
        """One logical call against the replica set: the current (or the
        redirect-named) address; on UNAVAILABLE or a failed connect, follow
        the redirect or rotate, with decorrelated-jitter backoff, until
        ``timeout_ms`` has passed.  Application errors (ABORTED "is
        draining", a live server's DEADLINE_EXCEEDED) are final."""
        from torchft_tpu_torch.ha.backoff import DecorrelatedBackoff

        deadline = time.monotonic() + max(0.05, timeout_ms / 1e3)
        # Capped under a lease period: mid-election every address rejects,
        # and the sleep would otherwise set the failover's latency.
        backoff = DecorrelatedBackoff(base_s=0.05, cap_s=0.5)
        last_exc: Optional[Exception] = None
        first = True
        while first or time.monotonic() < deadline:
            first = False
            left_ms = max(250, int((deadline - time.monotonic()) * 1e3))
            addr = self._leader_override or self._addrs[self._cur % len(self._addrs)]
            try:
                client = self._client_for(addr, min(self._connect_timeout_ms, left_ms))
                return client.call(method, payload, min(timeout_ms, left_ms))
            except TimeoutError as e:
                if getattr(e, "wire_status", None) is not None:
                    raise  # DEADLINE_EXCEEDED from a live server
                last_exc = e  # the connect failed: rotate below
            except RuntimeError as e:
                if getattr(e, "wire_status", None) != _UNAVAILABLE:
                    raise  # an application error, e.g. "is draining"
                last_exc = e
                leader = parse_not_leader(str(e))
                if leader and leader != addr:
                    # The rejection proves the service is up: straight to
                    # the named leader, no backoff.
                    self._leader_override = leader
                    continue
            # A transport failure or a standby that knows no leader: drop a
            # learned leader (it may just have died), else rotate.
            if self._leader_override is not None:
                self._leader_override = None
            else:
                self._cur = (self._cur + 1) % len(self._addrs)
            sleep_s = backoff.next()
            if time.monotonic() + sleep_s >= deadline:
                break
            time.sleep(sleep_s)
        raise TimeoutError(
            "no lighthouse answered at any of [" + ", ".join(self._addrs)
            + f"] within {timeout_ms} ms: check TPUFT_LIGHTHOUSE and that the lighthouse "
            f"processes are running (last error: {last_exc})")

    def _call(self, method: int, request: str, fields: dict, response: str,
              timeout_ms: int) -> "_wire.Message":
        raw = self._call_failover(method, _wire.encode(request, fields), timeout_ms)
        return _wire.decode(response, raw)

    def quorum(self, replica_id: str, timeout_ms: int = 5000, address: str = "",
               store_address: str = "", step: int = 0, world_size: int = 1,
               shrink_only: bool = False, data: Optional[dict] = None,
               trace_id: str = "") -> "_wire.Message":
        """Joins the lighthouse's next quorum (wire method 1) and returns it
        (a ``_wire.Quorum``); ``data`` rides on this member as JSON."""
        member = {"replica_id": replica_id, "address": address, "store_address": store_address,
                  "step": int(step), "world_size": int(world_size), "shrink_only": shrink_only}
        if data is not None:
            member["data"] = json.dumps(data)
        return self._call(LIGHTHOUSE_QUORUM, "LighthouseQuorumRequest",
                          {"requester": member, "trace_id": trace_id},
                          "LighthouseQuorumResponse", timeout_ms).quorum

    def heartbeat(self, replica_id: str, timeout_ms: int = 5000, step: int = 0, state: str = "",
                  step_time_ms_ewma: float = 0.0, step_time_ms_last: float = 0.0,
                  trace_id: str = "", link_recv_gbps: float = 0.0,
                  link_send_gbps: float = 0.0, link_hop_rtt_ms: float = 0.0) -> None:
        """One heartbeat (wire method 2): ``step`` and ``state`` feed the
        lighthouse's per-replica gauges, the step times its straggler
        sentinel, the link fields (0 = not reported) its slow-link
        sentinel."""
        self._call(LIGHTHOUSE_HEARTBEAT, "LighthouseHeartbeatRequest", {
            "replica_id": replica_id, "step": int(step), "state": state,
            "step_time_ms_ewma": float(step_time_ms_ewma),
            "step_time_ms_last": float(step_time_ms_last), "trace_id": trace_id,
            "link_recv_gbps": float(link_recv_gbps), "link_send_gbps": float(link_send_gbps),
            "link_hop_rtt_ms": float(link_hop_rtt_ms),
        }, "LighthouseHeartbeatResponse", timeout_ms)

    def evict(self, replica_prefix: str, timeout_ms: int = 5000) -> int:
        """:meth:`LighthouseServer.evict` through wire method 4."""
        return self._call(LIGHTHOUSE_EVICT, "LighthouseEvictRequest",
                          {"replica_prefix": replica_prefix}, "LighthouseEvictResponse",
                          timeout_ms).evicted

    def drain(self, replica_prefix: str, deadline_ms: int = 0, timeout_ms: int = 5000,
              trace_id: str = "") -> int:
        """:meth:`LighthouseServer.drain` through wire method 5; ``trace_id``
        is the step in flight's, for the lighthouse's flight recorder."""
        return self._call(LIGHTHOUSE_DRAIN, "LighthouseDrainRequest", {
            "replica_prefix": replica_prefix, "deadline_ms": int(deadline_ms),
            "trace_id": trace_id,
        }, "LighthouseDrainResponse", timeout_ms).drained

    def status(self, timeout_ms: int = 5000) -> "_wire.Message":
        """The lighthouse's ``LighthouseStatusResponse`` (wire method 3)."""
        return _wire.decode("LighthouseStatusResponse",
                            self._call_failover(LIGHTHOUSE_STATUS, b"", timeout_ms))

    def leader(self, timeout_ms: int = 5000) -> "_wire.Message":
        """Leader discovery (wire method 7): whom the answering replica
        takes for the leader (``leader``, a ``LeaderInfo``) and its own
        role (1 leader, 0 follower).  Every replica answers it."""
        return _wire.decode("LighthouseLeaderInfoResponse",
                            self._call_failover(LIGHTHOUSE_LEADER_INFO, b"", timeout_ms))

    def replicate(self, snapshot: bytes, timeout_ms: int = 5000) -> "_wire.Message":
        """Pushes a :meth:`LighthouseServer.snapshot` to the replica this
        client targets (wire method 6).  ``applied`` False: the receiver
        holds a higher epoch and the sender should demote itself."""
        return _wire.decode("LighthouseReplicateResponse",
                            self._call_failover(LIGHTHOUSE_REPLICATE, snapshot, timeout_ms))

    def close(self) -> None:
        for client in self._clients.values():
            client.close()
        self._clients.clear()


class ManagerServer:
    """In-process native manager server, run by a group's local rank 0."""

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        bind: str = "[::]:0",
        store_addr: str = "",
        world_size: int = 1,
        heartbeat_interval_ms: int = 100,
        connect_timeout_ms: int = 10000,
    ) -> None:
        err = ctypes.c_char_p()
        self._ptr = _lib().tf_manager_new(
            replica_id.encode(), lighthouse_addr.encode(), bind.encode(),
            store_addr.encode(), world_size, heartbeat_interval_ms,
            connect_timeout_ms, ctypes.byref(err),
        )
        if not self._ptr:
            raise RuntimeError(_take_error(err))

    def address(self) -> str:
        return _take_string(_lib().tf_manager_address(self._ptr))

    def set_status(
        self,
        step: int,
        state: str,
        step_time_ms_ewma: float = 0.0,
        step_time_ms_last: float = 0.0,
        allreduce_gb_per_s: float = -1.0,
        ec_shards_held: int = -1,
        ec_shard_step: int = -1,
        ec_k: int = -1,
        link_recv_gbps: float = -1.0,
        link_send_gbps: float = -1.0,
        link_hop_rtt_ms: float = -1.0,
    ) -> None:
        """Puts (step, state) and the step-time telemetry on this group's
        lighthouse heartbeats (proto ``LighthouseHeartbeatRequest`` fields
        4-13), with the JAX package's conventions: step times of 0 keep the
        previous values; for the GB/s, EC and link gauges 0 is a reading
        and a negative value keeps the previous one."""
        if self._ptr:
            _lib().tf_manager_set_status(
                self._ptr, int(step), state.encode(), float(step_time_ms_ewma),
                float(step_time_ms_last), float(allreduce_gb_per_s), int(ec_shards_held),
                int(ec_shard_step), int(ec_k), float(link_recv_gbps), float(link_send_gbps),
                float(link_hop_rtt_ms),
            )

    def set_ledger(self, goodput_ratio: float, compute_seconds: float,
                   lost_seconds: List[float]) -> None:
        """Puts the goodput ledger's cumulative counters on heartbeat
        fields 14-16: the productive share, productive seconds, and lost
        seconds per cause in :data:`torchft_tpu_torch.obs.ledger.LOST_CAUSES`
        order (the lighthouse's ``/goodput.json`` sums them)."""
        if not self._ptr:
            return
        arr = (ctypes.c_double * len(lost_seconds))(*lost_seconds)
        _lib().tf_manager_set_ledger(self._ptr, float(goodput_ratio), float(compute_seconds),
                                     arr, len(lost_seconds))

    def flight_json(self, limit: int = 0) -> str:
        """The manager server's flight recorder as a JSON document (newest
        event first; ``limit`` 0 keeps every retained one)."""
        if not self._ptr:
            return "{}"
        return _take_string(_lib().tf_manager_flight_json(self._ptr, int(limit)))

    def flight(self, limit: int = 0) -> dict:
        """Parsed :meth:`flight_json`."""
        return json.loads(self.flight_json(limit) or "{}")

    def shutdown(self) -> None:
        if self._ptr:
            lib = _lib()
            lib.tf_manager_shutdown(self._ptr)
            lib.tf_manager_free(self._ptr)
            self._ptr = None


class ManagerClient:
    """Client every local rank uses to talk to its group's manager server."""

    def __init__(self, addr: str, connect_timeout_ms: int = 10000) -> None:
        self._client = _Client(addr, connect_timeout_ms)

    def _quorum(
        self,
        group_rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool,
        timeout_ms: int,
        init_sync: bool = True,
        commit_failures: int = 0,
        trace_id: str = "",
    ) -> QuorumResult:
        req = _wire.encode("ManagerQuorumRequest", {
            "group_rank": group_rank,
            "step": step,
            "checkpoint_metadata": checkpoint_metadata,
            "shrink_only": shrink_only,
            "init_sync": init_sync,
            "commit_failures": commit_failures,
            "trace_id": trace_id,
        })
        r = _wire.decode(
            "ManagerQuorumResponse", self._client.call(MANAGER_QUORUM, req, timeout_ms)
        )
        heal = r["heal"]
        return QuorumResult(
            quorum_id=r["quorum_id"],
            replica_rank=r["replica_rank"],
            replica_world_size=r["replica_world_size"],
            recover_src_manager_address=r["recover_src_manager_address"],
            recover_src_replica_rank=r["recover_src_replica_rank"] if heal else None,
            recover_dst_replica_ranks=r["recover_dst_replica_ranks"],
            recover_dst_replica_ranks_all=(
                r["recover_dst_replica_ranks_all"] or r["recover_dst_replica_ranks"]
            ),
            recover_src_replica_ranks=r["recover_src_replica_ranks"] if heal else [],
            recover_src_manager_addresses=(
                r["recover_src_manager_addresses"] if heal else []
            ),
            participant_replica_ranks=r["participant_replica_ranks"],
            participant_manager_addresses=r["participant_manager_addresses"],
            store_address=r["store_address"],
            max_step=r["max_step"],
            max_replica_rank=r["max_replica_rank"] if r["max_replica_rank"] >= 0 else None,
            max_world_size=r["max_world_size"],
            heal=heal,
        )

    def _checkpoint_metadata(self, rank: int, timeout_ms: int, trace_id: str = "") -> str:
        req = _wire.encode(
            "CheckpointMetadataRequest", {"group_rank": rank, "trace_id": trace_id}
        )
        resp = self._client.call(MANAGER_CHECKPOINT_METADATA, req, timeout_ms)
        return _wire.decode("CheckpointMetadataResponse", resp)["checkpoint_metadata"]

    def should_commit(
        self,
        group_rank: int,
        step: int,
        should_commit: bool,
        timeout_ms: int,
        trace_id: str = "",
    ) -> bool:
        req = _wire.encode("ShouldCommitRequest", {
            "group_rank": group_rank,
            "step": step,
            "should_commit": should_commit,
            "trace_id": trace_id,
        })
        resp = self._client.call(MANAGER_SHOULD_COMMIT, req, timeout_ms)
        return _wire.decode("ShouldCommitResponse", resp)["should_commit"]

    def close(self) -> None:
        self._client.close()


class StoreServer:
    """Native key-value rendezvous store server."""

    def __init__(self, bind: str = "[::]:0") -> None:
        err = ctypes.c_char_p()
        self._ptr = _lib().tf_store_new(bind.encode(), ctypes.byref(err))
        if not self._ptr:
            raise RuntimeError(_take_error(err))

    def address(self) -> str:
        return _take_string(_lib().tf_store_address(self._ptr))

    def shutdown(self) -> None:
        if self._ptr:
            lib = _lib()
            lib.tf_store_shutdown(self._ptr)
            lib.tf_store_free(self._ptr)
            self._ptr = None


class StoreClient:
    """Client for the rendezvous store; ``"host:port/prefix"`` prefixes
    every key (the PrefixStore analogue)."""

    def __init__(self, addr: str, prefix: str = "", connect_timeout_ms: int = 10000) -> None:
        if "/" in addr:
            addr, extra = addr.split("/", 1)
            prefix = extra + "/" + prefix if prefix else extra
        self._client = _Client(addr, connect_timeout_ms)
        self._prefix = prefix

    def sub_store(self, prefix: str) -> "StoreClient":
        """A client on the same connection whose keys are under
        ``<this prefix>/<prefix>``."""
        child = StoreClient.__new__(StoreClient)
        child._client = self._client
        child._prefix = f"{self._prefix}/{prefix}" if self._prefix else prefix
        return child

    def _key(self, key: str) -> str:
        return f"{self._prefix}/{key}" if self._prefix else key

    def set(self, key: str, value: bytes, timeout_ms: int = 10000) -> None:
        req = _wire.encode("StoreSetRequest", {"key": self._key(key), "value": value})
        self._client.call(STORE_SET, req, timeout_ms)

    def get(self, key: str, wait: bool = True, timeout_ms: int = 10000) -> Optional[bytes]:
        req = _wire.encode("StoreGetRequest", {"key": self._key(key), "wait": wait})
        resp = _wire.decode("StoreGetResponse", self._client.call(STORE_GET, req, timeout_ms))
        return resp["value"] if resp["found"] else None

    def add(self, key: str, delta: int, timeout_ms: int = 10000) -> int:
        req = _wire.encode("StoreAddRequest", {"key": self._key(key), "delta": delta})
        return _wire.decode("StoreAddResponse", self._client.call(STORE_ADD, req, timeout_ms))["value"]

    def delete(self, key: str, timeout_ms: int = 10000) -> None:
        req = _wire.encode("StoreDeleteRequest", {"key": self._key(key)})
        self._client.call(STORE_DELETE, req, timeout_ms)

    def close(self) -> None:
        self._client.close()


class RingEngine:
    """GIL-free ring data plane (``native/src/ring.h``).

    Owns dup()'d copies of :class:`~torchft_tpu_torch.collectives.TCPCollective`'s
    lane sockets, for the flat ring and the 2-D topology's row and column
    tiers, and runs the per-hop hot loop natively: scatter-gather socket
    I/O over the caller's f32 buffers (or a same-host lane's shared-memory
    ring), the tag demux, the per-direction link pacer, and the bf16, int8
    and int4 wire codecs, with the same frames, codec bytes and combine
    order as the Python engine (the two interoperate on one ring, and with
    the JAX package's engines).  Every call releases the GIL for its whole
    duration (ctypes), which is the point: a striped allreduce does no
    interpreter work on the wire path.  Direction 0 is next (sends), 1 prev
    (receives).
    """

    # Tiers, ring-pass modes, ops and wires (native/src/ring.h enums).
    TIER_FLAT = 0
    TIER_ROW = 1
    TIER_COL = 2
    PASS_FULL = 0
    PASS_RS = 1
    PASS_AG = 2
    OP_SUM = 0
    OP_MAX = 1
    OP_MIN = 2
    WIRE_RAW = 0
    WIRE_BF16 = 1
    WIRE_INT8 = 2
    WIRE_INT4 = 3

    def __init__(self, lanes: int, shaper_mbps: float = 0.0, shaper_rtt_ms: float = 0.0) -> None:
        """``shaper_mbps`` > 0 paces every tier-direction's sends at that
        rate plus half ``shaper_rtt_ms`` a frame (``TPUFT_SHAPED_LINK``'s
        model); 0 leaves the links unpaced."""
        reason = ring_engine_unavailable_reason()
        if reason:
            raise RuntimeError(reason)
        self._lib = _lib()
        self._ptr = self._lib.tf_ring_new(int(lanes), float(shaper_mbps), float(shaper_rtt_ms))
        self._lanes = int(lanes)
        # Python -> native crossings on the data path (ring_pass and
        # ring_pass_multi calls): one per allreduce with the batched entry.
        self.pass_calls = 0

    def set_tier(self, tier: int, next_fds: List[int], prev_fds: List[int]) -> None:
        """Registers one tier's lane sockets, one per lane and direction
        (the engine dup()s them; the Python sockets stay owned, and closed,
        by the collective)."""
        if tier not in (self.TIER_FLAT, self.TIER_ROW, self.TIER_COL):
            raise ValueError(f"unknown ring tier {tier}")
        n = len(next_fds)
        if len(prev_fds) != n:
            raise ValueError("next and prev need one fd per lane each")
        nxt = (ctypes.c_int32 * n)(*next_fds)
        prv = (ctypes.c_int32 * n)(*prev_fds)
        err = ctypes.c_char_p()
        if self._lib.tf_ring_set_tier(self._ptr, tier, n, nxt, prv, ctypes.byref(err)) != 0:
            raise RuntimeError(_take_error(err))

    def set_shm(self, tier: int, direction: int, lane: int, path: str, token: int) -> None:
        """Moves one lane link's frames onto a same-host shared-memory ring
        (the segment the rendezvous negotiated; its TCP socket stays open as
        the liveness and abort channel).  Raises when the segment's magic
        or generation token does not match (a dead peer's stale segment)."""
        err = ctypes.c_char_p()
        rc = self._lib.tf_ring_set_shm(self._ptr, int(tier), int(direction), int(lane),
                                       path.encode(), int(token) & 0xFFFFFFFFFFFFFFFF,
                                       ctypes.byref(err))
        if rc != 0:
            raise RuntimeError(_take_error(err))

    def shaper_counters(self, tier: int, direction: int) -> "tuple[int, int]":
        """(bytes, frames) through one tier-direction's shared pacer."""
        b, f = ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.tf_ring_shaper_counters(self._ptr, int(tier), int(direction),
                                          ctypes.byref(b), ctypes.byref(f))
        return int(b.value), int(f.value)

    def shaper_wait_s(self, tier: int, direction: int) -> float:
        """Seconds one tier-direction's pacer slept."""
        return float(self._lib.tf_ring_shaper_wait_s(self._ptr, int(tier), int(direction)))

    def set_shaper(self, tier: int, direction: int, mbps: float, rtt_ms: float) -> None:
        """Re-paces one tier-direction mid-run; ``mbps`` <= 0 disables it."""
        self._lib.tf_ring_set_shaper(self._ptr, int(tier), int(direction), float(mbps),
                                     float(rtt_ms))

    @staticmethod
    def _raise(rc: int, err: "ctypes.c_char_p") -> None:
        msg = _take_error(err)
        if rc == 1:
            raise TimeoutError(msg)
        if rc == 2:
            raise ConnectionError(msg)
        raise RuntimeError(msg)

    def exchange(self, tier: int, lane: int, tag: int, payload: bytes, timeout_s: float) -> bytes:
        """Full-duplex framed exchange on ``lane``: sends ``payload`` under
        ``tag`` to the next rank while receiving the same tag from the
        previous one, through the engine's demux (the path Python-run hops
        take while an engine owns the lanes)."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        err = ctypes.c_char_p()
        rc = self._lib.tf_ring_exchange(
            self._ptr, tier, lane, tag & 0xFFFFFFFF, payload, len(payload),
            ctypes.byref(out), ctypes.byref(out_len), float(timeout_s), ctypes.byref(err),
        )
        if rc != 0:
            self._raise(rc, err)
        data = ctypes.string_at(out, out_len.value)
        self._lib.tf_free(ctypes.cast(out, ctypes.c_void_p))
        return data

    def ring_pass(self, tier: int, lane: int, n: int, rank: int, tag_base: int, rs_sub: int,
                  ag_sub: int, mode: int, op: int, wire: int, chunk_ptrs: List[int],
                  chunk_elems: List[int], timeout_s: float) -> None:
        """One ring pass IN PLACE over ``n`` chunk views (addresses and
        element counts into the caller's contiguous f32 buffer, cut by
        ``np.array_split`` on every rank); the buffer must outlive the call,
        which blocks."""
        ptrs = (ctypes.c_uint64 * n)(*chunk_ptrs)
        elems = (ctypes.c_uint64 * n)(*chunk_elems)
        err = ctypes.c_char_p()
        self.pass_calls += 1
        rc = self._lib.tf_ring_pass(
            self._ptr, tier, lane, n, rank, tag_base & 0xFFFFFFFF, rs_sub, ag_sub,
            mode, op, wire, ptrs, elems, float(timeout_s), ctypes.byref(err),
        )
        if rc != 0:
            self._raise(rc, err)

    def ring_pass_multi(self, tier: int, nstripes: int, n: int, rank: int, lanes: List[int],
                        tag_bases: List[int], rs_sub: int, ag_sub: int, mode: int, op: int,
                        wire: int, chunk_ptrs: List[int], chunk_elems: List[int],
                        timeout_s: float) -> None:
        """``nstripes`` independent ring passes in one call: stripe ``s`` on
        lane ``lanes[s]`` under ``tag_bases[s]``, over the chunk views
        ``[s * n, s * n + n)`` of ``chunk_ptrs``/``chunk_elems``.  The engine
        fans the stripes out on its own workers; a failure on any stripe
        fails them all and the first error is raised."""
        total = nstripes * n
        if len(chunk_ptrs) != total or len(chunk_elems) != total:
            raise ValueError("ring_pass_multi: one pointer and count per stripe and chunk")
        if len(lanes) != nstripes or len(tag_bases) != nstripes:
            raise ValueError("ring_pass_multi: one lane and tag base per stripe")
        lanes_a = (ctypes.c_int32 * nstripes)(*lanes)
        tags_a = (ctypes.c_uint32 * nstripes)(*(t & 0xFFFFFFFF for t in tag_bases))
        ptrs = (ctypes.c_uint64 * total)(*chunk_ptrs)
        elems = (ctypes.c_uint64 * total)(*chunk_elems)
        err = ctypes.c_char_p()
        self.pass_calls += 1
        rc = self._lib.tf_ring_pass_multi(
            self._ptr, tier, nstripes, n, rank, lanes_a, tags_a, rs_sub, ag_sub, mode, op, wire,
            ptrs, elems, float(timeout_s), ctypes.byref(err),
        )
        if rc != 0:
            self._raise(rc, err)

    def counters(self, tier: int) -> "tuple[List[int], List[int]]":
        """(sent, received) wire bytes per lane of ``tier``, headers
        included."""
        sent = (ctypes.c_uint64 * self._lanes)()
        recv = (ctypes.c_uint64 * self._lanes)()
        got = self._lib.tf_ring_counters(self._ptr, tier, sent, recv, self._lanes)
        return list(sent[:got]), list(recv[:got])

    def link_bytes(self, tier: int, direction: int, lane: int) -> int:
        return int(self._lib.tf_ring_link_bytes(self._ptr, tier, direction, lane))

    def set_hop(self, sample: int, cap: int = 0) -> None:
        """Configures the engine's hop recorder: every ``sample``-th hop
        goes into the bounded timeline (0 keeps only the per-tier
        aggregates); ``cap`` > 0 resizes (and clears) the timeline."""
        self._lib.tf_ring_set_hop(self._ptr, int(sample), int(cap))

    def hop_stats(self, tier: int) -> dict:
        """Per-tier stall aggregates: ``{"hops", "send_block_s",
        "recv_wait_s", "combine_s"}``."""
        out = (ctypes.c_double * 4)()
        self._lib.tf_ring_hop_stats(self._ptr, int(tier), out)
        return {"hops": int(out[0]), "send_block_s": float(out[1]),
                "recv_wait_s": float(out[2]), "combine_s": float(out[3])}

    def hop_records(self, cap: int = 4096) -> List[dict]:
        """The retained hop timeline, oldest first, as dicts with exactly
        the keys of :data:`torchft_tpu_torch.collectives.HOP_RECORD_FIELDS`."""
        buf = (ctypes.c_double * (8 * max(1, cap)))()
        n = self._lib.tf_ring_hop_records(self._ptr, buf, int(cap))
        out = []
        for i in range(n):
            o = buf[i * 8:i * 8 + 8]
            out.append({"ts": float(o[0]), "tier": int(o[1]), "lane": int(o[2]),
                        "tag": int(o[3]), "send_s": float(o[4]), "recv_s": float(o[5]),
                        "comb_s": float(o[6]), "nbytes": int(o[7])})
        return out

    def open_fd_count(self) -> int:
        """Dup'd lane fds still open: 0 after :meth:`close`."""
        return int(self._lib.tf_ring_open_fds(self._ptr)) if self._ptr else 0

    def close(self) -> None:
        """Shuts down and closes every dup'd lane fd and joins the sender
        threads; idempotent and safe mid-op (blocked ops fail fast)."""
        if self._ptr:
            self._lib.tf_ring_close(self._ptr)

    def detach(self) -> None:
        """Releases the dup'd fds WITHOUT shutting the connections down, so
        the collective's sockets stay usable; raises if ops were in flight
        (the lanes are then dead)."""
        if self._ptr:
            err = ctypes.c_char_p()
            if self._lib.tf_ring_detach(self._ptr, ctypes.byref(err)) != 0:
                raise RuntimeError(_take_error(err))

    def __del__(self) -> None:
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.tf_ring_close(ptr)
            self._lib.tf_ring_free(ptr)
