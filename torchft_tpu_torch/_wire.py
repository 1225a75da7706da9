"""Hand-written proto3 codec for the messages the port's Python side speaks.

The native core's RPC payloads are ``proto/tpuft.proto`` messages.  The JAX
package builds them with the generated ``tpuft_pb2`` module, which needs the
``google.protobuf`` package; the port keeps to the standard library.  The
encoding is canonical proto3, as the protobuf runtime emits it: fields in
field-number order, default values omitted, ``int64`` as a two's-complement
varint, ``double`` as little-endian fixed64 (``-0.0`` kept, as the runtime
keeps it), repeated scalars packed, a nested message written whenever it is
present (even empty), a map as one entry message per key (key 1 and value
2, both always written) in sorted key order, as the runtime's deterministic
mode writes it.  Decoding also accepts unpacked repeated scalars and skips
unknown fields, as proto3 parsers must.

Only the messages in :data:`SCHEMAS` are covered (``proto/tpuft.proto``: the
Manager and Store services, and the lighthouse's Quorum, Heartbeat, Status,
Evict, Drain, LeaderInfo and Regions messages and the Replicate response).
``LighthouseReplicateRequest`` travels as the native server's opaque
``snapshot()`` bytes and needs no schema.

:func:`decode` returns a :class:`Message`: a dict of every field that also
reads them as attributes and has protobuf's ``SerializeToString``
and ``FromString``, so ``_wire.Quorum`` stands where the JAX package uses
``tpuft_pb2.Quorum``.  An absent nested message reads as ``None``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# message name -> [(field number, field name, kind)], field-number order.
# kind: int64 | uint64 | bool | string | bytes | double | rep_int64 |
# rep_string | rep_double | msg:<Name> | rep_msg:<Name> |
# map_int64 (map<string, int64>) | map_string (map<string, string>)
SCHEMAS: Dict[str, List[Tuple[int, str, str]]] = {
    "ManagerQuorumRequest": [
        (1, "group_rank", "int64"),
        (2, "step", "int64"),
        (3, "checkpoint_metadata", "string"),
        (4, "shrink_only", "bool"),
        (5, "init_sync", "bool"),
        (6, "commit_failures", "int64"),
        (7, "trace_id", "string"),
    ],
    "ManagerQuorumResponse": [
        (1, "quorum_id", "int64"),
        (2, "store_address", "string"),
        (3, "max_step", "int64"),
        (4, "max_replica_rank", "int64"),
        (5, "max_world_size", "int64"),
        (6, "replica_rank", "int64"),
        (7, "replica_world_size", "int64"),
        (8, "heal", "bool"),
        (9, "recover_src_manager_address", "string"),
        (10, "recover_src_replica_rank", "int64"),
        (11, "recover_dst_replica_ranks", "rep_int64"),
        (12, "recover_src_replica_ranks", "rep_int64"),
        (13, "recover_src_manager_addresses", "rep_string"),
        (14, "recover_dst_replica_ranks_all", "rep_int64"),
        (15, "participant_replica_ranks", "rep_int64"),
        (16, "participant_manager_addresses", "rep_string"),
    ],
    "CheckpointMetadataRequest": [
        (1, "group_rank", "int64"),
        (2, "trace_id", "string"),
    ],
    "CheckpointMetadataResponse": [(1, "checkpoint_metadata", "string")],
    "ShouldCommitRequest": [
        (1, "group_rank", "int64"),
        (2, "step", "int64"),
        (3, "should_commit", "bool"),
        (4, "trace_id", "string"),
    ],
    "ShouldCommitResponse": [(1, "should_commit", "bool")],
    "StoreSetRequest": [(1, "key", "string"), (2, "value", "bytes")],
    "StoreSetResponse": [],
    "StoreGetRequest": [(1, "key", "string"), (2, "wait", "bool")],
    "StoreGetResponse": [(1, "found", "bool"), (2, "value", "bytes")],
    "StoreAddRequest": [(1, "key", "string"), (2, "delta", "int64")],
    "StoreAddResponse": [(1, "value", "int64")],
    "StoreDeleteRequest": [(1, "key", "string")],
    "StoreDeleteResponse": [],
    "LighthouseEvictRequest": [(1, "replica_prefix", "string")],
    "LighthouseEvictResponse": [(1, "evicted", "int64")],
    "LighthouseDrainRequest": [
        (1, "replica_prefix", "string"),
        (2, "deadline_ms", "int64"),
        (3, "trace_id", "string"),
    ],
    "LighthouseDrainResponse": [(1, "drained", "int64")],
    "QuorumMember": [
        (1, "replica_id", "string"),
        (2, "address", "string"),
        (3, "store_address", "string"),
        (4, "step", "int64"),
        (5, "world_size", "uint64"),
        (6, "shrink_only", "bool"),
        (7, "data", "string"),
    ],
    "Quorum": [
        (1, "quorum_id", "int64"),
        (2, "participants", "rep_msg:QuorumMember"),
        (3, "created_ms", "int64"),
    ],
    "LighthouseQuorumRequest": [
        (1, "requester", "msg:QuorumMember"),
        (2, "trace_id", "string"),
    ],
    "LighthouseQuorumResponse": [(1, "quorum", "msg:Quorum")],
    "LighthouseHeartbeatRequest": [
        (1, "replica_id", "string"),
        (2, "step", "int64"),
        (3, "state", "string"),
        (4, "step_time_ms_ewma", "double"),
        (5, "step_time_ms_last", "double"),
        (6, "allreduce_gb_per_s", "double"),
        (7, "trace_id", "string"),
        (8, "ec_shards_held", "int64"),
        (9, "ec_shard_step", "int64"),
        (10, "ec_k", "int64"),
        (11, "link_recv_gbps", "double"),
        (12, "link_send_gbps", "double"),
        (13, "link_hop_rtt_ms", "double"),
        (14, "goodput_ratio", "double"),
        (15, "ledger_compute_seconds", "double"),
        (16, "ledger_lost_seconds", "rep_double"),
    ],
    "LighthouseHeartbeatResponse": [],
    "LeaderInfo": [
        (1, "leader_address", "string"),
        (2, "leader_http_address", "string"),
        (3, "leader_epoch", "int64"),
        (4, "lease_expires_ms", "int64"),
    ],
    "LighthouseReplicateResponse": [
        (1, "applied", "bool"),
        (2, "leader_epoch", "int64"),
    ],
    "LighthouseLeaderInfoResponse": [
        (1, "leader", "msg:LeaderInfo"),
        (2, "role", "int64"),
    ],
    "LighthouseStatusResponse": [
        (1, "prev_quorum", "msg:Quorum"),
        (2, "pending_participants", "rep_msg:QuorumMember"),
        (3, "heartbeat_age_ms", "map_int64"),
        (4, "quorum_id", "int64"),
        (5, "draining", "rep_string"),
        (6, "replica_step", "map_int64"),
        (7, "last_commit_ts_ms", "map_int64"),
        (8, "replica_state", "map_string"),
        (9, "straggler_state", "map_int64"),
        (10, "replica_step_time_ms", "map_int64"),
        (11, "replica_slowness_permille", "map_int64"),
    ],
    "RegionInfo": [
        (1, "region", "string"),
        (2, "child_epoch", "int64"),
        (3, "seq", "int64"),
        (4, "replicas_total", "int64"),
        (5, "replicas_fresh", "int64"),
        (6, "last_push_age_ms", "int64"),
        (7, "stale", "bool"),
        (8, "ledger_compute_seconds", "double"),
        (9, "goodput_ratio", "double"),
        (10, "alerts_active", "int64"),
    ],
    "LighthouseRegionsResponse": [
        (1, "role", "string"),
        (2, "region", "string"),
        (3, "regions", "rep_msg:RegionInfo"),
    ],
}

_DEFAULTS = {
    "int64": 0,
    "uint64": 0,
    "bool": False,
    "string": "",
    "bytes": b"",
    "double": 0.0,
}
_DOUBLE = struct.Struct("<d")
_ZERO64 = bytes(8)
_MASK64 = (1 << 64) - 1


def _default(kind: str) -> Any:
    if kind.startswith("rep_"):
        return []
    if kind.startswith("map_"):
        return {}
    if kind.startswith("msg:"):
        return None
    return _DEFAULTS[kind]


class Message(dict):
    """One message of :data:`SCHEMAS`: a dict holding every field (absent
    ones at their default, an absent nested message as ``None``), also
    readable as attributes.  Nested dicts given to the constructor
    become messages of their field's type."""

    NAME = ""

    def __init__(self, **fields: Any) -> None:
        schema = SCHEMAS[self.NAME]
        super().__init__((name, _default(kind)) for _, name, kind in schema)
        unknown = set(fields) - set(self)
        if unknown:
            raise ValueError(f"{self.NAME} has no field(s) {sorted(unknown)}")
        kinds = {name: kind for _, name, kind in schema}
        for name, value in fields.items():
            kind = kinds[name]
            if kind.startswith("msg:") and value is not None:
                value = _as_message(kind[4:], value)
            elif kind.startswith("rep_msg:"):
                value = [_as_message(kind[8:], v) for v in value]
            elif kind.startswith(("rep_", "map_")):
                value = type(_default(kind))(value)
            self[name] = value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"{self.NAME} has no field {name!r}") from None

    def SerializeToString(self) -> bytes:  # noqa: N802 - protobuf's name
        return encode(self.NAME, self)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":  # noqa: N802 - protobuf's name
        return decode(cls.NAME, data)


# One Message subclass a schema, by name (``MESSAGES["Quorum"]``).
MESSAGES: Dict[str, type] = {
    name: type(name, (Message,), {"NAME": name, "__doc__": f"``{name}`` of proto/tpuft.proto."})
    for name in SCHEMAS
}
Quorum = MESSAGES["Quorum"]
QuorumMember = MESSAGES["QuorumMember"]


def _as_message(name: str, value: Any) -> Message:
    if isinstance(value, MESSAGES[name]):
        return value
    return MESSAGES[name](**dict(value))


def _varint(v: int) -> bytes:
    v &= _MASK64  # negative int64 -> two's complement, 10 bytes
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data) or shift >= 70:
            raise ValueError("truncated or overlong varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _int64(u: int) -> int:
    u &= _MASK64
    return u - (1 << 64) if u >= 1 << 63 else u


def _len_field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def encode(message: str, fields: Dict[str, Any]) -> bytes:
    """Canonical proto3 bytes of ``message`` with the given field values
    (absent fields take their default and are omitted).  Nested messages
    may be given as dicts."""
    schema = SCHEMAS[message]
    known = {name for _, name, _ in schema}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"{message} has no field(s) {sorted(unknown)}")
    out = bytearray()
    for num, name, kind in schema:
        value = fields.get(name)
        if value is None:
            continue
        if kind in ("int64", "uint64"):
            if value:
                out += _varint(num << 3) + _varint(int(value))
        elif kind == "bool":
            if value:
                out += _varint(num << 3) + b"\x01"
        elif kind == "string":
            if value:
                out += _len_field(num, value.encode())
        elif kind == "bytes":
            if value:
                out += _len_field(num, bytes(value))
        elif kind == "double":
            raw = _DOUBLE.pack(float(value))
            if raw != _ZERO64:  # -0.0 is not the default: written
                out += _varint(num << 3 | 1) + raw
        elif kind == "rep_int64":
            if len(value):
                out += _len_field(num, b"".join(_varint(int(v)) for v in value))
        elif kind == "rep_double":
            if len(value):
                out += _len_field(num, b"".join(_DOUBLE.pack(float(v)) for v in value))
        elif kind == "rep_string":
            for v in value:
                out += _len_field(num, v.encode())
        elif kind.startswith("msg:"):
            out += _len_field(num, encode(kind[4:], value))
        elif kind.startswith("rep_msg:"):
            for v in value:
                out += _len_field(num, encode(kind[8:], v))
        elif kind in ("map_int64", "map_string"):
            for key in sorted(value):
                v = value[key]
                entry = _len_field(1, key.encode())
                if kind == "map_int64":
                    entry += _varint(2 << 3) + _varint(int(v))
                else:
                    entry += _len_field(2, v.encode())
                out += _len_field(num, entry)
        else:  # pragma: no cover - schema typo
            raise AssertionError(kind)
    return bytes(out)


def _fields(data: bytes):
    """Yields (field number, wire type, varint or payload) of every field."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            raw, pos = _read_varint(data, pos)
        elif wt == 2:
            n, pos = _read_varint(data, pos)
            if pos + n > len(data):
                raise ValueError("truncated length-delimited field")
            raw, pos = data[pos:pos + n], pos + n
        elif wt in (1, 5):
            width = 8 if wt == 1 else 4
            if pos + width > len(data):
                raise ValueError("truncated fixed-width field")
            raw, pos = data[pos:pos + width], pos + width
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield num, wt, raw


def _map_entry(kind: str, payload: bytes) -> Tuple[str, Any]:
    key, value = "", 0 if kind == "map_int64" else ""
    for num, wt, raw in _fields(payload):
        if num == 1 and wt == 2:
            key = raw.decode()
        elif num == 2 and kind == "map_int64" and wt == 0:
            value = _int64(raw)
        elif num == 2 and kind == "map_string" and wt == 2:
            value = raw.decode()
    return key, value


def decode(message: str, data: bytes) -> Message:
    """Parses ``data`` as ``message``; every schema field is present in the
    result (defaults for absent ones, lists for repeated ones, dicts for
    maps, ``None`` for an absent nested message)."""
    schema = SCHEMAS[message]
    by_num = {num: (name, kind) for num, name, kind in schema}
    out = MESSAGES[message]()
    for num, wt, raw in _fields(bytes(data)):
        if num not in by_num:
            continue
        name, kind = by_num[num]
        if kind == "int64" and wt == 0:
            out[name] = _int64(raw)
        elif kind == "uint64" and wt == 0:
            out[name] = raw & _MASK64
        elif kind == "bool" and wt == 0:
            out[name] = bool(raw)
        elif kind == "string" and wt == 2:
            out[name] = raw.decode()
        elif kind == "bytes" and wt == 2:
            out[name] = raw
        elif kind == "double" and wt == 1:
            out[name] = _DOUBLE.unpack(raw)[0]
        elif kind == "rep_int64" and wt == 2:
            p = 0
            while p < len(raw):
                v, p = _read_varint(raw, p)
                out[name].append(_int64(v))
        elif kind == "rep_int64" and wt == 0:
            out[name].append(_int64(raw))
        elif kind == "rep_double" and wt == 2:
            if len(raw) % 8:
                raise ValueError(f"{message}.{name}: packed doubles of {len(raw)} bytes")
            out[name].extend(v for (v,) in _DOUBLE.iter_unpack(raw))
        elif kind == "rep_double" and wt == 1:
            out[name].append(_DOUBLE.unpack(raw)[0])
        elif kind == "rep_string" and wt == 2:
            out[name].append(raw.decode())
        elif kind.startswith("msg:") and wt == 2:
            out[name] = decode(kind[4:], raw)
        elif kind.startswith("rep_msg:") and wt == 2:
            out[name].append(decode(kind[8:], raw))
        elif kind in ("map_int64", "map_string") and wt == 2:
            key, value = _map_entry(kind, raw)
            out[name][key] = value
        else:
            raise ValueError(f"{message}.{name}: wire type {wt} does not match {kind}")
    return out
