"""Hand-written proto3 codec for the messages the port's Python side speaks.

The native core's RPC payloads are ``proto/tpuft.proto`` messages.  The JAX
package builds them with the generated ``tpuft_pb2`` module, which needs the
``google.protobuf`` package; the port keeps to the standard library.  The
encoding is canonical proto3, as the protobuf runtime emits it: fields in
field-number order, default values omitted, ``int64`` as a two's-complement
varint, repeated ``int64`` packed.  Decoding also accepts unpacked repeated
scalars and skips unknown fields, as proto3 parsers must.

Only the messages in :data:`SCHEMAS` are covered (``proto/tpuft.proto``,
Manager and Store services, and the lighthouse's Evict and Drain methods).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

# message name -> [(field number, field name, kind)], field-number order.
# kind: int64 | bool | string | bytes | rep_int64 | rep_string
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
}

_DEFAULTS = {
    "int64": 0,
    "bool": False,
    "string": "",
    "bytes": b"",
}

_MASK64 = (1 << 64) - 1


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
    (absent fields take their default and are omitted)."""
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
        if kind == "int64":
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
        elif kind == "rep_int64":
            if len(value):
                out += _len_field(num, b"".join(_varint(int(v)) for v in value))
        elif kind == "rep_string":
            for v in value:
                out += _len_field(num, v.encode())
        else:  # pragma: no cover - schema typo
            raise AssertionError(kind)
    return bytes(out)


def decode(message: str, data: bytes) -> Dict[str, Any]:
    """Parses ``data`` as ``message``; every schema field is present in the
    result (defaults for absent ones, lists for repeated ones)."""
    schema = SCHEMAS[message]
    by_num = {num: (name, kind) for num, name, kind in schema}
    out: Dict[str, Any] = {}
    for _, name, kind in schema:
        out[name] = [] if kind.startswith("rep_") else _DEFAULTS[kind]
    pos = 0
    data = bytes(data)
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            raw, pos = _read_varint(data, pos)
            payload = None
        elif wt == 2:
            n, pos = _read_varint(data, pos)
            if pos + n > len(data):
                raise ValueError("truncated length-delimited field")
            payload, pos = data[pos:pos + n], pos + n
        elif wt == 1:
            pos += 8
            continue
        elif wt == 5:
            pos += 4
            continue
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if pos > len(data):
            raise ValueError("truncated fixed-width field")
        if num not in by_num:
            continue
        name, kind = by_num[num]
        if kind == "int64" and wt == 0:
            out[name] = _int64(raw)
        elif kind == "bool" and wt == 0:
            out[name] = bool(raw)
        elif kind == "string" and wt == 2:
            out[name] = payload.decode()
        elif kind == "bytes" and wt == 2:
            out[name] = payload
        elif kind == "rep_int64" and wt == 2:
            p = 0
            while p < len(payload):
                v, p = _read_varint(payload, p)
                out[name].append(_int64(v))
        elif kind == "rep_int64" and wt == 0:
            out[name].append(_int64(raw))
        elif kind == "rep_string" and wt == 2:
            out[name].append(payload.decode())
        else:
            raise ValueError(f"{message}.{name}: wire type {wt} does not match {kind}")
    return out
