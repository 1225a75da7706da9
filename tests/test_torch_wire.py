"""The port's hand-written proto3 codec against the JAX package's generated
protobuf module: byte-identical encodings for every message it speaks, and
round trips."""

from __future__ import annotations

import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch import _wire

# A value for every field, with the edge cases proto3 cares about:
# negative int64 (10-byte varint), non-ASCII strings, empty repeated
# fields next to full ones, binary bytes.
SAMPLES = {
    "ManagerQuorumRequest": {
        "group_rank": 3, "step": 1 << 40, "checkpoint_metadata": "http://h:1/é",
        "shrink_only": True, "init_sync": True, "commit_failures": 2, "trace_id": "g/r#7",
    },
    "ManagerQuorumResponse": {
        "quorum_id": 17, "store_address": "127.0.0.1:29500", "max_step": 12,
        "max_replica_rank": -1, "max_world_size": 2, "replica_rank": 1,
        "replica_world_size": 3, "heal": True, "recover_src_manager_address": "a:1",
        "recover_src_replica_rank": 0, "recover_dst_replica_ranks": [1, 2],
        "recover_src_replica_ranks": [0, 300], "recover_src_manager_addresses": ["a:1", "b:2"],
        "recover_dst_replica_ranks_all": [], "participant_replica_ranks": [0, 1, 2],
        "participant_manager_addresses": ["a:1", "", "c:3"],
    },
    "CheckpointMetadataRequest": {"group_rank": 1, "trace_id": "t"},
    "CheckpointMetadataResponse": {"checkpoint_metadata": "http://x:9"},
    "ShouldCommitRequest": {"group_rank": 0, "step": 5, "should_commit": True, "trace_id": "z"},
    "ShouldCommitResponse": {"should_commit": True},
    "StoreSetRequest": {"key": "tpuft/3/0/rank_1", "value": b"\x00\xffhost:1"},
    "StoreSetResponse": {},
    "StoreGetRequest": {"key": "k", "wait": True},
    "StoreGetResponse": {"found": True, "value": b"\x01\x02"},
    "StoreAddRequest": {"key": "n", "delta": -5},
    "StoreAddResponse": {"value": -123456789012},
    "StoreDeleteRequest": {"key": "gone"},
    "StoreDeleteResponse": {},
    "LighthouseEvictRequest": {"replica_prefix": "1"},
    "LighthouseEvictResponse": {"evicted": 3},
    "LighthouseDrainRequest": {"replica_prefix": "2:4f1c-é", "deadline_ms": -1,
                               "trace_id": "g/2#9"},
    "LighthouseDrainResponse": {"drained": 2},
}


@pytest.fixture(scope="module")
def pb2():
    return import_reference("torchft_tpu.proto.tpuft_pb2")


def test_samples_cover_every_schema() -> None:
    assert set(SAMPLES) == set(_wire.SCHEMAS)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_encoding_matches_protobuf(pb2, name: str) -> None:
    fields = SAMPLES[name]
    want = getattr(pb2, name)(**fields).SerializeToString()
    assert _wire.encode(name, fields) == want
    # Defaults only: both encode to nothing.
    assert _wire.encode(name, {}) == getattr(pb2, name)().SerializeToString() == b""


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_decoding_round_trips(pb2, name: str) -> None:
    fields = SAMPLES[name]
    raw = getattr(pb2, name)(**fields).SerializeToString()
    decoded = _wire.decode(name, raw)
    for key, value in fields.items():
        assert decoded[key] == value, key
    assert _wire.decode(name, _wire.encode(name, fields)) == decoded
    # And the protobuf runtime parses the port's bytes back to the message.
    msg = getattr(pb2, name)()
    msg.ParseFromString(_wire.encode(name, fields))
    assert msg == getattr(pb2, name)(**fields)


def test_decoder_accepts_unpacked_repeated_and_skips_unknown_fields() -> None:
    # field 11 (recover_dst_replica_ranks) as two unpacked varints, then an
    # unknown field 99 (varint) and an unknown field 98 (length-delimited).
    raw = bytes([11 << 3, 4, 11 << 3, 5]) + bytes([0x98, 0x06, 1]) + bytes([0x92, 0x06, 2, 0, 0])
    out = _wire.decode("ManagerQuorumResponse", raw)
    assert out["recover_dst_replica_ranks"] == [4, 5]
    assert out["quorum_id"] == 0


def test_encoder_rejects_unknown_fields() -> None:
    with pytest.raises(ValueError, match="no field"):
        _wire.encode("StoreGetRequest", {"key": "k", "wiat": True})
