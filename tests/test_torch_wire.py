"""The port's hand-written proto3 codec against the JAX package's generated
protobuf module: byte-identical encodings for every message it speaks
(maps in the runtime's deterministic order), and round trips."""

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
    "QuorumMember": {
        "replica_id": "g0:4f1c", "address": "http://h:1", "store_address": "h:2",
        "step": -3, "world_size": (1 << 64) - 1, "shrink_only": True, "data": '{"r": "é"}',
    },
    "Quorum": {
        "quorum_id": 9, "created_ms": 1_760_000_000_000,
        "participants": [{"replica_id": "a", "step": 4, "world_size": 2}, {},
                         {"replica_id": "b", "data": "x"}],
    },
    "LighthouseQuorumRequest": {
        "requester": {"replica_id": "g1:x", "address": "a:1", "step": 1 << 33},
        "trace_id": "0/g1:x#12",
    },
    "LighthouseQuorumResponse": {
        "quorum": {"quorum_id": -2, "participants": [{"replica_id": "z"}]},
    },
    "LighthouseHeartbeatRequest": {
        "replica_id": "g0:a", "step": 11, "state": "step", "step_time_ms_ewma": 52.5,
        "step_time_ms_last": -0.0, "allreduce_gb_per_s": 1e-300, "trace_id": "t#1",
        "ec_shards_held": 3, "ec_shard_step": -1, "ec_k": 2, "link_recv_gbps": float("inf"),
        "link_send_gbps": 2.5, "link_hop_rtt_ms": 0.125, "goodput_ratio": 0.9375,
        "ledger_compute_seconds": 1234.5, "ledger_lost_seconds": [0.0, 1.5, -2.25, 1e9],
    },
    "LighthouseHeartbeatResponse": {},
    "LeaderInfo": {"leader_address": "10.0.0.9:29510", "leader_http_address": "http://h:2",
                   "leader_epoch": 7, "lease_expires_ms": -1},
    "LighthouseReplicateResponse": {"applied": True, "leader_epoch": 5},
    "LighthouseLeaderInfoResponse": {"leader": {"leader_epoch": 3}, "role": 1},
    "LighthouseStatusResponse": {
        "prev_quorum": {"quorum_id": 4, "participants": [{"replica_id": "a"}]},
        "pending_participants": [{"replica_id": "p", "step": 2}],
        "heartbeat_age_ms": {"b": 0, "a": -5, "é": 1 << 40}, "quorum_id": 4,
        "draining": ["x", ""], "replica_step": {"a": 9}, "last_commit_ts_ms": {"a": 1},
        "replica_state": {"a": "step", "b": ""}, "straggler_state": {"a": 2},
        "replica_step_time_ms": {"a": 50}, "replica_slowness_permille": {"a": 1500, "c": 0},
    },
    "RegionInfo": {"region": "r0", "child_epoch": 2, "seq": 17, "replicas_total": 3,
                   "replicas_fresh": 2, "last_push_age_ms": 120, "stale": True,
                   "ledger_compute_seconds": 9.75, "goodput_ratio": 0.5, "alerts_active": 1},
    "LighthouseRegionsResponse": {
        "role": "root", "region": "", "regions": [{"region": "r0"}, {"region": "r1",
                                                                      "stale": True}],
    },
}


@pytest.fixture(scope="module")
def pb2():
    return import_reference("torchft_tpu.proto.tpuft_pb2")


def test_samples_cover_every_schema() -> None:
    assert set(SAMPLES) == set(_wire.SCHEMAS)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_encoding_matches_protobuf(pb2, name: str) -> None:
    fields = SAMPLES[name]
    want = getattr(pb2, name)(**fields).SerializeToString(deterministic=True)
    assert _wire.encode(name, fields) == want
    assert _wire.MESSAGES[name](**fields).SerializeToString() == want
    # Defaults only: both encode to nothing.
    assert _wire.encode(name, {}) == getattr(pb2, name)().SerializeToString() == b""


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_decoding_round_trips(pb2, name: str) -> None:
    fields = SAMPLES[name]
    raw = getattr(pb2, name)(**fields).SerializeToString()
    decoded = _wire.decode(name, raw)
    want = _wire.MESSAGES[name](**fields)
    for key in fields:
        assert decoded[key] == want[key], key
        assert getattr(decoded, key) == want[key], key
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
