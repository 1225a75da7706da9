"""The port's state-dict serialization: round trips, and the same body bytes
as the JAX package's flatten_state_dict for the same arrays."""

from __future__ import annotations

import io
from collections import OrderedDict

import ml_dtypes
import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.checkpointing.serialization import (
    flatten_state_dict,
    read_state_dict,
    unflatten_state_dict,
    write_state_dict,
)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": rng.standard_normal((7,)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-5, 5, size=(2, 2)).astype(np.int64),
        "scalar": np.array(3.5, dtype=np.float32),
        "nested": {"b": rng.standard_normal(4).astype(np.float32), "a": np.arange(3, dtype=np.int32)},
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def test_round_trip_with_plain_values() -> None:
    sd = {
        "model": OrderedDict([("z", torch.randn(2, 3)), ("a", torch.arange(4))]),
        "optim": {"state": {0: {"step": torch.tensor(3.0), "m": torch.ones(2, dtype=torch.bfloat16)}},
                  "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.99), "params": [0], "x": None}]},
        "empty": torch.zeros(0, 4),
        "flag": True,
        "name": "step",
    }
    meta, buffers = flatten_state_dict(sd, step=11)
    stream = io.BytesIO()
    write_state_dict(meta, buffers, stream)
    stream.seek(0)
    meta2, buffers2 = read_state_dict(stream)
    assert meta2.step == 11
    out = unflatten_state_dict(meta2, buffers2)
    assert list(out["model"]) == ["z", "a"]  # OrderedDict keeps its order
    assert torch.equal(out["model"]["z"], sd["model"]["z"])
    assert torch.equal(out["model"]["a"], sd["model"]["a"])
    st = out["optim"]["state"][0]
    assert st["step"].shape == () and float(st["step"]) == 3.0
    assert st["m"].dtype == torch.bfloat16 and torch.equal(st["m"], sd["optim"]["state"][0]["m"])
    assert out["optim"]["param_groups"] == sd["optim"]["param_groups"]
    assert out["empty"].shape == (0, 4)
    assert out["flag"] is True and out["name"] == "step"


def test_flatten_copies() -> None:
    w = torch.ones(3)
    meta, buffers = flatten_state_dict({"w": w})
    w.add_(1.0)
    assert torch.equal(unflatten_state_dict(meta, [bytearray(b) for b in buffers])["w"],
                       torch.ones(3))


def test_body_matches_the_jax_serialization() -> None:
    ref = import_reference("torchft_tpu.checkpointing.serialization")
    arrays = _arrays()
    jmeta, jbufs = ref.flatten_state_dict(arrays, step=2)
    meta, bufs = flatten_state_dict(_to_torch(arrays), step=2)
    assert len(bufs) == len(jbufs) == 6
    for mine, theirs in zip(bufs, jbufs):
        assert mine.tobytes() == ref.as_u8(theirs).tobytes()
    # The frames differ only in the pickled header.
    port_stream, jax_stream = io.BytesIO(), io.BytesIO()
    write_state_dict(meta, bufs, port_stream)
    ref.write_state_dict(jmeta, jbufs, jax_stream)
    body = b"".join(b.tobytes() for b in bufs)
    for raw in (port_stream.getvalue(), jax_stream.getvalue()):
        header_len = int.from_bytes(raw[:8], "little")
        assert raw[8 + header_len:] == body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64, torch.bool])
def test_dtypes_round_trip(dtype) -> None:
    t = (torch.arange(6) % 3).to(dtype).reshape(2, 3)
    meta, bufs = flatten_state_dict([t, (t, 7)])
    out = unflatten_state_dict(meta, [bytearray(b) for b in bufs])
    assert isinstance(out, list) and isinstance(out[1], tuple)
    assert out[0].dtype == dtype and torch.equal(out[0], t) and out[1][1] == 7
