"""State-dict (de)serialization shared by the checkpoint transports.

The frame layout is the JAX package's (``torchft_tpu/checkpointing/
serialization.py``): an 8-byte little-endian header length, the pickled
header, then every tensor's raw contiguous bytes in flatten order.  The
header carries the port's own metadata (a tree spec of plain Python
values), since the JAX header pickles a JAX tree spec.

Flatten order also follows JAX's tree flattening, so the same arrays give
the same body bytes in both packages: a ``dict`` is walked in sorted key
order, an ``OrderedDict`` (what ``nn.Module.state_dict`` returns) in
insertion order, lists and tuples in order.  Tensors become buffers; every
other value (numbers, strings, ``None``) rides pickled in the header.

Flattening copies every tensor to host memory, so the result is a snapshot
that later in-place updates (optimizer steps) cannot change.
"""

from __future__ import annotations

import io
import pickle
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = [
    "StateDictMeta",
    "flatten_state_dict",
    "unflatten_state_dict",
    "write_state_dict",
    "read_state_dict",
]


@dataclass
class StateDictMeta:
    """Header of one serialized state dict."""

    step: int
    spec: Any = None
    # Per leaf in flatten order: ("tensor", buffer index) or ("obj", value).
    leaves: List[Tuple[str, Any]] = field(default_factory=list)
    # Per buffer: (shape, dtype name, nbytes).
    tensors: List[Tuple[Tuple[int, ...], str, int]] = field(default_factory=list)


def _dict_keys(d: dict) -> list:
    if isinstance(d, OrderedDict):
        return list(d)
    return sorted(d)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a flat uint8 array."""
    t = t.detach()
    host = t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
    return host.contiguous().reshape(-1).view(torch.uint8).numpy()


def flatten_state_dict(state_dict: Any, step: int = 0) -> Tuple[StateDictMeta, List[np.ndarray]]:
    """(header, host buffers) of a nested dict/list/tuple of tensors and
    plain values.  Every buffer is a fresh host copy."""
    meta = StateDictMeta(step=step)
    buffers: List[np.ndarray] = []

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            keys = _dict_keys(node)
            kind = "odict" if isinstance(node, OrderedDict) else "dict"
            return (kind, keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return ("list" if isinstance(node, list) else "tuple", None, [walk(c) for c in node])
        if isinstance(node, torch.Tensor):
            buf = _host_bytes(node)
            meta.leaves.append(("tensor", len(buffers)))
            meta.tensors.append(
                (tuple(node.shape), str(node.dtype).removeprefix("torch."), buf.nbytes)
            )
            buffers.append(buf)
        else:
            meta.leaves.append(("obj", node))
        return ("leaf", None, None)

    meta.spec = walk(state_dict)
    return meta, buffers


def _tensor(buf, shape: Tuple[int, ...], dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    if len(buf) == 0:
        return torch.empty(shape, dtype=dtype)
    u8 = torch.frombuffer(buf, dtype=torch.uint8)
    return u8.view(dtype).reshape(shape)


def unflatten_state_dict(meta: StateDictMeta, buffers: List[Any]) -> Any:
    """Rebuilds the nested structure; tensors come back on the CPU, viewing
    ``buffers`` (each a writable bytes-like object)."""
    leaves = iter(meta.leaves)

    def build(spec: Any) -> Any:
        kind, keys, children = spec
        if kind == "leaf":
            what, value = next(leaves)
            if what == "obj":
                return value
            shape, dtype_name, _ = meta.tensors[value]
            return _tensor(buffers[value], shape, dtype_name)
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        if kind == "odict":
            return OrderedDict(zip(keys, built))
        return built if kind == "list" else tuple(built)

    return build(meta.spec)


def state_dict_prefix(meta: StateDictMeta) -> bytes:
    header = pickle.dumps(meta)
    return len(header).to_bytes(8, "little") + header


def write_state_dict(meta: StateDictMeta, buffers: List[np.ndarray], stream: io.RawIOBase) -> None:
    stream.write(state_dict_prefix(meta))
    for buf in buffers:
        stream.write(memoryview(buf))


def read_exact(stream: Any, n: int) -> bytearray:
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        r = stream.readinto(view[got:])
        if not r:
            raise EOFError(f"stream ended after {got}/{n} bytes")
        got += r
    return out


def read_state_dict(stream: Any) -> Tuple[StateDictMeta, List[bytearray]]:
    """Reads one frame: (header, raw buffers).  Unpickles the header, so
    read only streams from this program's own peers."""
    header_len = int.from_bytes(read_exact(stream, 8), "little")
    meta: StateDictMeta = pickle.loads(read_exact(stream, header_len))
    return meta, [read_exact(stream, nbytes) for _, _, nbytes in meta.tensors]
