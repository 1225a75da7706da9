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

A ``DTensor`` leaf (a parameter or optimizer state on an in-group mesh)
serializes its **local shard** only; its leaf records ``("dtensor",
(buffer index, layout))``, the layout being the mesh's dim names and shape,
the placements and the global shape (:func:`dtensor_layout`).  Frames
without DTensors are byte for byte what they were before DTensors were
supported.  :func:`sharding_restorer` rebuilds each such leaf with
``DTensor.from_local`` on its live twin's mesh, so every local rank heals
or resumes its own shards; a layout that differs from the twin's raises
(nothing is resharded: a rank holds only its shard, where a JAX process
holds the global array and can lay it onto any mesh).

The header may carry one checksum a buffer (``crc_algo``, ``crcs``; the
HTTP transport stamps them), and :func:`read_state_dict` verifies each
buffer as it lands.  Headers are read with a restricted unpickler
(:func:`safe_loads`) that builds builtins, ``collections.OrderedDict`` and
this module's :class:`StateDictMeta` only: a JAX package frame, whose
header pickles a JAX tree spec and ``ml_dtypes`` dtypes, raises
:class:`ForeignFrameError` without importing anything, so healing across
the two packages fails fast instead of importing ``jax`` into the port.
"""

from __future__ import annotations

import io
import pickle
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.checkpointing.integrity import verify

__all__ = [
    "ForeignFrameError",
    "StateDictMeta",
    "as_u8",
    "dtensor_layout",
    "flatten_state_dict",
    "read_exact",
    "read_exact_into",
    "read_header",
    "read_state_dict",
    "safe_loads",
    "sharding_restorer",
    "state_dict_frames",
    "unflatten_state_dict",
    "write_state_dict",
]


class ForeignFrameError(RuntimeError):
    """A pickled header names a class this package does not build: the
    frame came from another program (the JAX package's own header), and
    reading it would import that program's modules."""


# The only globals a header may name: plain containers and scalars, the
# ordered dict of module state dicts, and this module's header class.
_SAFE_GLOBALS = {
    ("builtins", name) for name in (
        "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset", "int",
        "list", "range", "set", "slice", "str", "tuple",
    )
} | {("collections", "OrderedDict"), (__name__, "StateDictMeta")}


class _HeaderUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if (module, name) not in _SAFE_GLOBALS:
            raise ForeignFrameError(
                f"checkpoint header names {module}.{name}: not a frame of this package "
                "(healing across the JAX package and the port is not supported)"
            )
        return super().find_class(module, name)


def safe_loads(data: Any) -> Any:
    """Unpickles a header, chunk prefix or shard header received from a
    peer, admitting only builtins, ``OrderedDict`` and :class:`StateDictMeta`."""
    return _HeaderUnpickler(io.BytesIO(bytes(data))).load()


def as_u8(arr: np.ndarray) -> np.ndarray:
    """A flat uint8 view of a contiguous numpy array (0-d included)."""
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    return arr.view(np.uint8).reshape(-1)


@dataclass
class StateDictMeta:
    """Header of one serialized state dict."""

    step: int
    spec: Any = None
    # Per leaf in flatten order: ("tensor", buffer index), ("dtensor",
    # (buffer index, layout)) or ("obj", value).
    leaves: List[Tuple[str, Any]] = field(default_factory=list)
    # Per buffer: (shape, dtype name, nbytes).
    tensors: List[Tuple[Tuple[int, ...], str, int]] = field(default_factory=list)
    # One checksum a buffer (integrity.py), stamped by the HTTP transport's
    # snapshotter and verified by every receiver; None in frames without.
    crc_algo: Optional[str] = None
    crcs: Optional[Tuple[int, ...]] = None

    @property
    def buffer_nbytes(self) -> List[int]:
        """Each buffer's byte size, in buffer order (what a chunk reader
        preallocates)."""
        return [nbytes for _, _, nbytes in self.tensors]


def _dict_keys(d: dict) -> list:
    if isinstance(d, OrderedDict):
        return list(d)
    return sorted(d)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a flat uint8 array."""
    t = t.detach()
    host = t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
    return host.contiguous().reshape(-1).view(torch.uint8).numpy()


def _dtensor_type() -> Any:
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


def _placement_record(p: Any) -> tuple:
    if p.is_shard():
        return ("shard", int(p.dim))
    if p.is_replicate():
        return ("replicate",)
    if p.is_partial():
        return ("partial", str(p.reduce_op))
    raise ValueError(f"unsupported DTensor placement {p!r}")


def dtensor_layout(t: Any) -> Optional[tuple]:
    """(mesh dim names, mesh shape, placements, global shape) of a DTensor
    as plain values, placements as ``("shard", dim)``, ``("replicate",)``
    or ``("partial", op)``; None for any other tensor."""
    dtensor = _dtensor_type()
    if dtensor is None or not isinstance(t, dtensor):
        return None
    mesh = t.device_mesh
    return (tuple(mesh.mesh_dim_names or ()), tuple(int(n) for n in mesh.shape),
            tuple(_placement_record(p) for p in t.placements), tuple(int(n) for n in t.shape))


def flatten_state_dict(state_dict: Any, step: int = 0) -> Tuple[StateDictMeta, List[np.ndarray]]:
    """(header, host buffers) of a nested dict/list/tuple of tensors and
    plain values.  Every buffer is a fresh host copy; a DTensor's is its
    local shard's."""
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
            layout = dtensor_layout(node)
            if layout is not None:
                node = node.to_local()
                meta.leaves.append(("dtensor", (len(buffers), layout)))
            else:
                meta.leaves.append(("tensor", len(buffers)))
            buf = _host_bytes(node)
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
    if isinstance(buf, torch.Tensor):
        u8 = buf.reshape(-1)
    elif len(buf) == 0:
        return torch.empty(shape, dtype=dtype)
    else:
        u8 = torch.frombuffer(buf, dtype=torch.uint8)
    if u8.numel() == 0:
        return torch.empty(shape, dtype=dtype)
    return u8.view(dtype).reshape(shape)


def unflatten_state_dict(meta: StateDictMeta, buffers: List[Any],
                         restore: Optional[Callable[..., torch.Tensor]] = None) -> Any:
    """Rebuilds the nested structure; tensors come back on the CPU, viewing
    ``buffers`` (each a writable bytes-like object or a uint8 tensor).
    ``restore(path, tensor)`` (a :func:`sharding_restorer`) may place each
    tensor, ``path`` being its keys and indices from the root; a DTensor
    leaf's local shard goes as ``restore(path, tensor, layout=...)``
    (without ``restore`` it comes back as that plain local tensor)."""
    leaves = iter(meta.leaves)

    def build(spec: Any, path: tuple) -> Any:
        kind, keys, children = spec
        if kind == "leaf":
            what, value = next(leaves)
            if what == "obj":
                return value
            layout = None
            if what == "dtensor":
                value, layout = value
            shape, dtype_name, _ = meta.tensors[value]
            t = _tensor(buffers[value], shape, dtype_name)
            if restore is None:
                return t
            return restore(path, t) if layout is None else restore(path, t, layout=layout)
        names = keys if keys is not None else range(len(children))
        built = [build(c, path + (k,)) for k, c in zip(names, children)]
        if kind == "dict":
            return dict(zip(keys, built))
        if kind == "odict":
            return OrderedDict(zip(keys, built))
        return built if kind == "list" else tuple(built)

    return build(meta.spec, ())


def _tensor_paths(node: Any, path: tuple, out: Dict[tuple, torch.Tensor]) -> None:
    if isinstance(node, dict):
        for k in _dict_keys(node):
            _tensor_paths(node[k], path + (k,), out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _tensor_paths(c, path + (i,), out)
    elif isinstance(node, torch.Tensor):
        out[path] = node


def sharding_restorer(state_dict_fn: Callable[[], Any]) -> Callable[..., torch.Tensor]:
    """The placement restorer of :func:`unflatten_state_dict`, from the live
    state: each restored tensor lands on the device of its live twin, the
    tensor that ``state_dict_fn()`` (a zero-argument callable, the one a
    Manager or a checkpointer is given) holds at the same path.  Where the
    live state sits under a wrapper (the Manager sends ``{"user": {key:
    state}, "tpuft": ...}``), the twin is the one at the longest trailing
    part of the restored path.  A twin of another dtype or shape raises
    ``ValueError``: nothing is cast.  A tensor with no twin stays on the
    CPU, as without a restorer.

    A DTensor leaf (its local shard and its recorded layout) becomes a
    DTensor again, ``DTensor.from_local`` on its twin's mesh with the
    twin's placements; a recorded layout (mesh dim names and shape,
    placements, global shape) other than the twin's, or a plain leaf whose
    twin is a DTensor or the other way round, raises ``ValueError``:
    nothing is resharded.

    The live state is read once, at the first restored tensor."""
    live: Dict[tuple, torch.Tensor] = {}
    read = [False]

    def restore(path: tuple, t: torch.Tensor, layout: Optional[tuple] = None) -> torch.Tensor:
        if not read[0]:
            read[0] = True
            _tensor_paths(state_dict_fn(), (), live)
        twin = None
        for i in range(len(path)):
            twin = live.get(path[i:])
            if twin is not None:
                break
        if twin is None:
            return t
        where = "/".join(map(str, path))
        twin_layout = dtensor_layout(twin)
        if twin_layout != layout:
            raise ValueError(f"restored tensor at {where} was saved with layout {layout}, its "
                             f"live twin has {twin_layout}: a shard is not resharded")
        local = twin.to_local() if twin_layout is not None else twin
        if local.dtype != t.dtype or tuple(local.shape) != tuple(t.shape):
            raise ValueError(
                f"restored tensor at {where} is {t.dtype} {tuple(t.shape)}, "
                f"its live twin {local.dtype} {tuple(local.shape)}"
            )
        t = t if local.device == t.device else t.to(local.device)
        if twin_layout is None:
            return t
        return _dtensor_type().from_local(t, twin.device_mesh, twin.placements, run_check=False,
                                          shape=twin.shape, stride=twin.stride())

    return restore


def state_dict_frames(meta: StateDictMeta, buffers: List[Any]) -> Tuple[bytes, int]:
    """(the frame's prefix: header length and pickled header, the whole
    frame's length): the one source of the framing, so a Content-Length
    cannot drift from what :func:`write_state_dict` writes."""
    header = pickle.dumps(meta)
    prefix = len(header).to_bytes(8, "little") + header
    return prefix, len(prefix) + sum(int(b.nbytes) for b in buffers)


def write_state_dict(meta: StateDictMeta, buffers: List[np.ndarray], stream: Any,
                     prefix: Optional[bytes] = None) -> None:
    if prefix is None:
        prefix, _ = state_dict_frames(meta, buffers)
    stream.write(prefix)
    for buf in buffers:
        stream.write(memoryview(as_u8(buf)))


def read_exact_into(stream: Any, view: memoryview) -> None:
    """Fills ``view`` from ``stream`` by ``readinto``, so the bytes land in
    the caller's buffer with no copy between."""
    n = len(view)
    got = 0
    while got < n:
        r = stream.readinto(view[got:])
        if not r:
            raise EOFError(f"stream ended after {got}/{n} bytes")
        got += r


def read_exact(stream: Any, n: int) -> bytearray:
    out = bytearray(n)
    read_exact_into(stream, memoryview(out))
    return out


def byte_view(buf: Any) -> memoryview:
    """A writable flat byte view of a receive buffer (a bytearray or a
    uint8 tensor on the CPU, pinned or not)."""
    if isinstance(buf, torch.Tensor):
        return memoryview(buf.numpy()).cast("B")
    return memoryview(buf)


def read_header(stream: Any) -> StateDictMeta:
    header_len = int.from_bytes(read_exact(stream, 8), "little")
    return safe_loads(read_exact(stream, header_len))


def read_state_dict(stream: Any, alloc: Optional[Callable[[int], Any]] = None,
                    stats: Optional[dict] = None) -> Tuple[StateDictMeta, List[Any]]:
    """Reads one frame: (header, raw buffers), each buffer from ``alloc``
    (a bytearray by default) and filled in place.  With checksums in the
    header, each buffer is verified as it lands (IOError on a mismatch),
    and ``stats`` gains ``crc_ms`` and ``crc_verified``; a header of
    another program raises :class:`ForeignFrameError`."""
    meta = read_header(stream)
    buffers = []
    for i, nbytes in enumerate(meta.buffer_nbytes):
        buf = alloc(nbytes) if alloc is not None else bytearray(nbytes)
        view = byte_view(buf)
        read_exact_into(stream, view)
        if meta.crcs is not None:
            t0 = time.monotonic()
            verify(view, meta.crcs[i], meta.crc_algo, f"checkpoint buffer {i}")
            if stats is not None:
                stats["crc_ms"] = stats.get("crc_ms", 0.0) + (time.monotonic() - t0) * 1e3
                stats["crc_verified"] = stats.get("crc_verified", 0) + 1
        buffers.append(buf)
    return meta, buffers
