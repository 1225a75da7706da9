"""Per-buffer integrity checksums for the checkpoint and shard wire paths.

The counterpart of ``torchft_tpu/checkpointing/integrity.py``.  A heal
installs fetched bytes straight into live weights, so a torn or corrupted
HTTP stream (a donor killed mid-write, a truncating proxy, flipped bits)
must fail the fetch instead of installing garbage.  Every serialized
buffer and every erasure shard therefore carries a checksum computed when
the snapshot is flattened (or the shard encoded) and verified on receipt.

CRC32C (Castagnoli) through ``google_crc32c`` where that package is
installed, otherwise ``zlib.crc32``; both run at C speed and release the
GIL on large buffers.  The algorithm's tag travels with every checksum, so
the verifier applies the algorithm the producer used.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CRC_ALGO", "checksum", "checksum_buffers", "verify"]

try:  # pragma: no cover - whichever backend the host has
    import google_crc32c as _crc32c_mod

    def _crc32c(data) -> int:
        # The C extension takes read-only bytes only.
        if not isinstance(data, bytes):
            data = bytes(data)
        return int(_crc32c_mod.value(data))

    CRC_ALGO = "crc32c"
except ImportError:  # pragma: no cover
    _crc32c_mod = None

    def _crc32c(data) -> int:
        return zlib.crc32(data) & 0xFFFFFFFF

    CRC_ALGO = "crc32"

_ALGOS = {
    "crc32c": _crc32c,
    "crc32": lambda data: zlib.crc32(data) & 0xFFFFFFFF,
}


def _bytes_view(data):
    if isinstance(data, np.ndarray):
        from torchft_tpu_torch.checkpointing.serialization import as_u8

        return memoryview(as_u8(data))
    return data


def checksum(data, algo: str = CRC_ALGO) -> int:
    """Checksum of a bytes-like payload or numpy array under ``algo``."""
    return _ALGOS[algo](_bytes_view(data))


def checksum_buffers(buffers: Sequence[np.ndarray]) -> Tuple[str, List[int]]:
    """(algorithm, one checksum a buffer) of a flattened state dict: stamped
    into its header once a snapshot, verified by every receiver."""
    return CRC_ALGO, [checksum(b) for b in buffers]


def verify(data, expect: int, algo: Optional[str], what: str) -> None:
    """Raises IOError naming ``what`` when the payload does not hash to
    ``expect``; an unknown algorithm fails too, since an unverifiable
    checksum cannot be told from a corrupt stream."""
    algo = algo or CRC_ALGO
    fn = _ALGOS.get(algo)
    if fn is None:
        raise IOError(f"{what}: unknown checksum algorithm {algo!r}")
    got = fn(_bytes_view(data))
    if got != expect:
        raise IOError(
            f"{what}: checksum mismatch ({algo} {got:#010x} != expected "
            f"{expect:#010x}) - stream torn or corrupted"
        )
