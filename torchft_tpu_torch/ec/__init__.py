"""Erasure-coded peer state: donor-free healing.

The counterpart of ``torchft_tpu/ec/``.  After a committed step the HTTP
transport's background snapshotter also encodes the canonical serialized
state stream into ``k + m`` systematic Reed-Solomon shards over GF(256)
(host numpy, bit for bit the JAX package's) and spreads them across the
replica groups: a deterministic placement rotated each step, parity pushed
over checksummed HTTP.  A recovering group whose donors are unreachable,
or whose donor fetch fails, rebuilds the max-step state from any ``k``
surviving shard holders instead (``TPUFT_EC_MODE=prefer``: first).

Modules: :mod:`~torchft_tpu_torch.ec.gf` (GF(256) tables and matrix
algebra), :mod:`~torchft_tpu_torch.ec.encoder` (the shard codec and its
wire frames), :mod:`~torchft_tpu_torch.ec.placement` (shard to group), and
:mod:`~torchft_tpu_torch.ec.store` (the shard store, the HTTP client, the
any-k reconstruction and the Manager-facing :class:`ECPlane`).
"""

from torchft_tpu_torch.ec.encoder import Shard, decode_stream, encode_stream
from torchft_tpu_torch.ec.placement import shard_holder, shards_for_holder
from torchft_tpu_torch.ec.store import ECConfig, ECPlane, ShardStore, reconstruct

__all__ = [
    "ECConfig",
    "ECPlane",
    "Shard",
    "ShardStore",
    "decode_stream",
    "encode_stream",
    "reconstruct",
    "shard_holder",
    "shards_for_holder",
]
