"""Low-level coordination API: the native bindings' public surface, for
users who build their own fault-tolerance logic on the raw quorum,
heartbeat and store primitives.

The port of ``torchft_tpu/coordination.py``: the same names, the port's
own classes.  ``Quorum`` and ``QuorumMember`` are the port's wire types
(:class:`torchft_tpu_torch._wire.Message`s, read by attribute or key), where
the JAX package exports its generated protobuf classes.
"""

from torchft_tpu_torch._native import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
    QuorumResult,
    StoreClient,
    StoreServer,
)
from torchft_tpu_torch._wire import Quorum, QuorumMember

__all__ = [
    "LighthouseClient",
    "LighthouseServer",
    "ManagerClient",
    "ManagerServer",
    "Quorum",
    "QuorumMember",
    "QuorumResult",
    "StoreClient",
    "StoreServer",
]
