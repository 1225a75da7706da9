"""torchft_tpu_torch — the PyTorch/CUDA port of tpu-ft.

Per-step fault tolerance for PyTorch training on NVIDIA Hopper: a Manager
that forms a quorum of replica groups every step, averages gradients across
them over a reconfigurable TCP ring, heals a group that fell behind from a
healthy peer over HTTP, and gates every optimizer step on a commit vote.
The model's hot ops run as hand-written CUDA kernels for ``sm_90a``.

Around that loop: durable disk checkpoints and a stateful data loader for
a job that restarts cold (``checkpointing.disk``, ``data``), a second heal
transport over the collective's send and recv, a crash-isolated collective
whose communicator runs in a child process (``baby``), and a parameter
server (``parameter_server``).  The control plane: a lighthouse group kept
available by a lease in a shared file with continuous replication to warm
standbys (``ha``), regional lighthouses under a root (``federation``),
their CLI (``lighthouse_cli``), a store CLI (``store_cli``), the raw
coordination API (``coordination``), and a lighthouse client that fails
over across an address list.  In-group parallelism: a group's local
ranks bootstrap one ``torch.distributed`` world (``multihost``) and shard
the model over a mesh of "data", "fsdp" and "tensor" axes as DTensors
(``parallel.mesh``, ``parallel.sharding``, ``models.parallelize``,
``data.shard_batch``), and each rank averages and heals its own shards
across groups (``examples/train_hsdp.py``).  Not ported yet: long
context, MoE and the pipeline (the mesh's other axes), the TPU JobSet spec
(``spec.py``) and the metrics linter (ROADMAP queue 1).

The JAX package ``torchft_tpu`` is the reference; this package imports
nothing of it, and speaks the same wire to the same native coordination
core (``native/``).
"""

from torchft_tpu_torch.collectives import (
    Collective,
    DummyCollective,
    ErrorSwallowingCollective,
    ManagedCollective,
    TCPCollective,
)
from torchft_tpu_torch.ddp import GradientAverager
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import Optimizer

__all__ = [
    "Collective",
    "DummyCollective",
    "ErrorSwallowingCollective",
    "GradientAverager",
    "ManagedCollective",
    "Manager",
    "Optimizer",
    "TCPCollective",
]
