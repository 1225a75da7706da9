"""Fault-tolerant HSDP training example: shard inside the group, replicate
across groups, heal sharded state live.

The counterpart of ``examples/train_hsdp.py``.  Each replica group shards
its transformer over its own ``(fsdp x tensor)`` mesh; groups average
gradients through the Manager's fault-tolerant allreduce; a killed group
restarts, heals its SHARDED state (each local rank its own DTensor shards,
placed on its own mesh) from a healthy peer, and rejoins.

The JAX example simulates the group's devices in one process; PyTorch runs
one process a device, so this one, started by the launcher as the group's
process, starts ``--devices`` local ranks itself.  They bootstrap one
``torch.distributed`` world through the group's Store
(``multihost.initialize_slice``: NCCL where each rank has a card of its own,
gloo where they share one or run on the CPU), each with its own Manager.
Each rank dies with the group's process (``PR_SET_PDEATHSIG``), so a
SIGKILL of the group leaves no rank heartbeating for it.  A SIGTERM stops
the group whole (no drain hand-off: ranks that saw a notice at different
steps would part on their in-group collectives).

Run (two supervised groups, each 4 local ranks on the CPU)::

    python -m torchft_tpu_torch.launch --groups 2 --max-restarts 3 -- \\
        python -m torchft_tpu_torch.examples.train_hsdp --device cpu --steps 200

On the card (the default ``--device cuda``) the ranks share the visible
cards round-robin.  With ``--ckpt_dir`` each rank saves and resumes its own
shards under ``group_<g>/rank_<r>``.  At exit rank 0 prints
``FINAL ... params_sha256=... sample_shardings=...``, the checksum over the
gathered parameters: after any number of mid-run kills all groups print the
same one.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List

_PR_SET_PDEATHSIG = 1


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host if host != "localhost" else "127.0.0.1", 0))
        return s.getsockname()[1]


def _say(line: str) -> None:
    """One line in one write: a group's ranks share its log."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _die_with_parent(parent: int) -> None:
    """Runs in each rank between fork and exec: the kernel SIGKILLs the rank
    when the group's process dies, however it dies."""
    ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    if os.getppid() != parent:  # the parent died before the prctl took
        os._exit(1)


def launch_ranks(args: argparse.Namespace, argv: List[str],
                 module: str = "torchft_tpu_torch.examples.train_hsdp") -> int:
    """The group's process: starts one rank a device (``module`` with
    ``argv`` and ``--local-rank r``), forwards SIGTERM, and exits with the
    first failing rank's code (0 when all succeed)."""
    host = os.environ.get("MASTER_ADDR", "localhost")
    env = dict(os.environ, WORLD_SIZE=str(args.devices), TPUFT_NUM_HOSTS=str(args.devices),
               MASTER_ADDR=host, MASTER_PORT=str(_free_port(host)),
               TPUFT_COORD_PORT=str(_free_port(host)))
    env["TPUFT_STORE"] = f"{host}:{env['MASTER_PORT']}"
    parent = os.getpid()
    procs = []
    metrics = env.get("TPUFT_METRICS_PATH")
    for r in range(args.devices):
        env_r = dict(env, RANK=str(r), TPUFT_HOST_RANK=str(r))
        if metrics and r:
            # A Manager's records carry its group's id, not its rank: rank
            # 0 writes the group's stream, each other rank one of its own.
            env_r["TPUFT_METRICS_PATH"] = f"{metrics}.rank{r}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--local-rank", str(r)],
            env=env_r, preexec_fn=lambda: _die_with_parent(parent)))

    def stop(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, stop)
    _say(f"[group {os.environ.get('REPLICA_GROUP_ID', 0)}] local ranks "
         f"pids={[p.pid for p in procs]}")
    rc = 0
    while procs:
        for p in list(procs):
            code = p.poll()
            if code is None:
                continue
            procs.remove(p)
            if code != 0 and rc == 0:
                rc = code
                for q in procs:  # one rank down takes the group down
                    q.kill()
        time.sleep(0.05)
    return rc


def run_rank(args: argparse.Namespace) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch import GradientAverager, Optimizer
    from torchft_tpu_torch.checkpointing.serialization import dtensor_layout
    from torchft_tpu_torch.data import DistributedSampler, shard_batch
    from torchft_tpu_torch.examples._common import (
        TrainGate,
        make_manager,
        params_digest,
        replica_env,
    )
    from torchft_tpu_torch.models import (
        Transformer,
        TransformerConfig,
        flagship_config,
        parallelize,
    )
    from torchft_tpu_torch.models.transformer import param_axes
    from torchft_tpu_torch.multihost import initialize_slice
    from torchft_tpu_torch.ops import launch_counts
    from torchft_tpu_torch.parallel import ft_init_mesh

    rank, n = args.local_rank, args.devices
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        # NCCL refuses two ranks on one device.
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    else:
        dev = torch.device(args.device)
        backend = "gloo"

    if args.model == "flagship":
        cfg, _, seq = flagship_config()
        rows = 256
    else:
        cfg = TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=256, max_seq=64, dtype=torch.float32,  # exact cross-group convergence
        )
        seq, rows = 64, 4096
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    # Synthetic token stream, identical in every process (seeded).
    rng = np.random.default_rng(0)
    dataset = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(rows, seq))).to(dev)

    replica_group, num_groups = replica_env(dev)
    state = {}

    def save():
        return {"model": model.state_dict(), "optim": state["sgd"].state_dict()}

    def load(sd):
        # The transport placed every shard on this rank's own mesh; the
        # copy into the live DTensors is local.
        layouts = {k: dtensor_layout(v) for k, v in sd["model"].items()}
        model.load_state_dict(sd["model"])
        state["sgd"].load_state_dict(sd["optim"])
        fetch = getattr(manager.checkpoint_transport, "last_fetch", None) or {}
        _say(f"[group {replica_group} rank {rank}] healed step={manager.current_step()} "
             f"bytes={fetch.get('bytes')} fetch_s={fetch.get('fetch_s')} "
             f"layouts={json.dumps(layouts)}")

    manager = make_manager(save, load, replica_group, rank=rank, world_size=n,
                           store_port=int(os.environ["MASTER_PORT"]),
                           restore_in_place=True, transport=args.transport)
    initialize_slice(backend=backend)
    fsdp = args.fsdp or max(1, n // 2)
    tensor = args.tensor or max(1, n // fsdp)
    ftmesh = ft_init_mesh({"fsdp": fsdp, "tensor": tensor}, manager=manager,
                          device_type=dev.type)
    parallelize(model, ftmesh)
    state["sgd"] = torch.optim.SGD(model.parameters(), lr=args.lr)
    opt = Optimizer(manager, state["sgd"])
    averager = GradientAverager(manager)
    params = list(model.parameters())

    ckpt = None
    if args.ckpt_dir:
        from torchft_tpu_torch.checkpointing import ManagedDiskCheckpoint

        ckpt = ManagedDiskCheckpoint(
            manager, save, load,
            os.path.join(args.ckpt_dir, f"group_{replica_group}", f"rank_{rank}"),
            every=args.ckpt_every)
        ckpt_step = ckpt.restore()
        if ckpt_step is not None and rank == 0:
            _say(f"[group {replica_group}] resumed from disk checkpoint step={ckpt_step}")

    shard, shards = ftmesh.batch_shard()
    gate = TrainGate(manager, args.steps, require_merged=args.require_merged_final,
                     steps_cap=args.steps_cap)
    try:
        while gate.should_continue():
            opt.zero_grad()
            step = manager.current_step()
            # The group's batch by the static replica group id, then this
            # rank's slice of it.
            sampler = DistributedSampler(len(dataset), replica_group=replica_group,
                                         num_replica_groups=num_groups, shuffle=True, seed=step)
            idx = [i for _, i in zip(range(args.batch), iter(sampler))]
            mine = torch.as_tensor(shard_batch(idx, 0, 1, shard, shards), device=dev)
            tokens = dataset[mine]
            loss = model.loss({"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)})
            loss.backward()
            averager.allreduce([p.grad for p in params])
            committed = opt.step()
            gate.note_commit(committed)
            if ckpt is not None:
                ckpt.maybe_save(committed)
            group_loss = loss.detach().clone()
            dist.all_reduce(group_loss)  # each batch slice counted once a tensor rank
            if rank == 0:
                _say(f"[group {replica_group}] step={step} loss={float(group_loss) / n:.4f} "
                     f"participants={manager.num_participants()} committed={committed}")

        if dev.type == "cuda":
            _say(f"[group {replica_group} rank {rank}] kernel launches "
                 f"{json.dumps(launch_counts())}")
        full = {name: ftmesh.full_tensor(p) for name, p in model.named_parameters()}
        if not gate.finish(replica_group) and rank == 0:
            axes = param_axes(cfg)
            shardings = {name.split(".", 2)[-1]: str(ftmesh.spec(*axes[name]))
                         for name in ("layers.0.attn_norm", "layers.0.wq.weight")}
            _say(f"[group {replica_group}] FINAL step={manager.current_step()} "
                 f"params_sha256={params_digest(full)} sample_shardings={shardings}")
    finally:
        if ckpt is not None:
            ckpt.shutdown()
        manager.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    faulthandler.register(signal.SIGUSR1)
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--devices", type=int, default=4,
                        help="local ranks forming this group's (fsdp x tensor) mesh")
    parser.add_argument("--fsdp", type=int, default=0,
                        help="fsdp axis size (default: devices // 2, at least 1)")
    parser.add_argument("--tensor", type=int, default=0,
                        help="tensor axis size (default: devices // fsdp)")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--model", choices=("demo", "flagship"), default="demo",
                        help="demo: d_model 128, 2 layers, f32 (the JAX example's); flagship: "
                        "flagship_config's model and sequence, bf16 compute (its batch: "
                        "--batch 16)")
    parser.add_argument("--transport", choices=("http", "collective"), default="http",
                        help="the checkpoint transport a restarted group heals over")
    parser.add_argument("--ckpt_dir", default=os.environ.get("TPUFT_CKPT_DIR", ""),
                        help="durable checkpoint directory; empty disables disk checkpoints")
    parser.add_argument("--ckpt_every", type=int, default=20)
    parser.add_argument(
        "--require-merged-final", type=int, default=0,
        help="keep stepping past --steps until a committed step ran with at least this "
        "many participating groups (a deterministic merged finish for kill tests)")
    parser.add_argument("--steps-cap", type=int, default=0,
                        help="hard step bound when --require-merged-final is never met")
    parser.add_argument("--local-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.local_rank is None:
        sys.exit(launch_ranks(args, sys.argv[1:]))
    run_rank(args)


if __name__ == "__main__":
    main()
