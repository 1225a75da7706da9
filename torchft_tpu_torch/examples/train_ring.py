"""Fault-tolerant long-context training: ring attention inside the group,
replicated across groups, each rank's state healed live.

The counterpart of ``examples/train_ring.py``.  Each replica group splits
every sequence of its batch over a ``sequence`` axis (and the batch over a
``data`` axis when ``--devices`` exceeds ``--sequence``); attention runs as
a K/V ring over the sequence axis (``ops/ring_attention.py``), optionally
in the work-balanced zigzag layout (``--layout zigzag``: tokens and targets
permuted once on the host, rope positions following inside the model).
Groups average gradients through the Manager's fault-tolerant allreduce; a
killed group restarts and each of its ranks heals its own state from the
same rank of a healthy group.

As ``train_hsdp`` does, the group's process, started by the launcher,
starts ``--devices`` local ranks, one ``torch.distributed`` world over gloo
through the group's Store, each rank with its own Manager and dying
with the group's process.

Run (two supervised groups, each 2 data x 2 sequence ranks on the CPU)::

    python -m torchft_tpu_torch.launch --groups 2 --max-restarts 3 -- \\
        python -m torchft_tpu_torch.examples.train_ring --device cpu --steps 200 \\
        --sequence 2 --layout zigzag

At exit rank 0 prints ``FINAL ... params_sha256=... ring_layout=...``:
after any number of mid-run kills all groups print the same checksum.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import logging
import os
import signal
import sys

from torchft_tpu_torch.examples.train_hsdp import _say, launch_ranks


def run_rank(args: argparse.Namespace) -> None:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch import GradientAverager, Optimizer
    from torchft_tpu_torch.data import DistributedSampler, shard_batch, shard_sequence
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
    from torchft_tpu_torch.multihost import initialize_slice
    from torchft_tpu_torch.ops import launch_counts
    from torchft_tpu_torch.ops.ring_attention import to_zigzag
    from torchft_tpu_torch.parallel import ft_init_mesh

    rank, n = args.local_rank, args.devices
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(args.device)

    if args.model == "flagship":
        cfg, _, seq = flagship_config()
        cfg = dataclasses.replace(cfg, attention="ring", ring_layout=args.layout)
        rows = 256
    else:
        seq, rows = 64, 4096
        cfg = TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=256,
            max_seq=seq, dtype=torch.float32,  # exact cross-group convergence
            attention="ring", ring_layout=args.layout)
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    # Synthetic token stream, identical in every process (seeded).
    rng = np.random.default_rng(0)
    dataset = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(rows, seq))).to(dev)

    replica_group, num_groups = replica_env(dev)
    state = {}

    def save():
        return {"model": model.state_dict(), "optim": state["sgd"].state_dict()}

    def load(sd):
        model.load_state_dict(sd["model"])
        state["sgd"].load_state_dict(sd["optim"])
        fetch = getattr(manager.checkpoint_transport, "last_fetch", None) or {}
        _say(f"[group {replica_group} rank {rank}] healed step={manager.current_step()} "
             f"bytes={fetch.get('bytes')} fetch_s={fetch.get('fetch_s')} "
             f"sequence={ftmesh.coordinate('sequence')} data={ftmesh.coordinate('data')}")

    manager = make_manager(save, load, replica_group, rank=rank, world_size=n,
                           store_port=int(os.environ["MASTER_PORT"]), restore_in_place=True)
    # gloo on the card too: the group's ranks share one card (NCCL refuses
    # two ranks on one device), and the ring's hops stage through host memory.
    initialize_slice(backend="gloo")
    ftmesh = ft_init_mesh({"data": n // args.sequence, "sequence": args.sequence},
                          manager=manager, device_type=dev.type)
    parallelize(model, ftmesh)
    state["sgd"] = torch.optim.SGD(model.parameters(), lr=args.lr)
    opt = Optimizer(manager, state["sgd"])
    averager = GradientAverager(manager)
    params = list(model.parameters())

    shard, shards = ftmesh.batch_shard()
    gate = TrainGate(manager, args.steps, require_merged=args.require_merged_final,
                     steps_cap=args.steps_cap)
    try:
        while gate.should_continue():
            opt.zero_grad()
            step = manager.current_step()
            # The group's batch by the static replica group id, then this
            # rank's rows over "data" and its slice of each over "sequence".
            sampler = DistributedSampler(len(dataset), replica_group=replica_group,
                                         num_replica_groups=num_groups, shuffle=True, seed=step)
            idx = [i for _, i in zip(range(args.batch), iter(sampler))]
            tokens = dataset[torch.as_tensor(shard_batch(idx, 0, 1, shard, shards), device=dev)]
            targets = torch.roll(tokens, -1, dims=1)
            if args.layout == "zigzag":
                # One host-side permutation pair; rope positions follow
                # inside the model (TransformerConfig.ring_layout).
                tokens = to_zigzag(tokens, args.sequence, dim=1)
                targets = to_zigzag(targets, args.sequence, dim=1)
            batch = {k: shard_sequence(v, ftmesh.coordinate("sequence"), args.sequence)
                     for k, v in (("tokens", tokens), ("targets", targets))}
            loss = model.loss(batch)
            loss.backward()
            averager.allreduce([p.grad for p in params])
            committed = opt.step()
            gate.note_commit(committed)
            # The loss is the group's mean over "sequence"; average "data".
            group_loss = loss.detach().clone()
            dist.all_reduce(group_loss)
            if rank == 0:
                _say(f"[group {replica_group}] step={step} loss={float(group_loss) / n:.4f} "
                     f"participants={manager.num_participants()} committed={committed}")

        if dev.type == "cuda":
            _say(f"[group {replica_group} rank {rank}] kernel launches "
                 f"{json.dumps(launch_counts())}")
        full = {name: ftmesh.full_tensor(p) for name, p in model.named_parameters()}
        if not gate.finish(replica_group) and rank == 0:
            _say(f"[group {replica_group}] FINAL step={manager.current_step()} "
                 f"params_sha256={params_digest(full)} ring_layout={args.layout}")
    finally:
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
    parser.add_argument("--layout", choices=["contiguous", "zigzag"], default="contiguous",
                        help="sequence layout for the causal ring (zigzag balances work)")
    parser.add_argument("--sequence", type=int, default=4,
                        help="ring size: sequence-axis shards per group")
    parser.add_argument("--devices", type=int, default=4,
                        help="local ranks forming this group's (data x sequence) mesh")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--model", choices=("demo", "flagship"), default="demo",
                        help="demo: d_model 128, 2 layers, f32 (the JAX example's); flagship: "
                        "flagship_config's model and sequence, bf16 compute (its batch: "
                        "--batch 16)")
    parser.add_argument(
        "--require-merged-final", type=int, default=0,
        help="keep stepping past --steps until a committed step ran with at least this "
        "many participating groups (a deterministic merged finish for kill tests)")
    parser.add_argument("--steps-cap", type=int, default=0,
                        help="hard step bound when --require-merged-final is never met")
    parser.add_argument("--local-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.devices % args.sequence:
        parser.error(f"--devices {args.devices} not divisible by --sequence {args.sequence}")
    if args.batch % (args.devices // args.sequence):
        parser.error(f"--batch {args.batch} must divide over the data axis "
                     f"{args.devices // args.sequence}")
    if args.local_rank is None:
        sys.exit(launch_ranks(args, sys.argv[1:], "torchft_tpu_torch.examples.train_ring"))
    run_rank(args)


if __name__ == "__main__":
    main()
