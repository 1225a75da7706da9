"""Fault-tolerant pipeline-parallel training: the layer stack pipelined
inside the group, replicated across groups, each stage healed live.

The counterpart of ``examples/train_pipeline.py``.  Each replica group
splits its transformer's layers over a ``pipeline`` axis (GPipe, or 1F1B
with ``--schedule 1f1b``: ``parallel/pipeline.py``), and its batch over a
``data`` axis when ``--devices`` exceeds ``--pipe``; groups average
gradients through the Manager's fault-tolerant allreduce; a killed group
restarts and each of its ranks heals its own stage (its layers, the
replicated embedding and head, and the optimizer's state of them) from the
same rank of a healthy group.

As ``train_hsdp`` does, the group's process, started by the launcher,
starts ``--devices`` local ranks, one ``torch.distributed`` world through
the group's Store (NCCL where each rank has a card of its own, gloo where
they share one or run on the CPU), each rank with its own Manager and dying
with the group's process.

Run (two supervised groups, each 2 stages x 2 data ranks on the CPU)::

    python -m torchft_tpu_torch.launch --groups 2 --max-restarts 3 -- \\
        python -m torchft_tpu_torch.examples.train_pipeline --device cpu --steps 200

At exit rank 0 prints ``FINAL ... params_sha256=...``, a checksum over
every stage's parameters: after any number of mid-run kills all groups
print the same one.
"""

from __future__ import annotations

import argparse
import faulthandler
import hashlib
import json
import logging
import os
import signal
import sys

from torchft_tpu_torch.examples.train_hsdp import _say, launch_ranks


def run_rank(args: argparse.Namespace) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.data import DistributedSampler, shard_batch
    from torchft_tpu_torch.examples._common import (
        TrainGate,
        make_manager,
        params_digest,
        replica_env,
    )
    from torchft_tpu_torch.models import Transformer, TransformerConfig, flagship_config
    from torchft_tpu_torch.multihost import initialize_slice
    from torchft_tpu_torch.ops import launch_counts
    from torchft_tpu_torch.parallel import (
        TrainStep,
        ft_init_mesh,
        pipeline_1f1b_value_and_grad,
        pipeline_loss_fn,
        pipeline_stage,
    )

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
            vocab_size=512, d_model=128, n_layers=4, n_heads=4, n_kv_heads=4, d_ff=256,
            max_seq=64, dtype=torch.float32, remat=False,  # exact cross-group convergence
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
        model.load_state_dict(sd["model"])
        state["sgd"].load_state_dict(sd["optim"])
        fetch = getattr(manager.checkpoint_transport, "last_fetch", None) or {}
        _say(f"[group {replica_group} rank {rank}] healed step={manager.current_step()} "
             f"bytes={fetch.get('bytes')} fetch_s={fetch.get('fetch_s')} "
             f"stage={model.stage[0]} layers={list(model.stage[2])}")

    manager = make_manager(save, load, replica_group, rank=rank, world_size=n,
                           store_port=int(os.environ["MASTER_PORT"]),
                           restore_in_place=True)
    initialize_slice(backend=backend)
    ftmesh = ft_init_mesh({"pipeline": args.pipe, "data": n // args.pipe}, manager=manager,
                          device_type=dev.type)
    pipeline_stage(model, ftmesh)
    state["sgd"] = torch.optim.SGD(model.parameters(), lr=args.lr)
    if args.schedule == "1f1b":
        schedule = {"value_and_grad_fn": lambda m, b: pipeline_1f1b_value_and_grad(
            m, b, ftmesh, num_microbatches=args.microbatches)}
    else:
        schedule = {"loss_fn": lambda m, b: pipeline_loss_fn(
            m, b, ftmesh, num_microbatches=args.microbatches)}
    trainer = TrainStep(model, state["sgd"], manager=manager, **schedule)

    shard, shards = ftmesh.batch_shard()
    gate = TrainGate(manager, args.steps, require_merged=args.require_merged_final,
                     steps_cap=args.steps_cap)
    try:
        while gate.should_continue():
            manager.start_quorum()
            step = manager.current_step()
            # The group's batch by the static replica group id, then this
            # rank's slice of it over "data" (every stage takes the same).
            sampler = DistributedSampler(len(dataset), replica_group=replica_group,
                                         num_replica_groups=num_groups, shuffle=True, seed=step)
            idx = [i for _, i in zip(range(args.batch), iter(sampler))]
            mine = torch.as_tensor(shard_batch(idx, 0, 1, shard, shards), device=dev)
            tokens = dataset[mine]
            loss, committed = trainer.ft_step(
                {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)})
            gate.note_commit(committed)
            if rank == 0:
                _say(f"[group {replica_group}] step={step} loss={float(loss):.4f} "
                     f"participants={manager.num_participants()} committed={committed}")

        if dev.type == "cuda":
            _say(f"[group {replica_group} rank {rank}] kernel launches "
                 f"{json.dumps(launch_counts())}")
        # Every stage's parameters under their global layer names.
        lo = model.stage[2].start
        named = {}
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                parts[1] = str(lo + int(parts[1]))
            named[".".join(parts)] = p
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, (ftmesh.coordinate("data"), params_digest(named)))
        if not gate.finish(replica_group) and rank == 0:
            # One checksum over the stages of data rank 0 (the data ranks
            # hold the same parameters).
            stages = [d for c, d in digests if c == 0]
            digest = hashlib.sha256("".join(stages).encode()).hexdigest()
            _say(f"[group {replica_group}] FINAL step={manager.current_step()} "
                 f"params_sha256={digest} stages={args.pipe} schedule={args.schedule}")
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
    parser.add_argument("--microbatches", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--schedule", choices=("gpipe", "1f1b"), default="gpipe",
                        help="gpipe: forward pipeline + autograd's reverse; 1f1b: loss and "
                        "backward inside the pipeline, activation memory bounded by the pipe "
                        "depth")
    parser.add_argument("--pipe", type=int, default=2, help="pipeline stages per group")
    parser.add_argument("--devices", type=int, default=4,
                        help="local ranks forming this group's (pipeline x data) mesh")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--model", choices=("demo", "flagship"), default="demo",
                        help="demo: d_model 128, 4 layers, f32 (the JAX example's); flagship: "
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
    if args.devices % args.pipe:
        parser.error(f"--devices {args.devices} not divisible by --pipe {args.pipe}")
    data = args.devices // args.pipe
    if args.batch % data or (args.batch // data) % args.microbatches:
        parser.error(f"--batch {args.batch} must divide over data axis {data} and then into "
                     f"--microbatches {args.microbatches}")
    if args.local_rank is None:
        sys.exit(launch_ranks(args, sys.argv[1:], "torchft_tpu_torch.examples.train_pipeline"))
    run_rank(args)


if __name__ == "__main__":
    main()
