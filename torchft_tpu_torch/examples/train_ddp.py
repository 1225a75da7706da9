"""Fault-tolerant data-parallel training example.

The counterpart of ``examples/train_ddp.py``: one process is one replica
group; gradients are averaged across groups through the Manager's
fault-tolerant allreduce; a killed process is restarted by the launcher's
supervisor, heals live weights from a peer, and rejoins without stopping
the others.

Run (two supervised replica groups and an embedded lighthouse, one
command)::

    python -m torchft_tpu_torch.launch --groups 2 -- \\
        python -m torchft_tpu_torch.examples.train_ddp --steps 20

With ``--spares 1`` on the launcher a killed or drained group's id goes
to a pre-started spare, which has built the model and started the device
while idle (its log is ``spare_<sid>.log``); a drained group finishes its
step, prints ``DRAIN exit`` instead of FINAL and exits 0.

With ``--ckpt_dir`` (or ``TPUFT_CKPT_DIR``) each group also saves its
state every ``--ckpt_every`` committed steps under ``group_<g>``, and a job
started again resumes from the newest complete checkpoint ("resumed from
disk checkpoint step=...") instead of step 0.

It trains on the card unless given ``--device cpu``.  The model is the
small conv net on synthetic CIFAR-shaped data, the same numpy dataset as
the JAX example.  At exit each process prints a parameter checksum: after
any number of mid-run kills, all groups print the same one.
"""

from __future__ import annotations

import argparse
import faulthandler
import logging
import os
import signal


def main() -> None:
    # INFO so the manager's "healing from replica" and reconfigure lines
    # land in the log: the FT demo's evidence trail.
    logging.basicConfig(level=logging.INFO)
    # SIGUSR1 dumps all thread stacks: the first move when a replica hangs.
    faulthandler.register(signal.SIGUSR1)
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--min_replicas", type=int, default=1)
    parser.add_argument(
        "--ckpt_dir", default=os.environ.get("TPUFT_CKPT_DIR", ""),
        help="durable checkpoint directory (one group_<g> directory a group); empty "
        "disables disk checkpoints",
    )
    parser.add_argument("--ckpt_every", type=int, default=10)
    parser.add_argument(
        "--require-merged-final", type=int, default=0,
        help="keep stepping past --steps until a committed step ran with at least this "
        "many participating groups (a deterministic merged finish for kill tests)",
    )
    parser.add_argument("--steps-cap", type=int, default=0,
                        help="hard step bound when --require-merged-final is never met")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = parser.parse_args()

    import numpy as np
    import torch

    from torchft_tpu_torch import GradientAverager, Optimizer
    from torchft_tpu_torch.data import DistributedSampler
    from torchft_tpu_torch.examples._common import (
        TrainGate,
        make_manager,
        maybe_straggle,
        params_digest,
        replica_env,
    )
    from torchft_tpu_torch.models import ConvNet, convnet_loss, resolve_device

    dev = resolve_device(args.device)
    model = ConvNet(device=dev, generator=torch.Generator(device=dev).manual_seed(42))
    # Synthetic dataset, identical in every process (seeded), moved to the
    # device once.
    rng = np.random.default_rng(0)
    dataset_x = torch.from_numpy(
        rng.standard_normal((2048, 32, 32, 3)).astype(np.float32)).to(dev)
    dataset_y = torch.from_numpy(rng.integers(0, 10, size=(2048,)).astype(np.int64)).to(dev)

    # Everything above is group-independent: a hot spare has paid for it
    # (and for the device's start) before it blocks here for its group id.
    replica_group, num_groups = replica_env(dev)
    sgd = torch.optim.SGD(model.parameters(), lr=args.lr)

    def save():
        return {"model": model.state_dict(), "optim": sgd.state_dict()}

    def load(sd):
        model.load_state_dict(sd["model"])
        sgd.load_state_dict(sd["optim"])

    manager = make_manager(save, load, replica_group, min_replicas=args.min_replicas)
    opt = Optimizer(manager, sgd)
    averager = GradientAverager(manager)
    params = list(model.parameters())

    # Durable disk checkpoints: the peer transports heal a restarted group
    # from a live one, but a cold start (every group gone) would otherwise
    # begin at step 0.
    ckpt = None
    if args.ckpt_dir:
        from torchft_tpu_torch.checkpointing import ManagedDiskCheckpoint

        ckpt = ManagedDiskCheckpoint(manager, save, load,
                                     os.path.join(args.ckpt_dir, f"group_{replica_group}"),
                                     every=args.ckpt_every)
        ckpt_step = ckpt.restore()
        if ckpt_step is not None:
            print(f"[group {replica_group}] resumed from disk checkpoint step={ckpt_step}",
                  flush=True)

    gate = TrainGate(manager, args.steps, require_merged=args.require_merged_final,
                     steps_cap=args.steps_cap)
    try:
        while gate.should_continue():
            opt.zero_grad()
            step = manager.current_step()
            # Shard by the static replica group id: dynamic quorum state
            # would shift every group's shard on each membership change.
            sampler = DistributedSampler(len(dataset_x), replica_group=replica_group,
                                         num_replica_groups=num_groups, shuffle=True, seed=step)
            idx = [i for _, i in zip(range(args.batch), iter(sampler))]
            sel = torch.tensor(idx, device=dev)
            loss = convnet_loss(model, dataset_x[sel], dataset_y[sel])
            loss.backward()
            # The straggler scenario's injection point (a no-op outside it):
            # a sleep here is slow compute on this host.
            maybe_straggle(replica_group)
            averager.allreduce([p.grad for p in params])
            committed = opt.step()
            gate.note_commit(committed)
            if ckpt is not None:
                ckpt.maybe_save(committed)
            print(f"[group {replica_group}] step={step} loss={float(loss.detach()):.4f} "
                  f"participants={manager.num_participants()} committed={committed}",
                  flush=True)
        if not gate.finish(replica_group):
            print(f"[group {replica_group}] FINAL step={manager.current_step()} "
                  f"params_sha256={params_digest(model.state_dict())}", flush=True)
    finally:
        if ckpt is not None:
            ckpt.shutdown()
        manager.shutdown()


if __name__ == "__main__":
    main()
