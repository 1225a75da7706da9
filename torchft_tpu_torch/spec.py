"""Scheduler job-spec generation for GPU jobs: the counterpart of
``torchft_tpu/spec.py``, the launch contract rendered as a GKE JobSet.

The reference ships a TorchX component that renders its launch contract
(one role per replica group, REPLICA_GROUP_ID / NUM_REPLICA_GROUPS /
lighthouse address env) into scheduler job specs.  ``jobset_spec``
renders the SAME env contract ``torchft_tpu_torch.launch`` and
``torchft_tpu_torch.multihost`` define —

  per group:  REPLICA_GROUP_ID, NUM_REPLICA_GROUPS, TPUFT_LIGHTHOUSE
  per host:   TPUFT_HOST_RANK, TPUFT_NUM_HOSTS, TPUFT_STORE,
              TPUFT_SLICE_GEN (the scheduler's retry counter)

— onto one JobSet: a lighthouse replicated-job plus ``num_groups``
replicated GPU Jobs (Indexed completion = host rank; JobSet's headless
service gives every pod a stable DNS name, which is how each group's hosts
find their rank-0 Store and every group finds the lighthouse).  The JAX
package's manifest, the same in every field but the accelerator's: each
worker pod asks for ``gpus_per_host`` ``nvidia.com/gpu`` and is placed by
the ``cloud.google.com/gke-accelerator`` node label (GKE's GPU node pools)
where that one asks for a TPU slice's topology; the lighthouse and store
commands name this package's CLIs.  ``python -m torchft_tpu_torch.launch
--dump-spec ...`` prints the manifest; it is a starting point to edit, not
a turnkey operator.
"""

from __future__ import annotations

import shlex
from typing import Dict, List, Optional

__all__ = ["jobset_spec", "dump_yaml"]

_LIGHTHOUSE_PORT = 29510
_STORE_PORT = 29500
_MASTER_PORT = 29400


def _worker_script(cmd: List[str], name: str) -> str:
    """Shell prologue deriving the per-pod env contract from what the
    scheduler provides, then exec'ing the user command.

    JobSet injects JOB_COMPLETION_INDEX (Indexed Jobs) and the
    jobset.sigs.k8s.io/job-index annotation (surfaced below via the
    downward API as TPUFT_GROUP_INDEX); pod DNS is
    ``<jobset>-<job>-<jobindex>-<podindex>.<jobset>`` on the JobSet's
    headless service."""
    user = " ".join(shlex.quote(c) for c in cmd)
    # Pod DNS: <jobset>-<replicatedjob>-<jobindex>-<podindex>.<jobset>; the
    # group's host-rank-0 pod is pod index 0 of job index REPLICA_GROUP_ID.
    rank0 = f"{name}-group-${{REPLICA_GROUP_ID}}-0.{name}"
    return "\n".join(
        [
            "set -eu",
            "export REPLICA_GROUP_ID=\"${TPUFT_GROUP_INDEX}\"",
            "export TPUFT_HOST_RANK=\"${JOB_COMPLETION_INDEX}\"",
            # Each group's hosts rendezvous through a Store SERVED by the
            # group's host-rank-0 pod: initialize_slice is a client only,
            # so rank 0 runs the standalone store_cli in the background
            # before exec'ing the trainer.
            f'export TPUFT_STORE="{rank0}:{_STORE_PORT}"',
            'if [ "${TPUFT_HOST_RANK}" = "0" ] && [ "${TPUFT_NUM_HOSTS}" != "1" ]; then',
            f"  python -m torchft_tpu_torch.store_cli --bind \"[::]:{_STORE_PORT}\" &",
            "fi",
            # The group Manager's rank-0 endpoint (manager.py MASTER_* contract).
            f'export MASTER_ADDR="{rank0}"',
            f"export MASTER_PORT=\"{_MASTER_PORT}\"",
            # The scheduler's retry counter becomes the restart generation,
            # so a restarted slice never reads a stale coordinator key.
            "export TPUFT_SLICE_GEN=\"${JOBSET_RESTART_ATTEMPT:-0}\"",
            f"exec {user}",
        ]
    )


def jobset_spec(
    cmd: List[str],
    *,
    name: str = "tpuft",
    num_groups: int = 2,
    hosts_per_group: int = 1,
    image: str = "REPLACE_ME_IMAGE",
    gpu_accelerator: str = "nvidia-h100-80gb",
    gpus_per_host: int = 8,
    max_restarts: int = 10,
    min_replicas: int = 1,
    env: Optional[Dict[str, str]] = None,
) -> dict:
    """Renders the launch env contract as a JobSet manifest (a dict ready
    for YAML/JSON serialization).

    Args mirror the reference component's knobs (replicas /
    workers_per_replica / max_restarts / image) plus the GPUs a host holds
    and the accelerator label GKE places them by.
    """
    if num_groups < 1 or hosts_per_group < 1:
        raise ValueError("num_groups and hosts_per_group must be >= 1")
    if not cmd:
        raise ValueError("cmd must be the replica-group argv")

    lighthouse_addr = f"{name}-lighthouse-0-0.{name}:{_LIGHTHOUSE_PORT}"
    common_env = [
        {"name": "NUM_REPLICA_GROUPS", "value": str(num_groups)},
        {"name": "TPUFT_NUM_HOSTS", "value": str(hosts_per_group)},
        {"name": "TPUFT_LIGHTHOUSE", "value": lighthouse_addr},
        {
            "name": "TPUFT_GROUP_INDEX",
            "valueFrom": {
                "fieldRef": {
                    "fieldPath": "metadata.annotations['jobset.sigs.k8s.io/job-index']"
                }
            },
        },
        # The JobSet controller stamps its restart counter on every pod as
        # the restart-attempt annotation (there is no JOBSET_RESTART_ATTEMPT
        # env var injected by anything); surfacing it through the downward
        # API is what makes the worker script's TPUFT_SLICE_GEN a real
        # generation instead of a constant 0.
        {
            "name": "JOBSET_RESTART_ATTEMPT",
            "valueFrom": {
                "fieldRef": {
                    "fieldPath": "metadata.annotations['jobset.sigs.k8s.io/restart-attempt']"
                }
            },
        },
    ] + [{"name": k, "value": v} for k, v in (env or {}).items()]

    worker_job = {
        "name": "group",
        "replicas": num_groups,
        "template": {
            "spec": {
                "backoffLimit": max_restarts,
                "completions": hosts_per_group,
                "parallelism": hosts_per_group,
                "completionMode": "Indexed",
                "template": {
                    "spec": {
                        "restartPolicy": "Never",
                        "nodeSelector": {
                            "cloud.google.com/gke-accelerator": gpu_accelerator,
                        },
                        "containers": [
                            {
                                "name": "worker",
                                "image": image,
                                "command": ["/bin/sh", "-c"],
                                "args": [_worker_script(cmd, name)],
                                "env": common_env,
                                "ports": [
                                    {"containerPort": _STORE_PORT},
                                    {"containerPort": _MASTER_PORT},
                                ],
                                "resources": {
                                    "limits": {"nvidia.com/gpu": gpus_per_host}
                                },
                            }
                        ],
                    }
                },
            }
        },
    }

    lighthouse_job = {
        "name": "lighthouse",
        "replicas": 1,
        "template": {
            "spec": {
                "backoffLimit": max_restarts,
                "completions": 1,
                "parallelism": 1,
                "completionMode": "Indexed",
                "template": {
                    "spec": {
                        "restartPolicy": "Never",
                        "containers": [
                            {
                                "name": "lighthouse",
                                "image": image,
                                "command": [
                                    "python",
                                    "-m",
                                    "torchft_tpu_torch.lighthouse_cli",
                                    "--bind",
                                    f"[::]:{_LIGHTHOUSE_PORT}",
                                    "--min_replicas",
                                    str(min_replicas),
                                ],
                                "ports": [{"containerPort": _LIGHTHOUSE_PORT}],
                            }
                        ],
                    }
                },
            }
        },
    }

    return {
        "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "kind": "JobSet",
        "metadata": {"name": name},
        "spec": {
            # JobSet restart semantics are TWO-LEVEL, and this policy is
            # the outer level: a pod that dies is first retried inside its
            # own child Job up to that Job's backoffLimit (set above to
            # max_restarts) — during those retries the other groups keep
            # training and the restarted group heals live, which is the
            # common path.  Only when a child Job FAILS outright (pod
            # retries exhausted) does this failurePolicy act, and its
            # default action recreates the WHOLE JobSet (all groups, the
            # lighthouse included) up to maxRestarts times, bumping the
            # restart-attempt annotation that becomes TPUFT_SLICE_GEN —
            # a full cold start recovered via disk checkpoints, not live
            # healing.
            "failurePolicy": {"maxRestarts": max_restarts},
            "network": {"enableDNSHostnames": True},
            "replicatedJobs": [lighthouse_job, worker_job],
        },
    }


def dump_yaml(spec: dict) -> str:
    import yaml

    return yaml.safe_dump(spec, sort_keys=False, default_flow_style=False)
