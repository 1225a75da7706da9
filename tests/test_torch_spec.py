"""The port's JobSet manifest (``torchft_tpu_torch/spec.py`` and the
launcher's ``--dump-spec``) against the JAX package's, on the CPU.

Held: for the command and flags of tests/test_launch.py's dump-spec test,
the port's manifest equals the JAX one in every field but the
accelerator's (the worker pod's node selector and resource limits) and the
CLI modules it names (the port's own lighthouse and store); the port's pod
asks for ``nvidia.com/gpu``; the port launcher's ``main([... "--dump-spec"
...])`` prints YAML that carries the launch env contract; the argument
checks raise as the JAX ones do."""

from __future__ import annotations

import copy

import pytest
import yaml

from torch_port_ref import import_reference
from torchft_tpu_torch.launch import main
from torchft_tpu_torch.spec import dump_yaml, jobset_spec

CMD = ["python", "train.py", "--steps", "100"]
KW = dict(name="myjob", num_groups=3, hosts_per_group=4, image="gcr.io/proj/img:1",
          max_restarts=7, min_replicas=1)


def _pod(spec: dict) -> dict:
    jobs = {j["name"]: j for j in spec["spec"]["replicatedJobs"]}
    return jobs["group"]["template"]["spec"]["template"]["spec"]


def _neutral(spec: dict) -> dict:
    """``spec`` without its accelerator fields, the CLI modules named as
    the JAX package's."""
    out = copy.deepcopy(spec)
    pod = _pod(out)
    del pod["nodeSelector"]
    del pod["containers"][0]["resources"]
    text = yaml.safe_dump(out, sort_keys=False)
    return yaml.safe_load(text.replace("torchft_tpu_torch.", "torchft_tpu."))


def test_spec_equals_jax_outside_the_accelerator() -> None:
    ref = import_reference("torchft_tpu.spec")
    jax_spec = ref.jobset_spec(CMD, tpu_topology="4x4", **KW)
    port = jobset_spec(CMD, gpu_accelerator="nvidia-h100-80gb", gpus_per_host=8, **KW)
    assert _neutral(port) == _neutral(jax_spec)
    assert port != jax_spec
    pod = _pod(port)
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert pod["containers"][0]["resources"] == {"limits": {"nvidia.com/gpu": 8}}
    text = dump_yaml(port)
    assert "google.com/tpu" not in text and "gke-tpu" not in text
    assert "torchft_tpu_torch.lighthouse_cli" in text and "torchft_tpu_torch.store_cli" in text
    assert yaml.safe_load(text) == port


def test_launch_dump_spec_renders_env_contract(capsys) -> None:
    """tests/test_launch.py's dump-spec case on the port's launcher, with
    the GPU flags."""
    rc = main(["--groups", "3", "--max-restarts", "7", "--dump-spec", "--name", "myjob",
               "--hosts-per-group", "4", "--image", "gcr.io/proj/img:1",
               "--gpus-per-host", "4", "--gpu-accelerator", "nvidia-h100-mega-80gb",
               "--", *CMD])
    assert rc == 0
    spec = yaml.safe_load(capsys.readouterr().out)
    assert spec["kind"] == "JobSet" and spec["metadata"]["name"] == "myjob"
    assert spec["spec"]["failurePolicy"]["maxRestarts"] == 7
    jobs = {j["name"]: j for j in spec["spec"]["replicatedJobs"]}
    assert set(jobs) == {"lighthouse", "group"}
    group = jobs["group"]
    assert group["replicas"] == 3
    jspec = group["template"]["spec"]
    assert jspec["completionMode"] == "Indexed"
    assert jspec["completions"] == jspec["parallelism"] == 4
    container = jspec["template"]["spec"]["containers"][0]
    env = {e["name"]: e for e in container["env"]}
    assert env["NUM_REPLICA_GROUPS"]["value"] == "3"
    assert env["TPUFT_NUM_HOSTS"]["value"] == "4"
    assert "myjob-lighthouse-0-0.myjob" in env["TPUFT_LIGHTHOUSE"]["value"]
    assert "job-index" in str(env["TPUFT_GROUP_INDEX"]["valueFrom"])
    assert "restart-attempt" in str(env["JOBSET_RESTART_ATTEMPT"]["valueFrom"])
    script = container["args"][0]
    for line in ('REPLICA_GROUP_ID="${TPUFT_GROUP_INDEX}"',
                 'TPUFT_HOST_RANK="${JOB_COMPLETION_INDEX}"',
                 'TPUFT_STORE="myjob-group-${REPLICA_GROUP_ID}-0.myjob:29500"',
                 "python -m torchft_tpu_torch.store_cli",
                 'MASTER_ADDR="myjob-group-${REPLICA_GROUP_ID}-0.myjob"',
                 'TPUFT_SLICE_GEN="${JOBSET_RESTART_ATTEMPT:-0}"',
                 "exec python train.py --steps 100"):
        assert line in script, script
    pod = jspec["template"]["spec"]
    assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == "nvidia-h100-mega-80gb"
    assert container["resources"]["limits"]["nvidia.com/gpu"] == 4
    lcmd = jobs["lighthouse"]["template"]["spec"]["template"]["spec"]["containers"][0]["command"]
    assert lcmd[:3] == ["python", "-m", "torchft_tpu_torch.lighthouse_cli"]


@pytest.mark.parametrize("kw,match", [({"num_groups": 0}, "must be >= 1"),
                                      ({"hosts_per_group": 0}, "must be >= 1")])
def test_spec_refuses_bad_shapes(kw, match) -> None:
    with pytest.raises(ValueError, match=match):
        jobset_spec(CMD, **kw)
    with pytest.raises(ValueError, match="cmd must be"):
        jobset_spec([])
