"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

The port's tests hold it against the JAX package.  Importing the JAX
package builds its native core on first import (cmake and ninja into
native/build, with the C++ test binary that tests/test_native_core.py
runs), and concurrent test workers race on that build, which can leave
native/build unusable.  So the reference is imported here, inside fixtures
only, under a cross-process lock, and builds itself there.  Only where
cmake or ninja is missing are the JAX package's native artifacts
provisioned first, by its own documented toolchain-less recipe
(native/gen_pb_local.py's Python module, and the same native sources built
with plain g++, the port's build of them): a library copied in beside a
toolchain would leave native/build unmade.  A failed import is retried
once.
"""

from __future__ import annotations

import fcntl
import importlib
import importlib.util
import os
import shutil
import subprocess
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOCK_DIR = os.path.join(REPO, "torchft_tpu_torch", "_build")
_JAX_LIB = os.path.join(REPO, "torchft_tpu", "_lib", "libtpuft.so")
_JAX_PB2 = os.path.join(REPO, "torchft_tpu", "proto", "tpuft_pb2.py")


def _provision_reference_native() -> None:
    """Writes the JAX package's generated native artifacts (both listed in
    .gitignore) when they are missing and no cmake / ninja toolchain can
    build them."""
    from torchft_tpu_torch._build import native_lib_path

    if shutil.which("cmake") is not None and shutil.which("ninja") is not None:
        return

    if not os.path.exists(_JAX_PB2):
        spec = importlib.util.spec_from_file_location(
            "_tpuft_gen_pb_local", os.path.join(REPO, "native", "gen_pb_local.py")
        )
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        tmp = _JAX_PB2 + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(gen.gen_py(gen.parse(gen.PROTO)))
        os.replace(tmp, _JAX_PB2)
    if not os.path.exists(_JAX_LIB):
        os.makedirs(os.path.dirname(_JAX_LIB), exist_ok=True)
        tmp = _JAX_LIB + f".tmp{os.getpid()}"
        shutil.copyfile(native_lib_path(), tmp)
        os.replace(tmp, _JAX_LIB)


def import_reference(name: str):
    """Imports the JAX package module ``name`` under a lock shared by every
    test worker."""
    os.makedirs(_LOCK_DIR, exist_ok=True)
    with open(os.path.join(_LOCK_DIR, ".lock-jax-reference"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _provision_reference_native()
            try:
                return importlib.import_module(name)
            except subprocess.CalledProcessError:
                # An unlocked first import elsewhere raced this build.
                time.sleep(5)
                return importlib.import_module(name)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is no card (decided when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card through chip_smoke.py / pytest -m gpu)")
    return torch.device("cuda")
