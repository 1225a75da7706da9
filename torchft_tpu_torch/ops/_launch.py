"""Launching the hand-written Hopper kernels from Python.

Each kernel is a C function in a shared library built from
``torchft_tpu_torch/csrc/<source>.cu`` (see ``_build``).  A :class:`Kernel`
binds one such function with ctypes, launches it on PyTorch's current
stream, raises if the launch returned a CUDA error, and counts its
launches — the count is how a run shows that its main path went through
the kernel.  The library is built and loaded at the first launch, never at
import.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from torchft_tpu_torch._build import kernel_lib

# Kernel name -> Kernel, in registration order.
KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    """One C entry point of a kernel library.

    Args:
        name: kernel name (the counter's key).
        source: ``csrc/<source>.cu``.
        symbol: the exported C function; its last argument is the stream.
        argtypes: ctypes types of every argument but the stream.
        replaces: ``file:line`` of the TPU kernel it ports.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence, replaces: str) -> None:
        self.name = name
        self.source = source
        self.symbol = symbol
        self.replaces = replaces
        self._argtypes: List = [*argtypes, ctypes.c_void_p]
        self._fn = None
        self.launches = 0
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(kernel_lib(self.source), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel {self.name} failed to launch: CUDA error {rc}")
        self.launches += 1


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raises unless every tensor is a plain (not a DTensor), contiguous,
    16-byte-aligned CUDA tensor of ``dtype`` on one device."""
    from torch.distributed.tensor import DTensor

    dev = tensors[0].device
    for t in tensors:
        if isinstance(t, DTensor):
            # The kernels read data_ptr(): a sharded parameter's local tensor
            # is what a rank computes with (FTMesh.materialize).
            raise TypeError(f"{name}: got a DTensor; pass its local tensor")
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
