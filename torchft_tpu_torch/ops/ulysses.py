"""Ulysses sequence parallelism: all-to-all head<->sequence resharding.

The counterpart of ``torchft_tpu/ops/ulysses.py``.  Where the ring keeps Q
resident and rotates K/V (n-1 neighbour hops), Ulysses does two exchanges
(:func:`~torchft_tpu_torch.parallel.functional.all_to_all`, gloo's
all-to-all on the tensors as they are): each rank's [B, H, S/n, D] becomes
[B, H/n, S, D], ordinary full-sequence attention runs on that head subset
(the flash kernels K1-K3 on the card, wherever ``flash_applicable`` holds)
and the output is swapped back.  GQA stays compressed through the exchange;
the local attention repeats kv groups afterwards.
"""

from __future__ import annotations

from typing import Any

import torch

from torchft_tpu_torch.ops.attention import flash_applicable, flash_attention, plain_attention
from torchft_tpu_torch.ops.ring_attention import global_block, local_block
from torchft_tpu_torch.parallel.functional import all_to_all

__all__ = ["check_heads", "ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Any,
    causal: bool = True,
) -> torch.Tensor:
    """The local body over ``group`` (the "sequence" axis's).

    q/k/v: this rank's sequence shards [B, H, S_local, D]; the q and kv
    head counts must each divide over the group (:func:`check_heads`)."""
    # [B, H, S_local, D] -> [B, H/n, S, D]: heads scatter, sequence gathers.
    q, k, v = (all_to_all(t, 1, 2, group) for t in (q, k, v))
    attend = flash_attention if flash_applicable(q, k) else plain_attention
    out = attend(q, k, v, causal=causal)
    # [B, H/n, S, D] -> [B, H, S_local, D]
    return all_to_all(out, 2, 1, group)


def check_heads(q_heads: int, kv_heads: int, tp: int, n: int) -> None:
    """The JAX ``ulysses_attention_sharded``'s checks, in its order and with
    its messages: each head count divides over the "tensor" axis (``tp``),
    then each tensor shard's heads over the sequence axis (``n``)."""
    for name, heads in (("q", q_heads), ("kv", kv_heads)):
        # Guard TP divisibility first (2 kv heads over tensor 4): without
        # it heads // tp floors to 0 and 0 % n passes the check below.
        if heads % tp != 0:
            raise AssertionError(
                f"Ulysses needs {name} heads ({heads}) divisible by the 'tensor' axis ({tp}); "
                "use ring attention otherwise")
        heads_local = heads // tp
        if heads_local % n != 0:
            raise AssertionError(
                f"Ulysses needs {name} heads-per-TP-shard ({heads_local}) divisible by the "
                f"sequence axis ({n}); use ring attention otherwise")


def ulysses_attention_sharded(
    ftmesh: Any,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """The JAX ``ulysses_attention_sharded``'s counterpart, placed as
    ``ring_attention_sharded`` places its inputs: global q/k/v [B, H, S,
    D] (the same on every rank), the batch over "data", the heads over
    "tensor", the sequence over "sequence" (``ftmesh``'s groups); returns
    the global output, gathered (no gradient through the gather)."""
    check_heads(q.shape[1], k.shape[1], ftmesh.size("tensor"), ftmesh.size("sequence"))
    out = ulysses_attention(local_block(ftmesh, q), local_block(ftmesh, k),
                            local_block(ftmesh, v), ftmesh.group("sequence"), causal=causal)
    return global_block(ftmesh, out)
