"""The outer optimizer of the semi-sync plane: optax's ``sgd`` on tensor lists.

The JAX package's ``StreamingDiLoCo`` takes an optax transform as its
``outer_tx``; torch has no optax, so the port takes this counterpart, an
``init`` / ``update`` pair over lists of CPU tensors with
:func:`apply_updates`.  ``sgd(lr, momentum, nesterov)`` computes exactly
optax's ``sgd`` (a ``trace`` of the updates, then a scale by ``-lr``), one
tensor op at a time in optax's order, so it is bitwise optax's on the same
inputs:

    t = g + momentum * t                      (the trace)
    u = g + momentum * t   (nesterov)   or   u = t
    u = (-lr) * u
    p = p + u                                  (apply_updates)

``torch.optim.SGD`` is not a substitute: its momentum buffer starts as the
first gradient, its nesterov update and its fused multiply-adds
(``add_(..., alpha=...)``) round differently, and on 10^5 float32 elements
it differs from optax in thousands of elements by up to 1.9e-6 after five
rounds.  Groups that must agree bit for bit (a DiLoCo quorum, a mixed JAX
and port quorum) need the same outer update to the last bit.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["OuterTransform", "sgd", "apply_updates"]


class OuterTransform(NamedTuple):
    """optax's ``GradientTransformation`` shape: ``init(params) -> state``
    and ``update(updates, state, params) -> (updates, state)``."""

    init: Any
    update: Any


def sgd(lr: float, momentum: Optional[float] = None, nesterov: bool = False) -> OuterTransform:
    """optax's ``sgd(lr, momentum, nesterov)``: with ``momentum=None`` (as
    optax's default) no trace is kept; any number, 0 included, keeps one,
    as optax does.  The state is ``{"trace": [tensor, ...]}`` or ``{}``."""

    def init(params: Sequence[torch.Tensor]) -> dict:
        if momentum is None:
            return {}
        return {"trace": [torch.zeros_like(p) for p in params]}

    def update(updates: Sequence[torch.Tensor], state: dict,
               params: Optional[Sequence[torch.Tensor]] = None) -> Tuple[List[torch.Tensor], dict]:
        del params
        out = list(updates)
        if momentum is not None:
            trace = [torch.add(g, torch.mul(t, momentum)) for g, t in zip(out, state["trace"])]
            out = ([torch.add(g, torch.mul(t, momentum)) for g, t in zip(out, trace)]
                   if nesterov else trace)
            state = {"trace": trace}
        return [torch.mul(u, -lr) for u in out], state

    return OuterTransform(init, update)


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """optax's ``apply_updates``: ``p + u`` in each parameter's dtype."""
    return [torch.add(p, u).to(p.dtype) for p, u in zip(params, updates)]
