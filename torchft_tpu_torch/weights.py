"""Loading the JAX package's parameter trees into the port's models.

``torchft_tpu.models.transformer.init_params`` returns a tree with the
per-layer weights stacked along a leading L axis and matrices in the
``[in, out]`` layout; the port's :class:`Transformer` keeps one module per
layer and ``nn.Linear`` weights in ``[out, in]``.  :func:`params_from_jax`
maps the former (as numpy arrays) onto the latter's state dict, so both
packages can run from identical weights (a pipeline stage's slice of the
layers too); :func:`convnet_params_from_jax`
does the same for the example's conv net.  :func:`load_params` copies such
a state dict into a model, each DTensor parameter of a sharded model
(``models.parallelize``) taking its rank's local shard.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")
_EXPERTS = ("router", "w_gate", "w_up", "w_down")


def params_from_jax(tree: Dict[str, Any], layers: Optional[Sequence[int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~torchft_tpu_torch.models.Transformer` from the
    JAX ``init_params`` tree of numpy arrays.  A mixture-of-experts tree
    (a ``router`` [L, E, X] and stacked experts [L, X, E, F] / [L, X, F,
    E]) keeps its experts in the JAX layout.  ``layers``: only these global
    layer indices, numbered from 0 in order (a pipeline stage's slice,
    ``parallel/pipeline.py`` ``stage_layers``)."""
    def t(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    stacked = tree["layers"]
    moe = "router" in stacked
    if layers is None:
        layers = range(np.asarray(stacked["wq"]).shape[0])
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": t(tree["embed"]),
        "final_norm": t(tree["final_norm"]),
        "lm_head": t(tree["lm_head"]),
    }
    for i, g in enumerate(layers):
        for name in _NORMS + (_EXPERTS if moe else ()):
            sd[f"layers.{i}.{name}"] = t(np.asarray(stacked[name])[g])
        for name in _LINEARS[:4] if moe else _LINEARS:
            sd[f"layers.{i}.{name}.weight"] = t(np.asarray(stacked[name])[g].T)
    return sd


def load_params(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Copies the full tensors of ``state_dict`` into ``model``'s
    parameters in place: a plain parameter takes the whole tensor, a
    DTensor parameter its rank's shard of it (``FTMesh.local_shard`` under
    its own placements).  Every parameter must have an entry."""
    ftmesh = getattr(model, "ftmesh", None)
    with torch.no_grad():
        for name, p in model.named_parameters():
            full = state_dict[name]
            if p.shape != full.shape:
                raise ValueError(f"{name}: {tuple(full.shape)} for a {tuple(p.shape)} parameter")
            if hasattr(p, "to_local"):
                p.to_local().copy_(ftmesh.local_shard(full, p.placements))
            else:
                p.copy_(full)


def convnet_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~torchft_tpu_torch.models.ConvNet` from the JAX
    ``init_convnet_params`` tree of numpy arrays: the HWIO convolution to
    OIHW, the ``[in, out]`` dense weights to ``[out, in]``."""
    def t(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    return {
        "conv": t(np.transpose(np.asarray(tree["conv"]), (3, 2, 0, 1))),
        "w1": t(np.asarray(tree["w1"]).T),
        "b1": t(tree["b1"]),
        "w2": t(np.asarray(tree["w2"]).T),
        "b2": t(tree["b2"]),
    }
