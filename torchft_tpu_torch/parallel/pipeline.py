"""Pipeline parallelism over the "pipeline" mesh axis: GPipe and 1F1B.

The counterpart of ``torchft_tpu/parallel/pipeline.py``.  The JAX package
stacks the layers on a leading axis, shards it over the stages and runs
each schedule as one ``lax.scan`` inside ``shard_map``.  The port keeps one
module a layer, so stage s of P owns the layer modules ``[s L / P, (s + 1)
L / P)`` (:func:`pipeline_stage` keeps only those); the embedding, the
final norm and the lm head are replicated over the stages, and the ticks
run as a Python loop, one ring hop a tick (:func:`~.functional.ring_hop`,
``lax.ppermute``'s counterpart: NCCL point-to-point calls on separate
cards, host-staged ones over gloo).

Two schedules, the JAX package's:

- **GPipe** (:func:`pipeline_loss_fn`): a forward pipeline whose backward
  is autograd's, the hops' gradients taking the inverse hops.  Every rank
  runs every tick's hop (a bubble tick passes its activation through, and
  stage 0 keeps the hop it discards in the graph), so each rank's
  backward meets the same hops in the reverse order.  A stage holds every
  microbatch's activations until the backward: its residency grows with
  M.  The loss is computed once, on the last stage, over the whole batch;
  every stage returns its value.
- **1F1B** (:func:`pipeline_1f1b_value_and_grad`): the loss and the whole
  backward run inside the pipeline.  Microbatch m's forward runs at stage
  s on tick s + m; the last stage takes its head, loss and cotangent on
  the same tick; its backward reaches stage s on tick m + 2 (P - 1) - s.
  A stage keeps only each in-flight microbatch's per-layer inputs, a ring
  of ``min(M, 2 P - 1)`` slots, and recomputes one layer at a time under
  autograd in the backward (``torch.autograd.backward(out, cotangent)``).
  The head and the loss run on the last stage once a microbatch.

Where the heads run, and so the fused cross-entropy kernels (K4, K5): on
the last stage only, once a step under GPipe and once a microbatch under
1F1B, where the rank holds the whole lm head (``fused_ce_applicable``).
The embedding, final-norm and lm-head gradients are summed over the stages
(the JAX ``psum``); with a "data" axis the loss and every gradient are
averaged over it (``pmean``), once a step.

Dense configs only, as in the JAX package: a mixture-of-experts config
raises, and so does a mesh axis other than "data" above 1.  The layers
must divide over the stages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from torchft_tpu_torch.parallel.functional import ring_hop, ring_shift
from torchft_tpu_torch.parallel.mesh import INTRA_GROUP_AXES

__all__ = [
    "pipeline_1f1b_value_and_grad",
    "pipeline_apply",
    "pipeline_apply_sharded",
    "pipeline_loss_fn",
    "pipeline_stage",
    "stage_layers",
]

# The last schedule's counts in this process: "max_held", the most
# microbatches whose stage inputs this rank held at once, and "head_calls".
last_schedule: Dict[str, Any] = {}


def stage_layers(n_layers: int, stage: int, stages: int) -> range:
    """The global layer indices stage ``stage`` of ``stages`` owns."""
    if n_layers % stages:
        raise ValueError(f"{n_layers} layers not divisible over {stages} pipeline stages")
    per = n_layers // stages
    return range(stage * per, (stage + 1) * per)


def _check(cfg: Any, stages: int) -> None:
    if cfg.moe_experts > 0:
        raise ValueError("the pipeline supports dense configs only (moe_experts > 0)")
    stage_layers(cfg.n_layers, 0, stages)


def _staged(model: nn.Module, stages: int) -> None:
    _check(model.cfg, stages)
    stage = getattr(model, "stage", None)
    if stage is None or stage[1] != stages:
        raise ValueError(f"the model holds no stage of {stages}: call pipeline_stage first")


def pipeline_stage(model: nn.Module, ftmesh: Any, pipe_axis: str = "pipeline") -> nn.Module:
    """Keeps this rank's stage of ``model`` (a ``Transformer`` every stage
    built from one seed): its layer modules, numbered from 0, beside the
    replicated embedding and head.  ``model.stage`` records (stage, stages,
    the global layer range).  In place; returns ``model``.  The pipeline
    composes with "data" only: another axis above 1 raises."""
    stages, stage = ftmesh.size(pipe_axis), ftmesh.coordinate(pipe_axis)
    _check(model.cfg, stages)
    for axis in INTRA_GROUP_AXES:
        if axis not in (pipe_axis, "data") and ftmesh.size(axis) > 1:
            raise ValueError(f"the pipeline composes with 'data' only; mesh axis {axis!r} has "
                             f"size {ftmesh.size(axis)}")
    owned = stage_layers(model.cfg.n_layers, stage, stages)
    model.layers = nn.ModuleList(model.layers[i] for i in owned)
    model.stage = (stage, stages, owned)
    model.ftmesh = ftmesh
    return model


class _Keep(torch.autograd.Function):
    """``fresh`` forward; ``dead`` gets a zero gradient, so the hop that
    produced it stays in the graph (stage 0 discards what it receives)."""

    @staticmethod
    def forward(ctx, fresh, dead):
        ctx.dead = (dead.shape, dead.dtype, dead.device)
        return fresh.view_as(fresh)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.dead
        return grad, torch.zeros(shape, dtype=dtype, device=device)


class _FromLastStage(torch.autograd.Function):
    """The last stage's loss on every stage.  Backward: the gradient reaches
    ``local`` (the loss on the last stage, a zero-weighted anchor on the
    others) and, once the whole backward has run, ``finish`` sums and
    averages the gradients (queued on autograd's engine)."""

    @staticmethod
    def forward(ctx, local, group, last, finish):
        ctx.finish = finish
        value = local.detach().float().clone()
        dist.broadcast(value, dist.get_global_rank(group, last), group=group)
        return value

    @staticmethod
    def backward(ctx, grad):
        torch.autograd.Variable._execution_engine.queue_callback(ctx.finish)
        return grad, None, None, None


def _groups(ftmesh: Any, pipe_axis: str, batch_axis: Optional[str]) -> Tuple[Any, Any]:
    pipe = ftmesh.group(pipe_axis)
    data = None
    if batch_axis is not None and ftmesh.size(batch_axis) > 1:
        data = ftmesh.group(batch_axis)
    return pipe, data


def _finish_grads(model: nn.Module, pipe: Any, data: Any) -> None:
    """Sums the replicated parameters' gradients over the stages (each has
    its share: the embedding's on stage 0, the head's on the last) and
    averages every gradient over "data"."""
    layers = {id(p) for p in model.layers.parameters()}
    for p in model.parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        if id(p) not in layers:
            dist.all_reduce(p.grad, group=pipe)
        if data is not None:
            dist.all_reduce(p.grad, group=data)
            p.grad.div_(dist.get_world_size(data))


def pipeline_apply(
    layers: Any,
    x: torch.Tensor,
    body_fn: Callable[[nn.Module, torch.Tensor], torch.Tensor],
    *,
    group: Any,
    num_microbatches: int,
) -> torch.Tensor:
    """The GPipe forward over the ring ``group``, differentiable.

    Args:
        layers: this stage's layer modules, in global order.
        x: [B, S, E]; stage 0's is the input, the others' only its shape.
        body_fn: one layer: (layer, [mb, S, E]) -> [mb, S, E].
        num_microbatches: M; B must divide into it.  The bubble fraction is
            (P - 1) / (M + P - 1).

    Returns the pipeline's output [B, S, E] on the last stage; on the
    others the tail of the stage's chain of ticks, which the caller weights
    by zero in its loss (its backward runs this stage's hops)."""
    P, s, M = dist.get_world_size(group), dist.get_rank(group), num_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible into {M} microbatches")
    x_mb = x.chunk(M)
    act = torch.zeros_like(x_mb[0]).requires_grad_()
    outs: List[torch.Tensor] = []
    held = [0, 0]  # now, most

    def released(grad):
        held[0] -= 1

    ticks = M + P - 1
    for t in range(ticks):
        m = t - s
        if s == 0:
            act = _Keep.apply(x_mb[min(t, M - 1)], act)
        if 0 <= m < M:
            held[0] += 1
            held[1] = max(held)
            if act.requires_grad:
                act.register_hook(released)
            for layer in layers:
                act = body_fn(layer, act)
            if s == P - 1:
                outs.append(act)
        if t < ticks - 1:
            act = ring_hop(act, group)
    last_schedule.update(schedule="gpipe", max_held=held[1], microbatches=M, stages=P)
    return torch.cat(outs) if s == P - 1 else act


def _body(cfg: Any) -> Callable[[nn.Module, torch.Tensor], torch.Tensor]:
    """One decoder layer on a [mb, S, E] activation: the single layer call
    both schedules share (a checkpoint around it under cfg.remat)."""
    from torch.utils.checkpoint import checkpoint

    def body(layer: nn.Module, a: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(a.shape[1], device=a.device)
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(layer, a, positions, use_reentrant=False,
                              preserve_rng_state=False)[0]
        return layer(a, positions)[0]

    return body


def pipeline_apply_sharded(model: nn.Module, x: torch.Tensor, ftmesh: Any, *,
                           num_microbatches: int, pipe_axis: str = "pipeline") -> torch.Tensor:
    """:func:`pipeline_apply` of ``model``'s stage (:func:`pipeline_stage`)
    over the mesh's ``pipe_axis``; each rank feeds its own slice of the
    batch over the other axes."""
    return pipeline_apply(model.layers, x, _body(model.cfg), group=ftmesh.group(pipe_axis),
                          num_microbatches=num_microbatches)


def pipeline_loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor], ftmesh: Any, *,
                     num_microbatches: int, pipe_axis: str = "pipeline",
                     batch_axis: Optional[str] = "data") -> torch.Tensor:
    """Next-token CE of ``model``'s stage (:func:`pipeline_stage`) with its
    layers pipelined over ``pipe_axis`` as a GPipe schedule: the same
    value on every rank.  ``.backward()`` leaves every parameter's
    gradient whole on every stage: summed over the stages for the
    replicated ones and averaged over ``batch_axis`` (a rank's slice of the
    batch over it)."""
    cfg = model.cfg
    pipe, data = _groups(ftmesh, pipe_axis, batch_axis)
    P, s = dist.get_world_size(pipe), dist.get_rank(pipe)
    _staged(model, P)
    tokens = batch["tokens"]
    if s == 0:
        x = model.embed_tokens(tokens)
    else:
        x = torch.zeros(*tokens.shape, cfg.d_model, dtype=cfg.dtype, device=tokens.device)
    out = pipeline_apply(model.layers, x, _body(cfg), group=pipe,
                         num_microbatches=num_microbatches)
    last_schedule["head_calls"] = 0
    if s == P - 1:
        local = model.lm_head_loss(out, batch["targets"])
        last_schedule["head_calls"] = 1
    else:
        local = out.sum() * 0.0
    loss = _FromLastStage.apply(local, pipe, P - 1, lambda: _finish_grads(model, pipe, data))
    if data is not None:
        mean = loss.detach().clone()
        dist.all_reduce(mean, group=data)
        # The data mean of the value; the gradient is averaged in _finish_grads.
        loss = loss + (mean / dist.get_world_size(data) - loss.detach())
    return loss


def pipeline_1f1b_value_and_grad(model: nn.Module, batch: Dict[str, torch.Tensor], ftmesh: Any,
                                 *, num_microbatches: int, pipe_axis: str = "pipeline",
                                 batch_axis: Optional[str] = "data") -> torch.Tensor:
    """The loss of ``model``'s stage under a 1F1B schedule, its gradients
    accumulated into ``.grad`` (as ``.backward()`` would): a drop-in for
    :func:`pipeline_loss_fn` and its backward, for
    ``TrainStep(value_and_grad_fn=...)``.  Returns the loss (no graph), the
    same on every rank; the gradients are whole on every stage as there."""
    cfg = model.cfg
    pipe, data = _groups(ftmesh, pipe_axis, batch_axis)
    P, s, M = dist.get_world_size(pipe), dist.get_rank(pipe), num_microbatches
    _staged(model, P)
    R = min(M, 2 * P - 1)
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    tokens_mb, targets_mb = tokens.chunk(M), targets.chunk(M)
    body = _body(dataclasses.replace(cfg, remat=False))
    dev = tokens.device
    zeros = torch.zeros(B // M, S, cfg.d_model, dtype=cfg.dtype, device=dev)
    act_in, cot_in = zeros, zeros
    ring: List[Optional[List[torch.Tensor]]] = [None] * R
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    held = [0, 0]
    head_calls = 0
    for t in range(M + 2 * (P - 1)):
        # Forward phase: microbatch m_f, keeping each layer's input.
        m_f = t - s
        out = zeros
        dact = zeros
        if 0 <= m_f < M:
            with torch.no_grad():
                a = model.embed_tokens(tokens_mb[m_f]) if s == 0 else act_in
                inputs = []
                for layer in model.layers:
                    inputs.append(a)
                    a = body(layer, a)
                out = a
            ring[m_f % R] = inputs
            held[0] += 1
            held[1] = max(held)
            if s == P - 1:
                # Head, loss and the cotangent that seeds this tick's backward.
                leaf = out.detach().requires_grad_()
                loss_m = model.lm_head_loss(leaf, targets_mb[m_f]) / M
                loss_m.backward()
                head_calls += 1
                loss_acc += loss_m.detach().float()
                dact = leaf.grad
        act_in = ring_shift(out, pipe, 1)

        # Backward phase: microbatch m_b, one layer at a time from its input.
        m_b = t - 2 * (P - 1) + s
        da = zeros
        if 0 <= m_b < M:
            cot = dact if s == P - 1 else cot_in
            inputs = ring[m_b % R]
            ring[m_b % R] = None
            held[0] -= 1
            for layer, a_in in zip(reversed(model.layers), reversed(inputs)):
                a_in = a_in.detach().requires_grad_()
                with torch.enable_grad():
                    o = body(layer, a_in)
                torch.autograd.backward(o, cot.to(o.dtype))
                cot = a_in.grad
            da = cot
            if s == 0:
                # Stage 0 backpropagates the embedding of this microbatch.
                with torch.enable_grad():
                    e = model.embed_tokens(tokens_mb[m_b])
                torch.autograd.backward(e, da.to(e.dtype))
        cot_in = ring_shift(da, pipe, -1)

    # The loss and the replicated gradients live on single stages: summed
    # over the stages, then averaged over "data".
    dist.all_reduce(loss_acc, group=pipe)
    if data is not None:
        dist.all_reduce(loss_acc, group=data)
        loss_acc /= dist.get_world_size(data)
    _finish_grads(model, pipe, data)
    last_schedule.update(schedule="1f1b", max_held=held[1], microbatches=M, stages=P,
                         ring=R, head_calls=head_calls)
    return loss_acc
