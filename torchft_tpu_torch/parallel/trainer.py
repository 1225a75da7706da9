"""TrainStep: one model's training step, plain or fault-tolerant.

The counterpart of ``torchft_tpu/parallel/trainer.py``:

  - ``full_step``: loss -> grads -> optimizer step, no cross-group traffic;
  - ``grads`` / ``apply``: the split form for fault-tolerant training, so
    the Manager's cross-group gradient average runs between them;
  - ``ft_step``: grads -> ``GradientAverager`` -> ``should_commit`` ->
    optimizer step only if the vote passed, or, with ``overlap_commit``,
    the optimizer step dispatched before the vote and undone if it fails.

PyTorch updates parameters and optimizer state in place, so the step returns
only the loss (and the commit decision).  A step on which the Manager healed
has already installed the fetched state through its ``load_state_dict``
callback when ``should_commit`` returns; the optimizer step then applies
the averaged gradients to that state, exactly as the donor does.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from torchft_tpu_torch.ddp import GradientAverager, local_tensor
from torchft_tpu_torch.manager import Manager

logger = logging.getLogger(__name__)

# Fraction of the remaining device memory the speculative step's copy of
# the state may claim; the rest is headroom for the optimizer's temporaries.
_SPECULATION_HEADROOM = 0.9


class _Held(NamedTuple):
    """An optimizer-state tensor and its snapshot copy."""

    tensor: torch.Tensor
    copy: torch.Tensor


def _tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def tree_device_bytes(tree: Any, device: Any = None) -> int:
    """Bytes of the tensors in ``tree`` (a tensor, or dicts, lists and
    tuples of them); with ``device``, of those on that device only (AdamW's
    ``step`` counter stays on the host unless the optimizer is capturable or
    fused).  Over the parameters and the optimizer's state this is the copy
    that a speculative step holds.  A DTensor counts its local shard: what
    it costs this rank's device."""
    want = torch.device(device) if device is not None else None
    total = 0
    for t in map(local_tensor, _tensor_leaves(tree)):
        if want is None or (t.device.type == want.type
                            and (want.index is None or t.device.index == want.index)):
            total += t.numel() * t.element_size()
    return total


def device_memory(device: Any) -> Optional[Dict[str, int]]:
    """The device's memory as the speculation budget reads it, or None where
    the device keeps no statistics (the CPU).

    ``limit`` is what this process may hold: the card's free memory
    (``torch.cuda.mem_get_info``, so what other processes hold is left out)
    plus what this process's allocator has reserved.  ``high_water`` is the
    allocator's peak of allocated bytes (or the current bytes, if larger):
    read after a committed step, it covers the step's activations and the
    optimizer's temporaries beside the resident state."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    if not stats:
        return None
    reserved = stats.get("reserved_bytes.all.current")
    allocated = stats.get("allocated_bytes.all.current")
    if reserved is None or allocated is None:
        return None
    peak = stats.get("allocated_bytes.all.peak")
    free, total = torch.cuda.mem_get_info(dev)
    return {"limit": int(free) + int(reserved),
            "high_water": int(max(allocated, peak) if peak is not None else allocated),
            "free": int(free), "total": int(total), "reserved": int(reserved)}


def speculation_fits(extra_bytes: int, device: Any) -> Optional[bool]:
    """Whether ``extra_bytes`` more fit on ``device`` above the allocator's
    peak, with 10% headroom (``device_memory``).  None where the device
    keeps no memory statistics: the caller decides the default."""
    mem = device_memory(device)
    if mem is None:
        return None
    return extra_bytes <= (mem["limit"] - mem["high_water"]) * _SPECULATION_HEADROOM


@dataclasses.dataclass
class TrainStep:
    """Args:
        model: the module whose parameters train.
        optimizer: a ``torch.optim.Optimizer`` over ``model``'s parameters.
        loss_fn: (model, batch) -> scalar loss.
        manager: the group's Manager (needed by ``ft_step`` only).
        bucket_bytes: the ``GradientAverager``'s bucket size.
        overlap_commit: hide the commit vote behind a speculatively
            dispatched optimizer step (see ``ft_step``).  The speculative
            step holds a copy of the parameters and the optimizer state
            until the vote.  Default None: the first committed ``ft_step``
            runs serially, and then the device's memory statistics decide
            (``speculation_fits``): overlap if the copy fits above the
            allocator's peak with 10% headroom, and also where the device
            keeps no statistics (an out-of-memory error is loud, a silently
            serialized vote is not).  The choice sticks.  Pass True or
            False to force it.
        value_and_grad_fn: (model, batch) -> scalar loss, the gradients
            left in ``param.grad``: for a loss that runs its own backward,
            the 1F1B pipeline's (``parallel.pipeline``).  Exactly one of
            ``loss_fn`` and ``value_and_grad_fn``.
    """

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    loss_fn: Optional[Callable[[torch.nn.Module, Any], torch.Tensor]] = None
    manager: Optional[Manager] = None
    bucket_bytes: int = 25 << 20
    overlap_commit: Optional[bool] = None
    value_and_grad_fn: Optional[Callable[[torch.nn.Module, Any], torch.Tensor]] = None

    def __post_init__(self) -> None:
        if (self.loss_fn is None) == (self.value_and_grad_fn is None):
            raise ValueError("TrainStep needs exactly one of loss_fn / value_and_grad_fn")
        self._averager: Optional[GradientAverager] = None
        self._overlap_resolved: Optional[bool] = self.overlap_commit
        # What decided overlap_commit=None: the extra bytes, the device's
        # memory (device_memory) and the verdict; None until decided.
        self.overlap_decision: Optional[Dict[str, Any]] = None
        # The last ft_step's speculation: the copy's bytes, whether the
        # state was restored, and the copy's timing.
        self.last_speculation: Optional[Dict[str, Any]] = None

    @property
    def averager(self) -> Optional[GradientAverager]:
        """The gradient averager of ``ft_step`` (its ``last_stats`` split the
        last exchange), or None before the first fault-tolerant step."""
        return self._averager

    def grads(self, batch: Any) -> torch.Tensor:
        """Forward and backward; leaves the gradients in ``param.grad``."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.value_and_grad_fn is not None:
            return self.value_and_grad_fn(self.model, batch).detach()
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        return loss.detach()

    def apply(self) -> None:
        self.optimizer.step()

    def full_step(self, batch: Any) -> torch.Tensor:
        """Loss, grads and update with no cross-group averaging."""
        loss = self.grads(batch)
        self.apply()
        return loss

    # -- the speculative step's copy of the state ------------------------------

    def _trained(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def state_tensors(self) -> List[torch.Tensor]:
        """The parameters the optimizer trains and every tensor of its state:
        what a speculative step copies."""
        out = []
        for p in self._trained():
            out.append(p)
            if p in self.optimizer.state:
                out.extend(_tensor_leaves(self.optimizer.state[p]))
        return out

    def _snapshot(self) -> list:
        """Copies of every trained parameter and its optimizer state, made
        on the caller's (the train thread's) stream; a DTensor's copy is of
        its local shard.  Each state tensor is kept beside its copy."""
        snap = []
        with torch.no_grad():
            for p in self._trained():
                state = self.optimizer.state[p] if p in self.optimizer.state else None
                saved = None if state is None else {
                    k: _Held(v, local_tensor(v).clone()) if torch.is_tensor(v)
                    else copy.deepcopy(v)
                    for k, v in state.items()}
                snap.append((p, local_tensor(p).detach().clone(), saved))
        return snap

    def _restore(self, snap: list) -> None:
        """Copies the snapshot back in place: the optimizer and the Manager's
        state-dict callbacks hold these very tensors."""
        opt_state = self.optimizer.state
        with torch.no_grad():
            for p, value, saved in snap:
                local_tensor(p).copy_(value)
                if saved is None:
                    opt_state.pop(p, None)  # state the failed step created
                    continue
                state = opt_state[p]
                for k in [k for k in state if k not in saved]:
                    del state[k]
                for k, v in saved.items():
                    if not isinstance(v, _Held):
                        state[k] = v
                        continue
                    held, value = v
                    cur = state.get(k)
                    if not (torch.is_tensor(cur) and type(cur) is type(held)
                            and cur.shape == held.shape and cur.dtype == held.dtype
                            and cur.device == held.device):
                        cur = state[k] = held  # the step replaced it: the kept one goes back
                    local_tensor(cur).copy_(value)

    def snapshot_ms(self) -> Optional[float]:
        """Milliseconds of the last ``ft_step``'s snapshot copy: device time
        from CUDA events on the card (waits for the copy), host time on the
        CPU; None if that step did not speculate."""
        spec = self.last_speculation
        if spec is None:
            return None
        events = spec.get("events")
        if events is None:
            return spec["snapshot_host_ms"]
        events[1].synchronize()
        return events[0].elapsed_time(events[1])

    # -- fault-tolerant step ---------------------------------------------------

    def _resolve_overlap(self) -> None:
        """Decides overlap_commit=None from the device's memory after a
        committed step."""
        tensors = self.state_tensors()
        device = tensors[0].device if tensors else torch.device("cpu")
        extra = tree_device_bytes(tensors, device)
        mem = device_memory(device)
        fits = speculation_fits(extra, device)
        self._overlap_resolved = True if fits is None else fits
        self.overlap_decision = {"overlap": self._overlap_resolved, "fits": fits,
                                 "extra_bytes": extra, "device": str(device), **(mem or {})}
        logger.info("overlap_commit auto: %s (extra %.3f GB for the speculative step; device "
                    "memory %s)", self._overlap_resolved, extra / 1e9,
                    "unavailable" if mem is None else
                    f"free {mem['free'] / 1e9:.3f} GB, limit {mem['limit'] / 1e9:.3f} GB, "
                    f"peak {mem['high_water'] / 1e9:.3f} GB")

    def _speculative_commit(self, manager: Manager) -> bool:
        """Copy the state, dispatch the optimizer step, vote while the device
        applies it; a failed or raising vote puts the copy back."""
        tensors = self.state_tensors()
        on_card = bool(tensors) and tensors[0].is_cuda
        events = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  if on_card else None)
        t0 = time.perf_counter()
        if events:
            events[0].record()
        snap = self._snapshot()
        if events:
            events[1].record()
        spec: Dict[str, Any] = {"snapshot_bytes": tree_device_bytes(tensors),
                                "snapshot_host_ms": (time.perf_counter() - t0) * 1e3,
                                "events": events, "restored": False}
        self.last_speculation = spec
        # No try around the apply: a failed speculative step (an
        # out-of-memory error) raises, it does not become a serial step.
        self.apply()
        try:
            committed = manager.should_commit()
        except BaseException:
            self._restore(snap)
            spec["restored"] = True
            raise
        if not committed:
            self._restore(snap)
            spec["restored"] = True
        return committed

    def ft_step(self, batch: Any) -> Tuple[torch.Tensor, bool]:
        """One fault-tolerant step: local grads -> cross-group average ->
        commit vote -> update.  Returns (loss, committed).  The caller has
        called ``manager.start_quorum()`` for this step.

        With the overlap on, the optimizer step is dispatched before the
        vote, after a copy of the parameters and the optimizer state is
        taken on the train thread's stream: the device applies the update
        while the host blocks in ``should_commit`` (the JAX package's
        speculative apply; votes rarely fail).  A failed vote copies the
        state back in place, and a raising one does so before the error
        goes on, so the step ends with the last committed state either way
        (the erasure encoder's feed at the next ``start_quorum`` relies on
        it).  A step that heals takes the serial step: the Manager installs
        the fetched state inside ``should_commit``, over a speculative
        update, and that holds for a group that re-fetches after failed
        commits while it participates as well as for one that does not
        participate.  The donor's served copy was made at quorum time,
        which the gradient average waited for, so it precedes the update.
        """
        manager = self.manager
        if manager is None:
            raise ValueError("ft_step needs a TrainStep with a manager")
        if self._averager is None or self._averager.manager is not manager:
            self._averager = GradientAverager(manager, self.bucket_bytes)
        # overlap_commit=None: the first committed step runs serially and
        # the allocator's peak after it, which covers the step's activations
        # and the optimizer's temporaries, decides.
        resolve_after = self._overlap_resolved is None
        self.last_speculation = None
        loss = self.grads(batch)
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._averager.allreduce([p.grad for p in params])
        if self._overlap_resolved and not manager.is_healing() and manager.is_participating():
            return loss, self._speculative_commit(manager)
        committed = manager.should_commit()
        if committed:
            self.apply()
        # Only a committed step decides: a failed vote skipped the apply, so
        # the peak would leave out the optimizer's footprint.
        if resolve_after and committed:
            self._resolve_overlap()
        return loss, committed
