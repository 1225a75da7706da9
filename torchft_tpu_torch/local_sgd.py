"""Communication-efficient replica synchronization: LocalSGD and DiLoCo.

The counterpart of ``torchft_tpu/local_sgd.py`` (reference torchft
``local_sgd.py``).  Both run many inner optimizer steps locally and
synchronize across replica groups every ``sync_every`` steps, with commit
gating, so a failed sync never corrupts the model.  The parameters are a
list of tensors: ``get_params()`` returns them and ``set_params(tensors)``
copies the given tensors into the model's parameters in place; ``step()``
is called after each inner step.

``DiLoCo`` is the blocking wrapper over
:class:`torchft_tpu_torch.semisync.StreamingDiLoCo` (``stream=False``,
``codec="auto"``, ``outer_scope="tree"``): the whole round, quorum, the
fragmented pseudogradient allreduce and the commit-gated outer step, runs
inside ``sync()``.  The pseudogradient is ``backup - local`` (the DiLoCo
paper's sign, arXiv:2311.08105).
"""

from __future__ import annotations

from types import TracebackType
from typing import Any, Callable, List, Optional, Sequence, Type

from torchft_tpu_torch.manager import ExceededMaxRetriesError, Manager

__all__ = ["LocalSGD", "DiLoCo"]


class LocalSGD:
    """Averages the raw parameters across replica groups every
    ``sync_every`` inner steps::

        with LocalSGD(manager, get_params, set_params, sync_every=100) as lsgd:
            for batch in data:
                inner_step(batch)
                lsgd.step()
    """

    def __init__(self, manager: Manager, get_params: Callable[[], Sequence[Any]],
                 set_params: Callable[[List[Any]], None], sync_every: int) -> None:
        assert sync_every >= 1, "sync_every must be >= 1"
        from torchft_tpu_torch.ddp import PerLeafGradientAverager

        self._manager = manager
        self._get_params = get_params
        self._set_params = set_params
        self._sync_every = sync_every
        self._local_step = 0
        self._averager = PerLeafGradientAverager(manager)

    def __enter__(self) -> "LocalSGD":
        return self

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc_value: Optional[BaseException],
                 traceback: Optional[TracebackType]) -> bool:
        return False

    def step(self) -> None:
        """Call after each inner optimizer step."""
        self._local_step += 1
        if self._local_step >= self._sync_every:
            self.sync()

    def sync(self) -> None:
        """Quorum, parameter averaging and the commit-gated copy back.
        Errors up to the vote latch and the counter resets in a
        ``finally``, so every group starts the next round on the same
        cadence (a rank that failed before voting still votes False).  The
        copy back after a passed vote is not latched: peers were told this
        group committed, so a failure there must crash and heal."""
        averaged = None
        committed = False
        voted = False
        try:
            self._manager.start_quorum()
            # Parameters, not gradients: full width on every wire.
            averaged = self._averager.allreduce(list(self._get_params()),
                                                allow_wire_compression=False)
            voted = True
            committed = bool(self._manager.should_commit())
        except ExceededMaxRetriesError:
            raise
        except Exception as e:  # noqa: BLE001 - latched, never desyncs the cadence
            try:
                self._manager.report_error(e)
            except Exception:  # noqa: BLE001 - stand-in managers
                pass
            if not voted:
                try:
                    self._manager.should_commit()
                except Exception:  # noqa: BLE001 - the vote itself failing
                    pass
        finally:
            self._local_step = 0
        if committed and averaged is not None:
            self._set_params(averaged)


class DiLoCo:
    """Inner/outer optimizer synchronization (DiLoCo, arXiv:2311.08105),
    blocking: a host backup of the last committed parameters; every
    ``sync_every`` inner steps the pseudogradients ``backup - local`` are
    averaged across groups and, only if the vote passes, the outer
    transform (``semisync.outer.sgd``, typically with Nesterov momentum)
    steps the backup, which then replaces the live parameters.  Needs a
    Manager with ``use_async_quorum=False``."""

    def __init__(self, manager: Manager, get_params: Callable[[], Sequence[Any]],
                 set_params: Callable[[List[Any]], None], outer_tx: Any,
                 sync_every: int) -> None:
        from torchft_tpu_torch.semisync import StreamingDiLoCo

        self._impl = StreamingDiLoCo(manager, get_params, set_params, outer_tx, sync_every,
                                     codec="auto", stream=False, outer_scope="tree")

    def __enter__(self) -> "DiLoCo":
        return self

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc_value: Optional[BaseException],
                 traceback: Optional[TracebackType]) -> bool:
        return self._impl.__exit__(exc_type, exc_value, traceback)

    @property
    def backup_params(self) -> List[Any]:
        return self._impl.backup_params

    @backup_params.setter
    def backup_params(self, value: Sequence[Any]) -> None:
        self._impl.backup_params = value

    def step(self) -> None:
        self._impl.step()

    def sync(self) -> None:
        """The pseudogradient round; errors latch and the counter resets."""
        self._impl.sync()
