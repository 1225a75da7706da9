"""Streaming semi-sync DiLoCo: fragment-synced outer rounds that overlap
inner steps.

The counterpart of ``torchft_tpu/semisync/diloco.py`` (DiLoCo,
arXiv:2311.08105; Streaming DiLoCo, arXiv:2501.18512):

  - the outer state is fragmented on the shared bucket planner
    (``semisync/fragments.py``);
  - each round's quorum starts at the round's first inner step
    (synchronous quorum: a healing group holds the committed weights
    before any pseudogradient);
  - each fragment's pseudogradient round, the codec's encode (int8 or int4
    with error feedback, bf16, f32; ``semisync/codec.py``) then an
    allreduce over the striped ring, runs on the engine's background
    worker from a staggered inner-step slot, so its wire time hides behind
    the inner steps left;
  - the outer optimizer (one state per fragment) applies only after the
    round's commit vote passes, so a failed sync never corrupts the model,
    the backup or the outer state; the backup and the outer state travel
    with every heal through ``Manager.register_state_dict_fn``;
  - with a ``set_fragment_params`` hook, a committed fragment lands on the
    model as soon as its outer step is computed.

The parameters are a list of tensors: ``get_params()`` returns them (on
the card or the CPU), and ``set_params(leaves)`` /
``set_fragment_params(indices, leaves)`` copy the given CPU tensors into
the model's parameters in place (they are the backup's own tensors: copy
from them, never keep them).  The backup and the outer state live on the
host as CPU tensors, and the outer transform is
:func:`torchft_tpu_torch.semisync.outer.sgd` (optax's ``sgd``, which the
JAX package takes).  ``torchft_tpu_torch.local_sgd.DiLoCo`` is the blocking
wrapper (``stream=False``, ``codec="auto"``, ``outer_scope="tree"``).

Knobs (each overridable per instance):
  TPUFT_SEMISYNC_CODEC            int8 | int4 | bf16 | f32 | auto (default int8)
  TPUFT_SEMISYNC_FRAGMENT_BYTES   fragment size (default 4 MiB)
  TPUFT_SEMISYNC_STREAM           1 = background streaming (default 1)
  TPUFT_SEMISYNC_FRAGMENT_COMMIT  1 = one quorum and vote per fragment (default 0)
  TPUFT_SEMISYNC_METRICS_PORT     serve tpuft_semisync_* at /metrics (unset: off)
"""

from __future__ import annotations

import os
from types import TracebackType
from typing import Any, Callable, Dict, List, Optional, Sequence, Type

import torch

from torchft_tpu_torch.ddp import _env_flag
from torchft_tpu_torch.manager import ExceededMaxRetriesError
from torchft_tpu_torch.semisync.codec import CODECS, TPUFT_SEMISYNC_CODEC_ENV, make_codec
from torchft_tpu_torch.semisync.engine import SyncEngine, _report
from torchft_tpu_torch.semisync.fragments import Fragment, FragmentPlan, as_host_tensor
from torchft_tpu_torch.semisync.metrics import SemiSyncMetrics
from torchft_tpu_torch.semisync.outer import apply_updates

__all__ = [
    "StreamingDiLoCo",
    "TPUFT_SEMISYNC_STREAM_ENV",
    "TPUFT_SEMISYNC_FRAGMENT_COMMIT_ENV",
]

TPUFT_SEMISYNC_STREAM_ENV = "TPUFT_SEMISYNC_STREAM"
TPUFT_SEMISYNC_FRAGMENT_COMMIT_ENV = "TPUFT_SEMISYNC_FRAGMENT_COMMIT"


def _codec_from_env(explicit: Optional[str]) -> str:
    if explicit is not None:
        if explicit not in CODECS:
            raise ValueError(f"unknown semisync codec {explicit!r}; expected one of {CODECS}")
        return explicit
    raw = os.environ.get(TPUFT_SEMISYNC_CODEC_ENV, "").strip().lower()
    if not raw:
        return "int8"
    if raw not in CODECS:
        # The default is lossy: a typo must not silently become int8.
        raise ValueError(f"${TPUFT_SEMISYNC_CODEC_ENV}={raw!r} is not a semisync codec; "
                         f"expected one of {CODECS}")
    return raw


class StreamingDiLoCo:
    """Fragment-streamed DiLoCo (see the module docstring)::

        with StreamingDiLoCo(manager, get_params, set_params,
                             outer_tx=outer.sgd(0.7, momentum=0.9, nesterov=True),
                             sync_every=100) as diloco:
            for batch in data:
                inner_step(batch)      # the local optimizer, in place
                diloco.step()          # counts, streams fragments, maybe syncs

    Needs a Manager with ``use_async_quorum=False``.

    ``outer_scope``: ``"fragment"`` (default) keeps one outer state per
    fragment and applies the outer update fragment by fragment;
    ``"tree"`` runs one update over the whole pseudogradient list at the
    round's end (the blocking wrapper's semantics, which transforms that
    couple leaves need).  ``set_fragment_params(indices, leaves)``
    (fragment scope): a committed round writes each fragment back as its
    outer step is computed, and the whole-list ``set_params`` at the
    round's end is skipped; an aborted round still resets through
    ``set_params``.  ``fragment_commit`` (``TPUFT_SEMISYNC_FRAGMENT_COMMIT``,
    default off; needs ``set_fragment_params``): every fragment's round is
    its own Manager step, its quorum armed at its slot on the train thread
    and its vote and outer step at the next fragment's slot, so a
    membership change mid-round fails one fragment's vote (that fragment
    rolls back alone) instead of the round's.
    """

    def __init__(
        self,
        manager: Any,
        get_params: Callable[[], Sequence[Any]],
        set_params: Callable[[List[torch.Tensor]], None],
        outer_tx: Any,
        sync_every: int,
        fragment_bytes: Optional[int] = None,
        codec: Optional[str] = None,
        stream: Optional[bool] = None,
        outer_scope: str = "fragment",
        state_dict_key: str = "diloco",
        set_fragment_params: Optional[Callable[[List[int], List[torch.Tensor]], None]] = None,
        fragment_commit: Optional[bool] = None,
    ) -> None:
        if manager._use_async_quorum:
            raise ValueError("StreamingDiLoCo requires synchronous quorum: construct the "
                             "Manager with use_async_quorum=False")
        assert sync_every >= 1, "sync_every must be >= 1"
        if outer_scope not in ("fragment", "tree"):
            raise ValueError(f"outer_scope must be 'fragment' or 'tree', got {outer_scope!r}")
        if set_fragment_params is not None and outer_scope != "fragment":
            raise ValueError("set_fragment_params requires outer_scope='fragment': a "
                             "whole-tree outer update has no per-fragment commit moment")
        self._manager = manager
        self._get_params = get_params
        self._set_params = set_params
        self._outer_tx = outer_tx
        self._sync_every = sync_every
        self._outer_scope = outer_scope
        self._set_fragment_params = set_fragment_params
        self._fragment_commit = (bool(fragment_commit) if fragment_commit is not None
                                 else _env_flag(TPUFT_SEMISYNC_FRAGMENT_COMMIT_ENV, False))
        if self._fragment_commit and set_fragment_params is None:
            raise ValueError("fragment_commit requires set_fragment_params: a failed fragment "
                             "vote rolls back only that fragment's leaves")
        self._local_step = 0
        self._armed = False
        self._arm_attempted = False
        self._issued: set = set()
        self._round_closed = False
        self._voted = False
        self._vote_passed = False
        # Fragment-commit round state.
        self._pending_fragment: Optional[Fragment] = None
        self._round_failed = 0
        self._round_open = False
        self._post_vote = False

        self._codec_name = _codec_from_env(codec)
        self._stream = (bool(stream) if stream is not None
                        else _env_flag(TPUFT_SEMISYNC_STREAM_ENV, True))

        # The last-committed parameters, on the host; replaced, never
        # updated in place.
        self._leaves: List[torch.Tensor] = [as_host_tensor(t).clone() for t in get_params()]
        self._plan = FragmentPlan([(tuple(t.shape), t.dtype) for t in self._leaves],
                                  fragment_bytes)
        self._schedule = self._plan.schedule(sync_every)
        self._codecs = [make_codec(self._codec_name, f) for f in self._plan.fragments]
        self._refresh_codec_backups()
        if outer_scope == "fragment":
            self._outer_states: Any = [
                outer_tx.init([self._leaves[i] for i in f.bucket.indices])
                for f in self._plan.fragments
            ]
        else:
            self._outer_states = outer_tx.init(list(self._leaves))

        replica_id = ""
        try:
            replica_id = manager.replica_id()
        except Exception:  # noqa: BLE001 - stand-in managers
            pass
        self.metrics = SemiSyncMetrics(codec=self._codec_name, replica_id=str(replica_id))
        worker_metrics = getattr(manager, "worker_metrics", None)
        if worker_metrics is not None and getattr(worker_metrics, "serving", False):
            worker_metrics.add_section(self.metrics.render_prometheus)
        else:
            self.metrics.serve()
        self._engine = SyncEngine(manager, self._codecs, stream=self._stream,
                                  metrics=self.metrics)
        # The outer state travels with every heal: a fresh-init backup would
        # make the healed group's next pseudogradient silently wrong.
        manager.register_state_dict_fn(state_dict_key, self._load_outer_state,
                                       self._save_outer_state)

    # -- context manager -------------------------------------------------------

    def __enter__(self) -> "StreamingDiLoCo":
        return self

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc_value: Optional[BaseException],
                 traceback: Optional[TracebackType]) -> bool:
        self._engine.shutdown()
        self.metrics.close()
        return False

    # -- introspection -----------------------------------------------------------

    @property
    def backup_params(self) -> List[torch.Tensor]:
        """The last-committed parameters (CPU tensors; read only)."""
        return list(self._leaves)

    @backup_params.setter
    def backup_params(self, value: Sequence[Any]) -> None:
        self._leaves = [as_host_tensor(v) for v in value]
        self._refresh_codec_backups()

    @property
    def codec_name(self) -> str:
        return self._codec_name

    @property
    def num_fragments(self) -> int:
        return len(self._plan)

    @property
    def plan(self) -> FragmentPlan:
        return self._plan

    def _refresh_codec_backups(self) -> None:
        for frag, c in zip(self._plan.fragments, self._codecs):
            c.set_backup(frag.pack(self._leaves))

    # -- the state a heal carries ----------------------------------------------

    def _save_outer_state(self) -> Dict[str, Any]:
        # The backup and outer-state tensors are replaced, never updated in
        # place, so these references are a consistent snapshot.
        return {"backup": list(self._leaves), "outer_state": self._outer_states,
                "outer_scope": self._outer_scope}

    def _load_outer_state(self, state: Dict[str, Any]) -> None:
        # Validated before anything changes: a state of the other scope
        # would fail at the next commit, after the vote.  The raise latches
        # at the heal and fails every commit until the deployment is fixed.
        saved_scope = state.get("outer_scope", "tree")
        if saved_scope != self._outer_scope:
            raise ValueError(
                f"diloco state dict carries outer_scope={saved_scope!r} outer state but this "
                f"instance runs outer_scope={self._outer_scope!r}; construct with the matching "
                "scope (the DiLoCo wrapper is 'tree') or re-checkpoint")
        self.backup_params = state["backup"]
        self._outer_states = state["outer_state"]
        # Residuals are this group's untransmitted remainders, not model
        # state: a healed group starts with none.
        for c in self._codecs:
            c.on_abort()

    # -- the train loop ------------------------------------------------------------

    def step(self) -> None:
        """Call after each inner optimizer step.  In stream mode the round's
        first call arms its quorum and each call issues the fragments due
        at its slot; the round's last call runs :meth:`sync`."""
        if self._fragment_commit:
            self._step_fragment_commit()
            return
        if self._stream and not self._armed and not self._arm_attempted and len(self._plan):
            # One attempt a round (sync() makes the second): a lighthouse
            # outage must not stall every inner step for a quorum timeout.
            self._arm_attempted = True
            try:
                self._manager.start_quorum()
                self._armed = True
                self._engine.begin_round()
            except Exception as e:  # noqa: BLE001 - latched, keeps the cadence
                _report(self._manager, e)
        self._local_step += 1
        if self._stream and self._armed:
            due = [f for f in self._schedule.get(self._local_step, ())
                   if f.index not in self._issued]
            if due:
                leaves = list(self._get_params())
                for frag in due:
                    self._issued.add(frag.index)
                    self._engine.submit(frag, leaves)
        if self._local_step >= self._sync_every:
            self.sync()

    def sync(self) -> None:
        """Ends the round: drains the fragments in flight, votes, and
        applies the outer updates only on a passed vote.  Errors before the
        vote latch, and the counter resets in a ``finally``, so every group
        starts the next round on the same cadence."""
        if self._fragment_commit:
            self._sync_fragment_commit()
            return
        self._round_closed = False
        self._voted = False
        self._vote_passed = False
        try:
            self._sync_inner()
        except ExceededMaxRetriesError:
            raise
        except Exception as e:  # noqa: BLE001 - latched, never desyncs the cadence
            if self._vote_passed:
                # Peers were told this round committed: crash and heal back
                # rather than run on different weights.
                raise
            _report(self._manager, e)
            # Quiesce the worker before touching round state.
            try:
                self._engine.drain()
            except Exception:  # noqa: BLE001 - stand-in managers
                pass
            if not self._voted:
                # The group's other ranks wait in the vote: vote False.
                try:
                    self._manager.should_commit()
                except Exception:  # noqa: BLE001 - the vote itself failing
                    pass
            if not self._round_closed:
                self._engine.end_round(committed=False)
            try:
                self._set_params(self.backup_params)
            except Exception:  # noqa: BLE001 - leave the local params standing
                pass
        finally:
            self._local_step = 0
            self._armed = False
            self._arm_attempted = False
            self._issued = set()

    def _sync_inner(self) -> None:
        if not self._armed:
            self._manager.start_quorum()
            self._armed = True
            self._engine.begin_round()
        # Fragments not streamed yet go now (all of them when blocking).
        leaves = None
        for frag in self._plan.fragments:
            if frag.index not in self._issued:
                self._issued.add(frag.index)
                if leaves is None:
                    leaves = list(self._get_params())
                self._engine.submit(frag, leaves)
        results = self._engine.drain()
        # Before the vote, which flushes the step's summary; the round's
        # step is read before a commit advances it.
        stats = self._engine.round_stats()
        self._note_summary(stats)
        round_step = self._round_step()
        self._voted = True
        committed = bool(self._manager.should_commit())
        self._vote_passed = committed
        applied_inplace = self._apply(results) if committed else False
        self._engine.end_round(committed=committed)
        self._round_closed = True
        self._emit_round(stats, committed, round_step)
        # Committed or not, the live params go back to the (new) backup,
        # unless every fragment was written back already.
        if not applied_inplace:
            self._set_params(self.backup_params)

    def _round_step(self) -> int:
        try:
            return int(self._manager.current_step())
        except (TypeError, ValueError):  # stand-in managers
            return -1

    # -- fragment-granular commit ------------------------------------------------------

    def _step_fragment_commit(self) -> None:
        """At a fragment's slot: settle the previous fragment's vote, then
        arm this fragment's quorum and issue its reduce."""
        self._local_step += 1
        due = [f for f in self._schedule.get(self._local_step, ()) if f.index not in self._issued]
        for frag in due:
            self._finish_pending_fragment()
            self._issue_fragment(frag)
        if self._local_step >= self._sync_every:
            self.sync()

    def _issue_fragment(self, frag: Fragment) -> None:
        self._issued.add(frag.index)
        self._pending_fragment = frag
        try:
            self._manager.start_quorum()
            self._armed = True
        except Exception as e:  # noqa: BLE001 - latched; the fragment's vote fails
            _report(self._manager, e)
            return
        if not self._round_open:
            self._engine.begin_round()
            self._round_open = True
        self._engine.submit(frag, list(self._get_params()))

    def _finish_pending_fragment(self) -> None:
        """Drains the outstanding fragment, votes, and applies or rolls back
        that fragment alone; a failure after a passed vote raises."""
        frag = self._pending_fragment
        if frag is None:
            return
        self._pending_fragment = None
        results: Dict[int, Any] = {}
        if self._armed:
            try:
                results = self._engine.drain()
            except Exception as e:  # noqa: BLE001 - stand-in managers
                _report(self._manager, e)
            self._note_summary(self._engine.round_stats())
        committed = False
        if self._armed:
            self._armed = False
            try:
                committed = bool(self._manager.should_commit())
            except ExceededMaxRetriesError:
                raise
            except Exception as e:  # noqa: BLE001 - the vote itself failing
                _report(self._manager, e)
        if not committed:
            self._round_failed += 1
        flat = results.get(frag.index) if committed else None
        if committed and flat is not None:
            self._post_vote = True
            self._apply_one_fragment(frag, flat)
            self._post_vote = False
        else:
            try:
                self._apply_one_fragment(frag, None)
            except Exception:  # noqa: BLE001 - leave the local params standing
                pass
        self._engine.promote_fragment(frag, committed)

    def _outer_step(self, k: int, frag: Fragment, flat: Any) -> None:
        """Fragment ``k``'s outer update of the backup from its averaged
        pseudogradient ``flat``."""
        pg = [view.contiguous() for _i, view in frag.unpack(flat)]
        backup = [self._leaves[i] for i in frag.bucket.indices]
        updates, self._outer_states[k] = self._outer_tx.update(pg, self._outer_states[k], backup)
        for i, new in zip(frag.bucket.indices, apply_updates(backup, updates)):
            self._leaves[i] = new

    def _write_back(self, frag: Fragment) -> None:
        assert self._set_fragment_params is not None
        self._set_fragment_params(list(frag.bucket.indices),
                                  [self._leaves[i] for i in frag.bucket.indices])

    def _apply_one_fragment(self, frag: Fragment, flat: Any) -> None:
        """One fragment's outer step (``flat``: its averaged pseudogradient)
        or rollback (``flat`` None), landed through the write-back hook."""
        if flat is not None:
            self._outer_step(frag.index, frag, flat)
            self._codecs[frag.index].set_backup(frag.pack(self._leaves))
        self._write_back(frag)

    def _sync_fragment_commit(self) -> None:
        """The round's end in fragment-commit mode: settle the last
        fragment, run never-issued ones as their own rounds, then account
        the round (no round vote, no whole-list reset)."""
        try:
            self._finish_pending_fragment()
            for frag in self._plan.fragments:
                if frag.index not in self._issued:
                    self._issue_fragment(frag)
                    self._finish_pending_fragment()
            stats = self._engine.round_stats()
            committed = self._round_failed == 0
            round_step = self._round_step()
            if self._round_open:
                self._engine.end_round(committed=committed, promote=False)
            self._emit_round(stats, committed, round_step)
        except ExceededMaxRetriesError:
            raise
        except Exception as e:  # noqa: BLE001 - latched, never desyncs the cadence
            if self._post_vote:
                raise
            _report(self._manager, e)
        finally:
            self._local_step = 0
            self._armed = False
            self._arm_attempted = False
            self._issued = set()
            self._pending_fragment = None
            self._round_failed = 0
            self._round_open = False
            self._post_vote = False

    def _apply(self, results: Dict[int, Any]) -> bool:
        """The outer step on the averaged pseudogradients, by fragment or
        over the whole list.  Deterministic, and the ring gives every group
        the same averages, so every group lands the same backup bit for
        bit.  True when the write-back hook already landed every leaf."""
        if self._outer_scope == "tree":
            pg = [torch.zeros_like(t) for t in self._leaves]
            for frag in self._plan.fragments:
                flat = results.get(frag.index)
                if flat is not None:
                    for i, view in frag.unpack(flat):
                        pg[i] = view.contiguous()
            updates, self._outer_states = self._outer_tx.update(pg, self._outer_states,
                                                                list(self._leaves))
            self._leaves = apply_updates(self._leaves, updates)
            self._refresh_codec_backups()
            return False
        write_back = self._set_fragment_params
        for k, frag in enumerate(self._plan.fragments):
            flat = results.get(frag.index)
            if flat is not None:
                self._outer_step(k, frag, flat)
            if write_back is not None:
                # Landed as soon as its step is computed (or rolled back:
                # the inner steps moved it, the backup stands).
                self._write_back(frag)
        self._refresh_codec_backups()
        return write_back is not None

    def _note_summary(self, stats: Dict[str, int]) -> None:
        note = getattr(self._manager, "note_summary_fields", None)
        if callable(note):
            try:
                note(semisync_fragments=stats["fragments"],
                     semisync_wire_bytes=stats["wire_bytes"], semisync_codec=self._codec_name)
            except Exception:  # noqa: BLE001 - telemetry only
                pass

    def _emit_round(self, stats: Dict[str, int], committed: bool, round_step: int) -> None:
        """The ``semisync_round`` event; the residual's norm (a reduction a
        fragment) only when a stream or a scrape can read it."""
        manager = self._manager
        residual_l2 = 0.0
        want_residual = self.metrics.serving
        try:
            want_residual = want_residual or bool(manager.metrics.enabled)
        except Exception:  # noqa: BLE001 - stand-in managers
            pass
        if want_residual:
            for c in self._codecs:
                fn = getattr(c, "residual_l2", None)
                if callable(fn):
                    residual_l2 += float(fn())
            self.metrics.observe_residual(residual_l2)
        try:
            manager.metrics.emit(
                "semisync_round", step=round_step, committed=committed,
                fragments=stats["fragments"], wire_bytes=stats["wire_bytes"],
                d2h_bytes=stats["d2h_bytes"], codec=self._codec_name, streamed=self._stream,
                writeback="fragment" if self._set_fragment_params is not None else "tree",
                residual_l2=round(residual_l2, 6),
            )
        except Exception:  # noqa: BLE001 - telemetry only
            pass
