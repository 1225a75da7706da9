"""The background fragment-sync engine of the streaming semi-sync plane.

The counterpart of ``torchft_tpu/semisync/engine.py``.  One engine per
:class:`~torchft_tpu_torch.semisync.diloco.StreamingDiLoCo`: at a fragment's
scheduled inner-step slot the train loop hands it (fragment, live leaves),
and the engine runs the fragment's pseudogradient round, the codec's encode
and then a quorum-scoped ``Manager.allreduce`` (participation, averaging,
deadlines, error latching and the vote's drain behave as on the gradient
plane), on one background worker while the inner steps go on.

Unlike JAX arrays, torch parameters change in place under the inner
optimizer, so the engine never lets the worker read them: ``submit`` runs
the codec's ``prepare`` on the train thread, which snapshots the fragment
in stream order (the device encode into fresh tensors, or a host copy),
and hands the worker only those results and an event.

Ordering: the one worker runs fragment rounds in submission order, and
every group derives the same schedule, so every group issues the same ring
ops in the same order (the striped ring's tag alignment).  A group whose
encode fails still sends zeros of the codec's payload dtype, with the
error latched, so its peers' rings stay aligned and the vote fails.

Each fragment round runs inside an ``outer_sync`` span on the worker, an
overlapped phase; run inline (``stream=False``) the same work blocks the
train thread and is spanned ``allreduce_merge``, as is the round-end
drain.  The round's counts and bytes go to ``step_summary`` through
``Manager.note_summary_fields`` and to a ``semisync_round`` event.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from torchft_tpu_torch.semisync.codec import FragmentCodec, Prepared
from torchft_tpu_torch.semisync.fragments import Fragment
from torchft_tpu_torch.semisync.metrics import SemiSyncMetrics

__all__ = ["SyncEngine"]


def _report(manager: Any, e: Exception) -> None:
    try:
        manager.report_error(e)
    except Exception:  # noqa: BLE001 - stand-in managers
        pass


class SyncEngine:
    """Streams fragment pseudogradient rounds in the background;
    ``stream=False`` runs each inline on the caller's thread (the blocking
    shape of the ``DiLoCo`` wrapper: still fragmented and encoded, not
    overlapped)."""

    def __init__(self, manager: Any, codecs: Sequence[FragmentCodec], stream: bool,
                 metrics: Optional[SemiSyncMetrics] = None) -> None:
        self._manager = manager
        self._codecs = list(codecs)
        self._stream = bool(stream)
        self.metrics = metrics if metrics is not None else SemiSyncMetrics()
        self._worker: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuft_semisync")
            if self._stream else None
        )
        self._lock = threading.Lock()
        self._futures: List[Future] = []
        self._results: Dict[int, Any] = {}
        self._round_wire_bytes = 0
        self._round_d2h_bytes = 0
        self._round_fragments = 0
        self._round_overlap_ms = 0.0

    def _timeout(self) -> float:
        try:
            return float(self._manager.timeout.total_seconds())
        except (AttributeError, TypeError, ValueError):  # stand-in managers
            return 60.0

    # -- the round ---------------------------------------------------------------

    def begin_round(self) -> None:
        with self._lock:
            self._futures = []
            self._results = {}
            self._round_wire_bytes = 0
            self._round_d2h_bytes = 0
            self._round_fragments = 0
            self._round_overlap_ms = 0.0

    def submit(self, fragment: Fragment, leaves: Sequence[Any]) -> None:
        """Issues one fragment's round; ``leaves`` is the whole live list.
        The fragment is snapshotted here, on the caller's thread; the rest
        runs on the worker (stream mode) or inline."""
        prep: Optional[Prepared] = None
        if bool(self._manager.is_participating()):
            try:
                prep = self._codecs[fragment.index].prepare(leaves)
            except Exception as e:  # noqa: BLE001 - latched; zeros keep the ring aligned
                _report(self._manager, e)
        if self._worker is None:
            self._sync_fragment(fragment, prep)
            return
        fut = self._worker.submit(self._sync_fragment, fragment, prep)
        with self._lock:
            self._futures.append(fut)

    def _sync_fragment(self, fragment: Fragment, prep: Optional[Prepared]) -> None:
        manager = self._manager
        codec = self._codecs[fragment.index]
        # Charged by the thread it blocks: overlapped on the worker, the
        # train thread's own FT time inline.
        phase = "outer_sync" if self._worker is not None else "allreduce_merge"
        with manager.spans.span(phase, step=manager.current_step(), fragment=fragment.index,
                                codec=codec.name) as sp:
            payload, d2h = None, 0
            if prep is not None:
                try:
                    payload, d2h = codec.finish(prep, self._timeout())
                except Exception as e:  # noqa: BLE001 - latched, zeros sent
                    _report(manager, e)
            if payload is None:
                # A group that is healing, or whose encode failed, still
                # rides the ring (the op count and its payload dtype are
                # part of every rank's frames) with zeros, its codec state
                # untouched.
                payload = codec.zero_payload()
            wire_codec = codec.wire_codec
            if wire_codec is not None and not self._collective_supports(wire_codec):
                wire_codec = None  # quantized at the source; the ring sends it as it is
            codec_arg = {} if wire_codec is None else {"wire_codec": wire_codec}
            # The payload is this round's own buffer: donated, reduced in place.
            fut = manager.allreduce(payload, allow_wire_compression=codec.allow_wire_compression,
                                    donate=True, **codec_arg)
            # The worker (not the train thread) waits; a failure resolves to
            # the input with the error latched, and the vote discards it.
            res = fut.result()
            wire = self._wire_nbytes(payload, codec, wire_codec)
            sp.fields["bytes"] = wire
            with self._lock:
                self._results[fragment.index] = res
                self._round_wire_bytes += wire
                self._round_d2h_bytes += int(d2h)
                self._round_fragments += 1
            if d2h:
                note = getattr(manager, "note_d2h", None)
                if callable(note):
                    try:
                        note(int(d2h))
                    except Exception:  # noqa: BLE001 - telemetry only
                        pass
            self.metrics.observe_fragment(wire_bytes=wire, d2h_bytes=int(d2h))
        if self._worker is not None:
            try:
                with self._lock:
                    self._round_overlap_ms += float(sp.duration_ms)
            except (TypeError, ValueError):  # stand-in span trackers
                pass

    def _collective_supports(self, wire_codec: str) -> bool:
        try:
            return wire_codec in getattr(self._manager.collective(), "wire_codecs", ())
        except Exception:  # noqa: BLE001 - stand-in managers
            return False

    def _wire_nbytes(self, payload: Any, codec: FragmentCodec, wire_codec: Optional[str]) -> int:
        """Per-hop wire bytes of one payload, from the collective's own probe
        where it has one."""
        try:
            probe = getattr(self._manager.collective(), "wire_nbytes", None)
            if callable(probe):
                if wire_codec is not None:
                    return int(probe(payload, codec.allow_wire_compression, wire_codec))
                return int(probe(payload, codec.allow_wire_compression))
        except Exception:  # noqa: BLE001 - stand-in managers
            pass
        return int(payload.nbytes)

    def drain(self) -> Dict[int, Any]:
        """Blocks the train thread until every issued fragment round has
        landed, spanned ``allreduce_merge`` (the streaming plane's one
        train-thread cost); returns {fragment index: averaged payload}."""
        with self._lock:
            futures = list(self._futures)
        with self._manager.spans.span("allreduce_merge", step=self._manager.current_step()):
            for fut in futures:
                try:
                    fut.result()
                except Exception as e:  # noqa: BLE001 - latched, never raised
                    _report(self._manager, e)
        with self._lock:
            return dict(self._results)

    def round_stats(self) -> Dict[str, int]:
        """The round's accounting so far (read after ``drain``, before the
        vote flushes the step's summary)."""
        with self._lock:
            return {"fragments": self._round_fragments, "wire_bytes": self._round_wire_bytes,
                    "d2h_bytes": self._round_d2h_bytes}

    def promote_fragment(self, fragment: Fragment, committed: bool) -> None:
        """Settles one fragment's codec state at its own vote (fragment-
        commit mode)."""
        codec = self._codecs[fragment.index]
        if committed:
            codec.on_commit()
        else:
            codec.on_abort()

    def end_round(self, committed: bool, promote: bool = True) -> Dict[str, int]:
        """Promotes or discards every codec's pending state (unless
        ``promote=False``: fragment-commit mode settled each already) and
        returns the round's accounting."""
        if promote:
            for codec in self._codecs:
                if committed:
                    codec.on_commit()
                else:
                    codec.on_abort()
        self.metrics.observe_round(committed=committed)
        with self._lock:
            self.metrics.observe_overlap_ms(self._round_overlap_ms)
        return self.round_stats()

    def shutdown(self) -> None:
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None
