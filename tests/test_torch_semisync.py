"""The port's semi-sync plane against the JAX package's, bitwise.

- Fragment plans: bucket boundaries and issue schedules equal the JAX
  planner's for the flagship's leaf shapes (metadata only) and for ragged
  leaf lists (mixed dtypes, 0-d and empty leaves, oversized leaves).
- Codecs (f32, auto, bf16, int8 and int4 with error feedback): four rounds
  of host encodes, pending residuals, commits and aborts bitwise equal to
  the JAX codecs', NaN and infinities included; the device-path code run
  on CPU tensors gives the host path's bits.
- ``outer.sgd``: bitwise optax's ``sgd`` over five rounds, with and
  without (Nesterov) momentum.
- ``StreamingDiLoCo`` with a seeded synthetic inner update and stand-in
  managers: backups and live parameters bitwise the JAX instance's after
  each of three rounds, in both scopes, with per-fragment write-back and
  fragment commit on and off, for every codec.
- A mixed quorum, one JAX group and one port group on one lighthouse and
  ring, int8 codec: every round commits and both end with one backup.
- Two port groups training a small transformer (2 layers, d_model 64):
  a late group heals the weights, the AdamW state and the outer state
  mid-run, and both end with one params_sha256, backup and outer state.
- The HTTP transport's background snapshot: the served bytes are the state
  at ``send_checkpoint`` though a training step mutates it right after,
  and the ``snapshot`` span runs on the background thread.
- ``SemiSyncMetrics``' exposition and the port's ``serve_text_exposition``.

Every comparison is bit for bit (tolerance 0) unless it says otherwise.
"""

from __future__ import annotations

import hashlib
import threading
import time
import urllib.request
from contextlib import contextmanager
from datetime import timedelta
from typing import Any, Dict, List, Optional

import numpy as np
import pytest
import torch

from torch_port_ref import cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.futures import completed_future
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.metrics import MetricsLogger
from torchft_tpu_torch.obs.spans import SpanTracker
from torchft_tpu_torch.semisync import (
    CODECS,
    FragmentPlan,
    SemiSyncMetrics,
    StreamingDiLoCo,
    make_codec,
    outer,
)
from torchft_tpu_torch.semisync.codec import ef_quantize

HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def ref():
    return {name: import_reference(f"torchft_tpu.{name}")
            for name in ("semisync", "semisync.fragments", "semisync.codec", "manager",
                         "collectives", "obs.spans", "metrics")}


def _np_dtype(dtype: torch.dtype):
    import ml_dtypes  # the reference side only

    return np.dtype(ml_dtypes.bfloat16) if dtype == torch.bfloat16 else np.dtype(
        str(dtype).rsplit(".", 1)[-1])


# -- fragment plans --------------------------------------------------------------


def _flagship_metas() -> List[tuple]:
    from torchft_tpu_torch.models import flagship_config

    cfg, _, _ = flagship_config()
    E, V, F, H, Dh = cfg.d_model, cfg.vocab_size, cfg.d_ff, cfg.n_heads, cfg.d_head
    layer = [(E,), (E, H * Dh), (E, cfg.n_kv_heads * Dh), (E, cfg.n_kv_heads * Dh),
             (H * Dh, E), (E,), (E, F), (E, F), (F, E)]
    shapes = [(V, E)] + layer * cfg.n_layers + [(E,), (E, V)]
    return [(s, torch.float32) for s in shapes]


_RAGGED = [
    [((3, 5), torch.float32), ((), torch.float32), ((7,), torch.int32), ((0,), torch.float32),
     ((11, 13), torch.bfloat16), ((2,), torch.float64), ((300,), torch.float32),
     ((), torch.int64), ((5, 5, 5), torch.bfloat16)],
    [((1000,), torch.float32)] * 3 + [((10,), torch.float32)],
    [((4097,), torch.float32), ((1,), torch.float32), ((255, 3), torch.float32)],
]


@pytest.mark.parametrize("case", ["flagship", "ragged0", "ragged1", "ragged2"])
@pytest.mark.parametrize("fragment_bytes", [None, 256, 4096, 1 << 30])
def test_fragment_plan_and_schedule_equal_the_jax_planner(ref, case, fragment_bytes) -> None:
    metas = _flagship_metas() if case == "flagship" else _RAGGED[int(case[-1])]
    if case == "flagship" and fragment_bytes == 256:
        fragment_bytes = 1 << 20
    port = FragmentPlan(metas, fragment_bytes)
    jax_plan = ref["semisync.fragments"].FragmentPlan(
        [(s, _np_dtype(d)) for s, d in metas], fragment_bytes)
    assert len(port) == len(jax_plan) and port.total_bytes == jax_plan.total_bytes
    for a, b in zip(port.fragments, jax_plan.fragments):
        assert list(a.bucket.indices) == list(b.bucket.indices)
        assert (a.numel, a.nbytes, a.lossy_ok) == (b.numel, b.nbytes, b.lossy_ok)
        assert list(a.bucket.offsets) == list(b.bucket.offsets)
    for sync_every in (1, 3, 8, 100):
        assert {k: [f.index for f in v] for k, v in port.schedule(sync_every).items()} == \
            {k: [f.index for f in v] for k, v in jax_plan.schedule(sync_every).items()}
    if case == "flagship" and fragment_bytes is None:
        # The default 4 MB fragments, every one lossy-eligible f32.
        assert len(port) > 16 and all(f.lossy_ok for f in port.fragments)


# -- codecs ------------------------------------------------------------------------


_CODEC_METAS = [((33, 5), torch.float32), ((7,), torch.float32), ((), torch.float32),
                ((120,), torch.float32)]


def _round_leaves(rnd: int, special: bool) -> List[np.ndarray]:
    rng = np.random.default_rng(900 + rnd)
    out = [np.array(rng.standard_normal(s) * (1 + rnd), dtype=np.float32)
           for s, _ in _CODEC_METAS]
    if special:
        out[0][0, 1], out[0][3, 2], out[3][5] = np.nan, np.inf, -np.inf
    return out


def _payload_bits(p: Any) -> bytes:
    if isinstance(p, torch.Tensor):
        return p.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(p).tobytes()


@pytest.mark.parametrize("name", CODECS)
def test_codec_rounds_bitwise_equal_the_jax_codec(ref, name) -> None:
    """Four rounds (commit, commit, abort, commit) through one fragment;
    the backup moves after each commit.  Payloads, pending and carried
    residuals bitwise equal the JAX codec's; the device-path code on CPU
    tensors gives the host path's payload and residual."""
    plan = FragmentPlan(_CODEC_METAS, None)
    jplan = ref["semisync.fragments"].FragmentPlan(
        [(s, _np_dtype(d)) for s, d in _CODEC_METAS], None)
    assert len(plan) == len(jplan) == 1
    port, dev, jax_codec = (make_codec(name, plan.fragments[0]),
                            make_codec(name, plan.fragments[0]),
                            ref["semisync.codec"].make_codec(name, jplan.fragments[0]))
    assert port.name == jax_codec.name == name
    assert port.wire_codec == jax_codec.wire_codec
    assert port.allow_wire_compression == jax_codec.allow_wire_compression
    backup = _round_leaves(-1, False)
    quantizing = name in ("int8", "int4")
    for rnd, outcome in enumerate(("commit", "commit", "abort", "commit")):
        for c in (port, dev):
            c.set_backup(plan.fragments[0].pack([torch.from_numpy(b) for b in backup]))
        jax_codec.set_backup(jplan.fragments[0].pack(backup))
        leaves = _round_leaves(rnd, special=quantizing and rnd == 1)
        want, d2h_want = jax_codec.encode(leaves)
        got, d2h = port.encode([torch.from_numpy(a.copy()) for a in leaves])
        assert d2h == d2h_want == 0
        assert _payload_bits(got) == np.ascontiguousarray(want).tobytes(), f"round {rnd}"
        assert str(np.asarray(want).dtype) == str(got.dtype).rsplit(".", 1)[-1] or quantizing
        # The device path's code, on CPU tensors.
        outs = dev._prepare_device([torch.from_numpy(a.copy()) for a in leaves])
        if quantizing:
            q, scale = outs
            deq = q.numpy().astype(np.float32) * np.float32(float(scale[0]))
            assert deq.tobytes() == np.asarray(want).tobytes(), f"device path, round {rnd}"
            np.testing.assert_array_equal(dev._pending_residual.numpy().view(np.uint32),
                                          port._pending_residual.view(np.uint32))
            np.testing.assert_array_equal(port._pending_residual.view(np.uint32),
                                          np.asarray(jax_codec._pending_residual).view(np.uint32))
        elif name != "bf16" or not np.isnan(leaves[0]).any():
            assert _payload_bits(outs[0]) == _payload_bits(got), f"device path, round {rnd}"
        for c in (port, dev, jax_codec):
            c.on_commit() if outcome == "commit" else c.on_abort()
        if quantizing:
            want_res = jax_codec._residual_host
            if want_res is None:
                assert port._residual_host is None and dev._residual_dev is None
            else:
                np.testing.assert_array_equal(port._residual_host.view(np.uint32),
                                              np.asarray(want_res).view(np.uint32))
                np.testing.assert_array_equal(dev._residual_dev.numpy().view(np.uint32),
                                              np.asarray(want_res).view(np.uint32))
                assert port.residual_l2() == pytest.approx(jax_codec.residual_l2(), rel=1e-6)
        if outcome == "commit":
            backup = [np.array(b - np.float32(0.25) * (b - lf), dtype=np.float32)
                      for b, lf in zip(backup, leaves)]
    zero = port.zero_payload()
    assert zero.numel() == plan.fragments[0].numel
    assert str(zero.dtype).rsplit(".", 1)[-1] == np.asarray(jax_codec.zero_payload()).dtype.name


def test_ef_quantize_rules_on_cpu_tensors() -> None:
    """The device encoder's guard rules: NaN encodes as 0 with a zero
    residual, infinities saturate, an all-zero or non-finite amax falls
    back to scale 1, and an empty fragment encodes."""
    from torchft_tpu_torch.collectives import quantize_int8

    x = torch.tensor([np.nan, 1.0, -2.0, 0.5], dtype=torch.float32)
    zero = torch.zeros(4)
    q, scale, res = ef_quantize(zero, x, zero, 127)
    s_host, q_host = quantize_int8(x.numpy())
    assert float(scale) == s_host == 1.0 and torch.equal(q, torch.from_numpy(q_host))
    assert res[0] == 0 and torch.isfinite(res).all()
    q, scale, _ = ef_quantize(zero, torch.tensor([np.inf, 1.0, -np.inf, 0.0]), zero, 7)
    assert q.tolist() == [7, 1, -7, 0] and float(scale) == 1.0
    q, scale, res = ef_quantize(zero, zero, zero, 127)
    assert float(scale) == 1.0 and not q.any() and not res.any()
    q, scale, res = ef_quantize(torch.zeros(0), torch.zeros(0), torch.zeros(0), 127)
    assert q.numel() == 0 and float(scale) == 1.0


# -- outer.sgd -----------------------------------------------------------------------


@pytest.mark.parametrize("momentum, nesterov", [(None, False), (0.0, False), (0.9, False),
                                                (0.9, True)])
def test_outer_sgd_bitwise_equals_optax(momentum, nesterov) -> None:
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(5)
    shapes = [(100_000,), (33, 7), ()]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = optax.sgd(0.7, momentum=momentum, nesterov=nesterov)
    ptx = outer.sgd(0.7, momentum=momentum, nesterov=nesterov)
    jstate = tx.init([jnp.asarray(p) for p in params])
    pstate = ptx.init([torch.from_numpy(p.copy()) for p in params])
    jp = [jnp.asarray(p) for p in params]
    pp = [torch.from_numpy(p.copy()) for p in params]
    for _ in range(5):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ju, jstate = tx.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, ju)
        pu, pstate = ptx.update([torch.from_numpy(a) for a in g], pstate, pp)
        pp = outer.apply_updates(pp, pu)
        for a, b in zip(jp, pp):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()


# -- StreamingDiLoCo against the JAX package's, stand-in managers -------------------------


class _StandIn:
    """A one-group manager: the quorum and vote always pass, and allreduce
    returns its input (every participant sent the same values).  ``spans``
    and ``metrics`` are the package's own."""

    _use_async_quorum = False
    timeout = timedelta(seconds=30)

    def __init__(self, spans: Any, metrics: Any, wire_codecs: tuple = ("int8", "int4")) -> None:
        self.spans, self.metrics = spans, metrics
        self._step = 0
        self.errors: List[Exception] = []
        self.state_fns: Dict[str, tuple] = {}
        self.calls: List[dict] = []
        coll = type("Coll", (), {"wire_codecs": wire_codecs})()
        self.collective = lambda: coll

    def start_quorum(self) -> None:
        pass

    def should_commit(self) -> bool:
        self._step += 1
        return True

    def current_step(self) -> int:
        return self._step

    def is_participating(self) -> bool:
        return True

    def replica_id(self) -> str:
        return "standin"

    def report_error(self, e: Exception) -> None:
        self.errors.append(e)

    def register_state_dict_fn(self, key: str, load, save) -> None:
        self.state_fns[key] = (load, save)

    def allreduce(self, payload: Any, **kwargs: Any):
        self.calls.append(kwargs)
        if isinstance(payload, torch.Tensor):
            return completed_future(payload.clone())
        return completed_future(np.array(payload, copy=True))


_DILOCO_METAS = [((16, 8), torch.float32), ((8,), torch.float32), ((8, 4), torch.float32),
                 ((), torch.float32), ((5,), torch.float32)]


def _inner(params: List[np.ndarray], rnd: int, inner: int, gid: int) -> List[np.ndarray]:
    rng = np.random.default_rng(10000 * rnd + 100 * inner + gid)
    return [np.array(p - np.float32(0.05) * rng.standard_normal(p.shape).astype(np.float32),
                     dtype=np.float32) for p in params]


def _init_leaves() -> List[np.ndarray]:
    rng = np.random.default_rng(77)
    return [np.array(rng.standard_normal(s) * 0.1, dtype=np.float32) for s, _ in _DILOCO_METAS]


@pytest.mark.parametrize("codec, scope, writeback, fragment_commit", [
    ("int8", "fragment", False, False),
    ("int8", "fragment", True, False),
    ("int8", "fragment", True, True),
    ("int8", "tree", False, False),
    ("int4", "fragment", True, False),
    ("bf16", "fragment", False, False),
    ("f32", "tree", False, False),
    ("auto", "fragment", False, False),
])
def test_streaming_diloco_rounds_bitwise_equal_the_jax_instance(ref, codec, scope, writeback,
                                                                fragment_commit) -> None:
    import optax

    jax_mgr = _StandIn(ref["obs.spans"].SpanTracker(ref["metrics"].MetricsLogger(None)),
                       ref["metrics"].MetricsLogger(None))
    port_mgr = _StandIn(SpanTracker(MetricsLogger(None)), MetricsLogger(None))
    jstate = {"p": _init_leaves()}
    pparams = [torch.from_numpy(a.copy()) for a in _init_leaves()]

    def jset(p):
        jstate["p"] = [np.asarray(x) for x in p]

    def jset_frag(idx, leaves):
        for i, x in zip(idx, leaves):
            jstate["p"][i] = np.asarray(x)

    def pset(p):
        for dst, src in zip(pparams, p):
            dst.copy_(src)

    def pset_frag(idx, leaves):
        for i, src in zip(idx, leaves):
            pparams[i].copy_(src)

    kw = dict(sync_every=3, fragment_bytes=256, codec=codec, stream=True, outer_scope=scope,
              fragment_commit=fragment_commit)
    jalgo = ref["semisync"].StreamingDiLoCo(
        jax_mgr, lambda: list(jstate["p"]), jset, optax.sgd(0.7, momentum=0.9, nesterov=True),
        set_fragment_params=jset_frag if writeback else None, **kw)
    palgo = StreamingDiLoCo(
        port_mgr, lambda: pparams, pset, outer.sgd(0.7, momentum=0.9, nesterov=True),
        set_fragment_params=pset_frag if writeback else None, **kw)
    assert jalgo.num_fragments == palgo.num_fragments >= 2
    with jalgo, palgo:
        for rnd in range(3):
            for inner in range(3):
                new = _inner(jstate["p"], rnd, inner, 0)
                jstate["p"] = new
                for dst, src in zip(pparams, new):
                    # The JAX instance hands a 0-d leaf back 1-d; same bytes.
                    dst.copy_(torch.from_numpy(src).reshape(dst.shape))
                jalgo.step()
                palgo.step()
            for a, b in zip(jalgo.backup_params, palgo.backup_params):
                assert np.asarray(a).tobytes() == b.numpy().tobytes(), f"backup, round {rnd}"
            for a, b in zip(jstate["p"], pparams):
                assert np.asarray(a).tobytes() == b.numpy().tobytes(), f"params, round {rnd}"
    assert not jax_mgr.errors and not port_mgr.errors
    assert palgo.metrics.commits_total == jalgo.metrics.commits_total
    # No wire_nbytes probe on the stand-in: both count the payloads' bytes.
    assert palgo.metrics.wire_bytes_total == jalgo.metrics.wire_bytes_total > 0
    assert [c.get("wire_codec") for c in port_mgr.calls] == \
        [c.get("wire_codec") for c in jax_mgr.calls]


def test_streaming_diloco_state_dict_carries_backup_and_outer_state() -> None:
    mgr = _StandIn(SpanTracker(MetricsLogger(None)), MetricsLogger(None))
    params = [torch.ones(64), torch.zeros(3)]
    algo = StreamingDiLoCo(mgr, lambda: params, lambda p: None, outer.sgd(0.5, momentum=0.9),
                           sync_every=1, stream=False)
    load, save = mgr.state_fns["diloco"]
    saved = save()
    assert saved["outer_scope"] == "fragment" and len(saved["outer_state"]) == algo.num_fragments
    with pytest.raises(ValueError, match="outer_scope"):
        load({"backup": params, "outer_state": {}, "outer_scope": "tree"})
    load({"backup": [torch.full((64,), 2.0), torch.ones(3)], "outer_state": saved["outer_state"],
          "outer_scope": "fragment"})
    assert torch.equal(algo.backup_params[0], torch.full((64,), 2.0))
    with pytest.raises(ValueError, match="use_async_quorum"):
        mgr._use_async_quorum = True
        StreamingDiLoCo(mgr, lambda: params, lambda p: None, outer.sgd(0.5), sync_every=1)


# -- a mixed quorum: one JAX group, one port group -----------------------------------


def test_mixed_jax_and_port_streaming_diloco_int8_ends_with_one_backup(ref) -> None:
    import optax

    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=2, join_timeout_ms=100)
    timeout = timedelta(seconds=30)
    out: Dict[int, dict] = {}
    errors: List[BaseException] = []

    def group(g: int) -> None:
        try:
            if g == 0:
                m = ref["manager"].Manager(
                    collective=ref["collectives"].TCPCollective(timeout=30.0), load_state_dict=None,
                    state_dict=None, min_replica_size=2, use_async_quorum=False, timeout=timeout,
                    quorum_timeout=timeout, rank=0, world_size=1, replica_id="jax0",
                    lighthouse_addr=lh.address(), init_sync=False)
                state = {"p": _init_leaves()}
                algo = ref["semisync"].StreamingDiLoCo(
                    m, lambda: list(state["p"]),
                    lambda p: state.update(p=[np.asarray(x) for x in p]),
                    optax.sgd(0.7, momentum=0.9, nesterov=True), sync_every=3,
                    fragment_bytes=256, codec="int8", stream=True)
            else:
                m = Manager(collective=TCPCollective(timeout=30.0, host=HOST), load_state_dict=None,
                            state_dict=None, min_replica_size=2, use_async_quorum=False,
                            timeout=timeout, quorum_timeout=timeout, rank=0, world_size=1,
                            replica_id="port1", lighthouse_addr=lh.address(), store_addr=HOST,
                            manager_bind=f"{HOST}:0", init_sync=False)
                tensors = [torch.from_numpy(a) for a in _init_leaves()]

                def pset(p):
                    for dst, src in zip(tensors, p):
                        dst.copy_(src)

                algo = StreamingDiLoCo(m, lambda: tensors, pset,
                                       outer.sgd(0.7, momentum=0.9, nesterov=True), sync_every=3,
                                       fragment_bytes=256, codec="int8", stream=True)
            try:
                with algo:
                    for rnd in range(3):
                        for inner in range(3):
                            if g == 0:
                                state["p"] = _inner(state["p"], rnd, inner, g)
                            else:
                                cur = [t.numpy() for t in tensors]
                                for dst, src in zip(tensors, _inner(cur, rnd, inner, g)):
                                    dst.copy_(torch.from_numpy(src).reshape(dst.shape))
                            algo.step()
                    out[g] = {"step": m.current_step(),
                              "backup": [np.asarray(b).copy() if g == 0 else b.numpy().copy()
                                         for b in algo.backup_params],
                              "commits": algo.metrics.commits_total,
                              "wire": algo.metrics.wire_bytes_total}
            finally:
                m.shutdown()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=group, args=(g,)) for g in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        lh.shutdown()
    if errors:
        raise errors[0]
    assert out[0]["step"] == out[1]["step"] == 3
    assert out[0]["commits"] == out[1]["commits"] == 3
    for a, b in zip(out[0]["backup"], out[1]["backup"]):
        assert a.tobytes() == b.tobytes()
    f32 = sum(int(np.prod(s)) * 4 for s, _ in _DILOCO_METAS) * 3
    assert out[1]["wire"] == out[0]["wire"] and out[1]["wire"] <= 0.3 * f32


# -- two port groups on a small transformer, a late group heals -----------------------


def _sha(tensors: List[torch.Tensor]) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def test_late_port_group_heals_outer_state_and_converges(monkeypatch) -> None:
    """The twin of tests/test_semisync.py's mid-round-kill heal: group 1
    joins after group 0's first round, heals weights, AdamW state, backup
    and per-fragment outer state live from group 0 at its round boundary,
    and both end with one params_sha256, backup and outer state."""
    from torchft_tpu_torch.models import Transformer, TransformerConfig, loss_fn
    from torchft_tpu_torch.parallel import TrainStep

    cfg = TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=2,
                            d_ff=128, max_seq=32, dtype=torch.float32)
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=100)
    timeout = timedelta(seconds=30)
    g0_ready, g1_up = threading.Event(), threading.Event()
    out: Dict[int, dict] = {}
    errors: List[BaseException] = []
    rounds = 3

    def group(g: int) -> None:
        try:
            model = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(10 + g))
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            params = list(model.parameters())
            m = Manager(
                collective=TCPCollective(timeout=30.0, host=HOST),
                load_state_dict=lambda sd: (model.load_state_dict(sd["model"]),
                                            opt.load_state_dict(sd["optim"])),
                state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
                min_replica_size=1, use_async_quorum=False, timeout=timeout,
                quorum_timeout=timeout, rank=0, world_size=1, replica_id=f"late{g}",
                lighthouse_addr=lh.address(), store_addr=HOST, manager_bind=f"{HOST}:0",
                checkpoint_transport=HTTPTransport(timeout=30.0, host=HOST))

            def set_params(src):
                with torch.no_grad():
                    for p, s in zip(params, src):
                        p.copy_(s)

            algo = StreamingDiLoCo(m, lambda: params, set_params,
                                   outer.sgd(0.7, momentum=0.9, nesterov=True), sync_every=3,
                                   fragment_bytes=16 << 10, codec="int8", stream=True)
            trainer = TrainStep(model, opt, loss_fn)
            data = torch.Generator().manual_seed(50 + g)
            healed = asked = False
            try:
                with algo:
                    while m.current_step() < rounds:
                        before = m.current_step()
                        for _ in range(3):
                            tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=data)
                            trainer.full_step({"tokens": tokens,
                                               "targets": torch.roll(tokens, -1, dims=1)})
                            if g == 1 and not asked:
                                # This step requests the quorum first; group
                                # 0's next request then waits for it (the
                                # lighthouse's fast quorum forms without a
                                # member that has not asked yet).
                                asked = True
                                threading.Timer(1.0, g1_up.set).start()
                            algo.step()
                        healed |= m.current_step() - before > 1
                        if g == 0 and m.current_step() == 1:
                            g0_ready.set()
                            assert g1_up.wait(timeout=30)
                    out[g] = {"step": m.current_step(), "sha": _sha(params),
                              "backup": _sha(algo.backup_params),
                              "outer": _sha([t for s in algo._outer_states
                                             for t in s["trace"]]),
                              "healed": healed, "commits": algo.metrics.commits_total}
            finally:
                m.shutdown()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=group, args=(g,)) for g in range(2)]
    try:
        threads[0].start()
        # Group 1 starts once group 0 has committed its first round alone.
        assert g0_ready.wait(timeout=60) or errors
        threads[1].start()
        for t in threads:
            t.join(timeout=150)
    finally:
        lh.shutdown()
    if errors:
        raise errors[0]
    assert out[1]["healed"] and not out[0]["healed"]
    assert out[0]["commits"] == rounds and out[1]["commits"] == rounds - 1
    assert out[0]["step"] == out[1]["step"] == rounds
    assert out[0]["sha"] == out[1]["sha"]
    assert out[0]["backup"] == out[1]["backup"]
    assert out[0]["outer"] == out[1]["outer"]


# -- the HTTP transport's background snapshot --------------------------------------------


class _ThreadSpans:
    """A span tracker that records each span's phase and thread."""

    def __init__(self) -> None:
        self.seen: List[tuple] = []

    @contextmanager
    def span(self, phase: str, step: int, **fields: Any):
        sp = type("Sp", (), {"fields": {}, "duration_ms": 0.0})()
        yield sp
        self.seen.append((phase, step, threading.current_thread().name, dict(sp.fields)))


@pytest.mark.parametrize("background", [True, None])
def test_background_snapshot_serves_the_state_at_send_time(background) -> None:
    w = torch.arange(10_000, dtype=torch.float32)
    m = torch.full((3,), 2.0)
    state = {"model": {"w": w}, "optim": {"m": m, "step": 7}}
    want = {"w": w.clone(), "m": m.clone()}
    donor = HTTPTransport(timeout=10.0, host=HOST, background=background)
    healer = HTTPTransport(timeout=10.0, host=HOST)
    spans = _ThreadSpans()
    donor.set_span_tracker(spans)
    try:
        donor.send_checkpoint([1], step=3, state_dict=state, timeout=10.0)
        # A training step mutates the state right after.
        w.mul_(-1.0)
        m.add_(1.0)
        assert donor.wait_snapshot(timeout=10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), step=3, timeout=10.0)
        assert torch.equal(got["model"]["w"], want["w"])
        assert torch.equal(got["optim"]["m"], want["m"]) and got["optim"]["step"] == 7
        (phase, step, thread, fields), = spans.seen
        assert phase == "snapshot" and step == 3 and fields["bytes"] == 40_012
        on_bg = thread == "tpuft_torch_http_snapshot"
        assert on_bg == bool(background)
        donor.disallow_checkpoint()
        with pytest.raises(Exception):
            HTTPTransport.recv_checkpoint(healer, 0, donor.metadata(), step=3, timeout=0.5)
    finally:
        donor.shutdown()
        healer.shutdown()


@pytest.mark.gpu
def test_background_snapshot_of_cuda_state_on_card(cuda_device) -> None:
    """On the card the clone is taken on the caller's stream and the host
    copy on the snapshotter's: the served bytes are the state at send time
    though an in-place update is queued right after."""
    w = torch.randn(1 << 20, device=cuda_device)
    want = w.cpu()
    donor = HTTPTransport(timeout=30.0, host=HOST)
    healer = HTTPTransport(timeout=30.0, host=HOST)
    try:
        donor.send_checkpoint([1], step=1, state_dict={"w": w}, timeout=30.0)
        w.mul_(3.0)
        assert donor.wait_snapshot(timeout=30.0)
        got = healer.recv_checkpoint(0, donor.metadata(), step=1, timeout=30.0)
        assert torch.equal(got["w"], want)
    finally:
        donor.shutdown()
        healer.shutdown()


# -- metrics ---------------------------------------------------------------------------------


def test_semisync_metrics_render_and_serve_like_the_jax_exposition(ref) -> None:
    port = SemiSyncMetrics(codec="int8", replica_id="r0")
    jax_m = ref["semisync"].SemiSyncMetrics(codec="int8", replica_id="r0")
    for mm in (port, jax_m):
        mm.observe_fragment(wire_bytes=100, d2h_bytes=26)
        mm.observe_fragment(wire_bytes=50, d2h_bytes=13)
        mm.observe_round(committed=True)
        mm.observe_round(committed=False)
        mm.observe_residual(1.5)
        mm.observe_overlap_ms(12.25)
    assert port.render_prometheus() == jax_m.render_prometheus()
    assert port.serve(port=None) is None  # TPUFT_SEMISYNC_METRICS_PORT unset: off
    bound = port.serve(port=0, bind="127.0.0.1")
    try:
        assert bound and port.serving
        body = urllib.request.urlopen(f"http://127.0.0.1:{bound}/metrics", timeout=5).read()
        assert body.decode() == jax_m.render_prometheus()
    finally:
        port.close()
    assert not port.serving


def test_background_snapshot_stress_serves_each_step_its_own_state() -> None:
    """Thirty back-to-back snapshots, each followed at once by an in-place
    update of the state, with the interpreter switching threads every
    microsecond: every fetched step holds exactly the values it was sent
    with."""
    import sys

    w = torch.zeros(50_000)
    donor = HTTPTransport(timeout=10.0, host=HOST, background=True)
    healer = HTTPTransport(timeout=10.0, host=HOST)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        deadline = time.monotonic() + 60
        for step in range(30):
            w.fill_(float(step))
            donor.send_checkpoint([1], step=step, state_dict={"w": w}, timeout=10.0)
            w.fill_(-1.0)  # the optimizer's in-place update, right after
            got = healer.recv_checkpoint(0, donor.metadata(), step=step, timeout=10.0)
            assert torch.equal(got["w"], torch.full((50_000,), float(step))), step
            assert time.monotonic() < deadline
        assert donor.wait_snapshot(timeout=10.0)
    finally:
        sys.setswitchinterval(old)
        donor.shutdown()
        healer.shutdown()
    assert donor._snap_thread is not None and not donor._snap_thread.is_alive()
