"""Flagship model: decoder-only transformer LM, the dense flash-attention
subset of ``torchft_tpu/models/transformer.py`` with its math exactly:
half-split rotary embedding, pre-norm blocks, a SwiGLU MLP, parameters in
float32 and compute in ``cfg.dtype`` (bf16 on the card).

Attention takes the flash kernels and the loss the fused lm-head
cross-entropy kernels where their shape gates hold (``flash_applicable``,
``fused_ce_applicable``: bf16 on CUDA at shapes the kernels are built
for), as the JAX model takes its Pallas kernels where ``_use_pallas`` and
``fused_ce_applicable`` hold; everywhere else (the CPU, head dims other
than 128, ragged widths) the same math runs as plain PyTorch.

Over an in-group mesh (:func:`parallelize`, ``parallel/mesh.py``) the
parameters are ``DTensor``s placed by :func:`param_axes` and the rules;
each rank computes on plain local tensors (``FTMesh.materialize``): batch
axes gather the weights, and under ``tensor`` > 1 each rank holds its
slice of the heads, the MLP and the vocabulary, Megatron-style.  The
kernel gate there: K1-K3 run on each rank's local heads wherever
``flash_applicable`` holds (the head dim stays 128); K4/K5 run where the
rank holds the whole lm head (``tensor`` 1: "fsdp" and "data" gather it
before the loss); under ``tensor`` > 1 the loss is a plain vocab-parallel
cross-entropy (:func:`vocab_parallel_cross_entropy`), as the JAX package
takes its plain loss under any mesh above one device.

Over a "sequence" axis above 1 each rank holds a slice of every
sequence and ``attention`` picks how attention crosses the slices: "ring"
(``ops/ring_attention.py``, K/V rotated around the ring, in the
``ring_layout`` "contiguous" or "zigzag") or "ulysses" (``ops/ulysses.py``,
two all-to-alls around the flash kernels); rope takes each slot's global
position, and the loss is each rank's mean over its own tokens, its value
averaged over the axis (K4/K5 on each rank's rows).  Without such an axis
"ring" and "ulysses" warn once and take flash, as in the JAX package.

``remat`` (on by default, as in the JAX package) recomputes each block in
the backward through ``torch.utils.checkpoint``.  ``moe_experts`` > 0
makes each block's MLP a mixture of experts (``models/moe.py``, the JAX
``moe_ffn``), its stacked experts placed over the "expert" axis and their
MLP dim over "tensor", and the loss adds ``moe_aux_coef`` times the
load-balance term summed over the layers.  The JAX config's
``scan_unroll`` has no eager counterpart: the blocks run as a Python loop.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch.ops import (
    flash_applicable,
    flash_attention,
    fused_ce_applicable,
    fused_linear_cross_entropy,
    plain_attention,
    rms_norm,
)
from torchft_tpu_torch.models.moe import moe_ffn
from torchft_tpu_torch.ops.ring_attention import ring_attention, zigzag_permutation
from torchft_tpu_torch.ops.ulysses import check_heads, ulysses_attention
from torchft_tpu_torch.parallel.functional import (
    copy_to,
    gather_from,
    mean_value,
    reduce_from,
)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises if CUDA is asked for and no card is present."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16  # activation / compute dtype
    param_dtype: torch.dtype = torch.float32
    # Recompute each block's activations in the backward instead of keeping
    # them (the JAX model's jax.checkpoint of its layer body).
    remat: bool = True
    # Mixture of experts: > 0 replaces each block's dense MLP with
    # moe_experts stacked experts, shardable over the "expert" mesh axis.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    # Attention over a "sequence" axis above 1: "ring" (K/V rotated around
    # the axis) or "ulysses" (all-to-all head<->sequence resharding);
    # "flash" runs on whole sequences.
    attention: str = "flash"
    # The ring's sequence layout: "contiguous" or "zigzag" (balanced causal
    # work).  With "zigzag" the caller feeds tokens and targets permuted by
    # ops.ring_attention.to_zigzag(..., n_shards=the "sequence" size); the
    # model ropes with the original positions, and the mean loss does not
    # change with the order.
    ring_layout: str = "contiguous"

    def __post_init__(self) -> None:
        # The JAX config's asserts, raised outright (an assert goes under -O).
        if self.attention not in ("flash", "ring", "ulysses"):
            raise AssertionError(f"unknown attention backend {self.attention!r}; "
                                 "expected 'flash', 'ring', or 'ulysses'")
        if self.ring_layout not in ("contiguous", "zigzag"):
            raise AssertionError(f"unknown ring_layout {self.ring_layout!r}")

    @property
    def d_head(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def flagship_config() -> "tuple[TransformerConfig, int, int]":
    """The flagship training shape: (config, batch size, sequence length) —
    the JAX package's bench.py flagship_config (12 layers, d_model 768,
    6 heads x 128, d_ff 2048, vocab 32000), about 134M parameters, without
    rematerialisation, as there."""
    cfg = TransformerConfig(
        vocab_size=32000, d_model=768, n_layers=12, n_heads=6, n_kv_heads=6,
        d_ff=2048, max_seq=1024, remat=False,
    )
    return cfg, 16, 1024


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, halves split; x: [B, S, H, Dh], positions: [S]."""
    d_half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, d_half, dtype=torch.float32, device=x.device) / d_half)
    angles = positions[:, None].float() * freqs  # [S, d/2]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _normal(shape, fan_in: int, gen: torch.Generator, device, dtype) -> nn.Parameter:
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype) * fan_in ** -0.5
    return nn.Parameter(t)


class Block(nn.Module):
    """One pre-norm decoder block: attention then a SwiGLU MLP, or the
    mixture of experts (``cfg.moe_experts`` > 0).  ``forward`` returns the
    block's output and its load-balance term (None for a dense block)."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator, device) -> None:
        super().__init__()
        self.cfg = cfg
        E, H, KV, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
        pd = cfg.param_dtype

        def linear(d_in: int, d_out: int) -> nn.Linear:
            lin = nn.Linear(d_in, d_out, bias=False, device=device, dtype=pd)
            lin.weight = _normal((d_out, d_in), d_in, gen, device, pd)
            return lin

        self.attn_norm = nn.Parameter(torch.ones(E, device=device, dtype=pd))
        self.wq = linear(E, H * Dh)
        self.wk = linear(E, KV * Dh)
        self.wv = linear(E, KV * Dh)
        self.wo = linear(H * Dh, E)
        self.mlp_norm = nn.Parameter(torch.ones(E, device=device, dtype=pd))
        if cfg.moe_experts > 0:
            # The JAX layout: router [E, X], stacked experts [X, E, F] / [X, F, E].
            X = cfg.moe_experts
            self.router = _normal((E, X), E, gen, device, pd)
            self.w_gate = _normal((X, E, Fd), E, gen, device, pd)
            self.w_up = _normal((X, E, Fd), E, gen, device, pd)
            self.w_down = _normal((X, Fd, E), Fd, gen, device, pd)
        else:
            self.w_gate = linear(E, Fd)
            self.w_up = linear(E, Fd)
            self.w_down = linear(Fd, E)
        # The in-group mesh (parallelize); None: the whole model on one device.
        self.ftmesh = None
        # A list to receive each MoE call's routing (moe_ffn's record), or None.
        self.moe_record = None
        # [T, k] expert choices the MoE takes instead of its router's
        # (moe_ffn's route: another run's recorded gate_idx), or None.
        self.moe_route = None

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        B, S, _ = x.shape
        Dh, dt = cfg.d_head, cfg.dtype
        w, into, out = _mesh_ops(self.ftmesh)

        def proj(lin: nn.Linear, h: torch.Tensor) -> torch.Tensor:
            return F.linear(h, w(lin.weight).to(dt))

        # Head counts from the projections: a rank's own under "tensor".
        h = into(rms_norm(x, w(self.attn_norm)))
        q = _rope(proj(self.wq, h).reshape(B, S, -1, Dh), positions, cfg.rope_theta)
        k = _rope(proj(self.wk, h).reshape(B, S, -1, Dh), positions, cfg.rope_theta)
        v = proj(self.wv, h).reshape(B, S, -1, Dh)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        attn = _attend(cfg, self.ftmesh, q, k, v)
        x = x + out(proj(self.wo, attn.transpose(1, 2).reshape(B, S, -1)))

        h = rms_norm(x, w(self.mlp_norm))
        if cfg.moe_experts > 0:
            # Routed before the tensor axis's copy_to: every "tensor" rank
            # routes alike, and moe_ffn places the F-slice's own pair.
            y, aux = moe_ffn(h, w(self.router), w(self.w_gate), w(self.w_up), w(self.w_down),
                             top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                             dtype=dt, ftmesh=self.ftmesh, record=self.moe_record,
                             route=self.moe_route)
            return x + y, aux
        h = into(h)
        return x + out(proj(self.w_down, F.silu(proj(self.w_gate, h)) * proj(self.w_up, h))), None


def _sequence_group(cfg: TransformerConfig, ftmesh: Any) -> Any:
    """The "sequence" axis's group where ring or Ulysses attention engages
    (the axis above 1); None otherwise."""
    if cfg.attention == "flash" or ftmesh is None or ftmesh.size("sequence") == 1:
        return None
    return ftmesh.group("sequence")


def _attend(cfg: TransformerConfig, ftmesh: Any, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """Causal attention of a rank's q/k/v [B, H|KV, S_local, Dh] (its heads
    under "tensor"): the JAX ``_attention``'s choice of backend."""
    group = _sequence_group(cfg, ftmesh)
    if cfg.attention != "flash" and group is None:
        warnings.warn(
            f"attention={cfg.attention!r} requested but the mesh has no >1-sized 'sequence' "
            "axis; falling back to single-shard flash attention", stacklevel=2)
    if group is None:
        attend = flash_attention if flash_applicable(q, k) else plain_attention
        return attend(q, k, v, causal=True)
    n, tp = ftmesh.size("sequence"), ftmesh.size("tensor")
    if cfg.attention == "ring":
        # The ring body needs equal q and kv head counts.
        broadcast_gqa = cfg.n_kv_heads != cfg.n_heads
    else:
        # Ulysses keeps GQA compressed through the exchange unless the kv
        # heads of a tensor shard do not tile the sequence axis.
        broadcast_gqa = cfg.n_kv_heads != cfg.n_heads and (cfg.n_kv_heads // tp) % n != 0
    kv_heads = cfg.n_kv_heads
    if broadcast_gqa:
        rep = cfg.n_heads // cfg.n_kv_heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        kv_heads = cfg.n_heads
    if cfg.attention == "ring":
        return ring_attention(q, k, v, group, causal=True, layout=cfg.ring_layout)
    check_heads(cfg.n_heads, kv_heads, tp, n)
    return ulysses_attention(q, k, v, group, causal=True)


def _positions(cfg: TransformerConfig, ftmesh: Any, s_local: int, device) -> torch.Tensor:
    """The global rope positions of a rank's [S_local] slots: its shard of
    0..S-1 over the "sequence" axis where ring or Ulysses engages, in the
    zigzag order under ring_layout "zigzag" (the tokens arrive permuted)."""
    if _sequence_group(cfg, ftmesh) is None:
        return torch.arange(s_local, device=device)
    n, idx = ftmesh.size("sequence"), ftmesh.coordinate("sequence")
    if cfg.attention == "ring" and cfg.ring_layout == "zigzag":
        pos = torch.from_numpy(zigzag_permutation(s_local * n, n)).to(device)
    else:
        pos = torch.arange(s_local * n, device=device)
    return pos[idx * s_local:(idx + 1) * s_local]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _mesh_ops(ftmesh: Any) -> tuple:
    """(weight, into, out): the parameter a rank computes with, and the
    tensor axis's f and g around a column- then row-parallel pair (identity
    without a mesh or at tensor 1)."""
    if ftmesh is None:
        return _identity, _identity, _identity
    tp = _tensor_group(ftmesh)
    if tp is None:
        return ftmesh.materialize, _identity, _identity
    return (ftmesh.materialize, lambda h: copy_to(h, tp), lambda y: reduce_from(y, tp))


def _tensor_group(ftmesh: Any) -> Any:
    if ftmesh is None or ftmesh.size("tensor") == 1:
        return None
    return ftmesh.group("tensor")


class Transformer(nn.Module):
    """Decoder-only LM.  ``lm_head`` keeps the ``[E, V]`` layout the fused
    cross-entropy kernels read."""

    def __init__(
        self,
        cfg: TransformerConfig,
        device: Union[str, torch.device, None] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        E, V, pd = cfg.d_model, cfg.vocab_size, cfg.param_dtype
        self.embed = nn.Embedding(V, E, device=device, dtype=pd)
        self.embed.weight = _normal((V, E), E, gen, device, pd)
        self.layers = nn.ModuleList(Block(cfg, gen, device) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(E, device=device, dtype=pd))
        self.lm_head = _normal((E, V), E, gen, device, pd)
        self.ftmesh = None

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> embeddings [B, S, E] in cfg.dtype."""
        w, _, out = _mesh_ops(self.ftmesh)
        table = w(self.embed.weight).to(self.cfg.dtype)
        if _tensor_group(self.ftmesh) is None:
            return table[tokens]
        # Vocab-parallel lookup: rows outside this rank's slice are zero.
        lo, n = self.ftmesh.coordinate("tensor") * table.shape[0], table.shape[0]
        local = tokens - lo
        mine = (local >= 0) & (local < n)
        return out(table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype))

    def decoder_with_aux(self, tokens: torch.Tensor
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """tokens [B, S] -> (hidden states [B, S, E] before the final norm,
        the load-balance terms summed over the layers; None if dense)."""
        x = self.embed_tokens(tokens)
        positions = _positions(self.cfg, self.ftmesh, tokens.shape[1], tokens.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux_total = None
        for layer in self.layers:
            if remat:
                # One checkpoint a block: its forward runs again in the
                # backward.  A block draws no random numbers, so the RNG
                # state is not saved and restored around it.
                x, aux = checkpoint(layer, x, positions, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = layer(x, positions)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, aux_total

    def decoder(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> hidden states [B, S, E] (before the final norm)."""
        return self.decoder_with_aux(tokens)[0]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> f32 logits [B, S, V]."""
        return self.head(self.decoder(tokens))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + lm head: [B, S, E] -> f32 logits [B, S, V] (operands
        rounded to cfg.dtype, product and sum in f32)."""
        w, into, _ = _mesh_ops(self.ftmesh)
        x = into(rms_norm(x, w(self.final_norm)))
        logits = torch.matmul(x.float(), w(self.lm_head).to(self.cfg.dtype).float())
        tp = _tensor_group(self.ftmesh)
        return logits if tp is None else gather_from(logits, tp)

    def lm_head_loss(self, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Mean next-token CE from decoder output x [B, S, E]: the fused
        kernels where ``fused_ce_applicable`` holds, else the materialized
        logits."""
        B, S, E = x.shape
        weight, into, _ = _mesh_ops(self.ftmesh)
        h = into(rms_norm(x, weight(self.final_norm))).reshape(B * S, E)
        w = weight(self.lm_head).to(self.cfg.dtype)
        tp = _tensor_group(self.ftmesh)
        if tp is not None:
            return vocab_parallel_cross_entropy(
                h, w, targets.reshape(B * S), tp, self.ftmesh.coordinate("tensor") * w.shape[1])
        if fused_ce_applicable(h, w):
            return fused_linear_cross_entropy(h, w, targets.reshape(B * S))
        logits = torch.matmul(h.float(), w.float()).reshape(B, S, -1)  # as head()
        return token_cross_entropy(logits, targets)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Next-token CE; batch: {"tokens": [B, S], "targets": [B, S]}.  A
        mixture-of-experts model adds moe_aux_coef x its load-balance term.
        Over a "sequence" axis the value is the mean over the ranks' tokens,
        the gradient this rank's own (``mean_value``)."""
        x, aux = self.decoder_with_aux(batch["tokens"])
        ce = self.lm_head_loss(x, batch["targets"])
        group = _sequence_group(self.cfg, self.ftmesh)
        if group is not None:
            ce = mean_value(ce, group)
        return ce if aux is None else ce + self.cfg.moe_aux_coef * aux


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE as logsumexp - target logit."""
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tgt).mean()


def vocab_parallel_cross_entropy(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                                 group: Any, vocab_start: int) -> torch.Tensor:
    """Mean CE of ``h`` [N, E] against the lm head when this rank holds
    only the columns ``w`` [E, V / tp] from ``vocab_start`` on: the global
    max, the sum of exponentials and the target logit are summed over the
    tensor group (gradients pass each sum unchanged); ``h`` has passed
    ``copy_to``.  Plain PyTorch: the fused kernels read the whole
    vocabulary."""
    logits = torch.matmul(h.float(), w.float())  # [N, V / tp], as head()
    m = logits.detach().amax(dim=-1)
    torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX, group=group)
    sum_exp = reduce_from(torch.exp(logits - m[:, None]).sum(dim=-1), group)
    local = targets.long() - vocab_start
    mine = (local >= 0) & (local < w.shape[1])
    tgt = torch.gather(logits, -1, local.clamp(0, w.shape[1] - 1)[:, None])[:, 0]
    tgt = reduce_from(tgt * mine.to(tgt.dtype), group)
    return (torch.log(sum_exp) + m - tgt).mean()


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return model.loss(batch)


def param_axes(cfg: TransformerConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axis names of every parameter, keyed by the port's parameter
    names (``named_parameters``): the JAX ``param_axes`` with each
    ``nn.Linear`` weight's tuple transposed to its ``[out, in]`` layout and
    no "layers" axis (one module a layer).  Feed to ``FTMesh.shard_params``."""
    layer = {
        "attn_norm": ("embed",),
        "wq.weight": ("heads", "embed"),
        "wk.weight": ("kv_heads", "embed"),
        "wv.weight": ("kv_heads", "embed"),
        "wo.weight": ("embed", "heads"),
        "mlp_norm": ("embed",),
        "w_gate.weight": ("mlp", "embed"),
        "w_up.weight": ("mlp", "embed"),
        "w_down.weight": ("embed", "mlp"),
    }
    axes: Dict[str, Tuple[Optional[str], ...]] = {
        "embed.weight": ("vocab", "embed"),
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }
    if cfg.moe_experts > 0:
        # The stacked experts keep the JAX layout (no transpose).
        for k in ("w_gate.weight", "w_up.weight", "w_down.weight"):
            del layer[k]
        layer.update({
            "router": ("embed", "expert"),
            "w_gate": ("expert", "embed", "mlp"),
            "w_up": ("expert", "embed", "mlp"),
            "w_down": ("expert", "mlp", "embed"),
        })
    for i in range(cfg.n_layers):
        axes.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return axes


def parallelize(model: Transformer, ftmesh: Any) -> Transformer:
    """Runs ``model`` over ``ftmesh``'s in-group mesh: its parameters become
    DTensors placed by :func:`param_axes` and the mesh's rules (every rank
    built the same weights from one seed), and the forward computes each
    rank's share (module docstring).  Feed each rank its slice of the
    group's batch (``ftmesh.batch_shard``), and over "sequence" its slice
    of each sequence (``data.shard_sequence``).  In place; returns
    ``model``.  A mixture-of-experts model composes with every axis but
    "pipeline" (``pipeline_stage`` refuses it).  Over "sequence" above 1
    attention must be "ring" or "ulysses": "flash" would attend each rank's
    slice alone, and raises ``ValueError``."""
    if ftmesh.mesh is None:
        return model
    cfg = model.cfg
    tp = ftmesh.size("tensor")
    if ftmesh.size("sequence") > 1 and cfg.attention == "flash":
        raise ValueError("attention 'flash' over a 'sequence' axis above 1 attends each "
                         "rank's slice alone; use attention='ring' or 'ulysses'")
    for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{what} {n} does not divide over tensor {tp}")
    if cfg.moe_experts > 0 and cfg.moe_experts % ftmesh.size("expert"):
        raise ValueError(f"moe_experts {cfg.moe_experts} does not divide over expert "
                         f"{ftmesh.size('expert')}")
    ftmesh.shard_params(model, param_axes(cfg))
    model.ftmesh = ftmesh
    for layer in model.layers:
        layer.ftmesh = ftmesh
    return model
