"""Conformer (Gulati et al. 2020) and Transformer (Vaswani et al. 2017) encoder stacks.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/
conformer.py`` (``ConformerSpec``, ``init_conformer``, ``apply_conformer``).
``block="conformer"`` layers are macaron: ½FF -> MHSA -> conv -> ½FF -> LN;
``block="transformer"`` layers are pre-LN, x += MHSA(LN x); x += FF(LN x),
with one final ``ln_out``. Positions are ``absolute`` sinusoids added after
``proj``, ``relative`` Transformer-XL scores (q+u)·k + rel_shift((q+v)·r),
or ``rotary`` (RoPE on interleaved channel pairs); ``left_context >= 0``
makes the stack chunk-causal (windowed attention, left-padded conv). With
``moe_experts > 1`` each block's final FF is a top-k-gated expert bank,
evaluated densely (every expert on every frame), whose Switch load-balance
loss comes back beside the outputs.

The module tree reproduces the JAX parameter tree key for key
(``proj.w``, ``layers.0.ff1.in.w``, ``layers.0.mhsa.pos_u``,
``layers.0.conv.dw [k, 1, d]``, ``layers.0.moe.router.w``, ``ln_out.g``),
so weights cross with ``utils/bridge.py``. The arithmetic is the
reference's: LayerNorm with eps 1e-6 inside the rsqrt, masked scores filled
with -1e30 (a row with no valid key gets a uniform softmax), pad outputs
zeroed. The products run as ``torch.matmul`` and one grouped ``F.conv1d``;
there is no TPU kernel on this path. ``depthwise_impl`` is accepted and
computes the same function either way (``"shifts"`` exists in the JAX
package for its SPMD partitioner). ``compute_dtype: bfloat16`` rounds the
inputs of every product that the reference runs with
``preferred_element_type`` (the dense layers, the attention scores with
their ``rel_shift`` / RoPE terms, the context, the MoE bank) to bf16 and
sums them in float32 (``ops/bf16.matmul``); LayerNorm, the router, the
softmax, the depthwise conv and the residuals stay float32.

Inside a train step over a mesh with model, sequence or expert shards or
pipeline stages (``parallel.mesh.global_batch``; ``step_shards``) each rank
runs its part with the collectives of ``parallel/``: MHSA its h/M heads and
each FF its ff/M columns between Megatron's *f* and *g* (``parallel/tp.py``);
the stack its frames of T padded to a multiple of S, MHSA with K and V
gathered from every seq rank at the queries' global frames, the depthwise
conv with its neighbours' halo, one gather at the exit (``parallel/sp.py``);
the MoE bank its E/X experts (``parallel/ep.py``); the stack its stage's
layers over microbatches of its rows, between the hops to the neighbour
stages (``parallel/pp.py``). Each module has one body, and each block one
``forward``, which the sequential loop and the pipeline stages both run:
outside a step (eval, serving) or on a mesh without such shards one rank
holds every layer, head, column, frame and expert, and the collectives are
the identity.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bf16 as bf16_ops
from ..parallel.mesh import (
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    batch_sum,
    step_placement,
)
from ..parallel.pp import apply_conformer_pipelined, stage_generator
from ..parallel.sp import SeqShard, gather_seq, halo, seq_shard
from ..parallel.tp import copy_to, reduce_from
from .rnn import dropout

MASK_FILL = -1e30


class ConformerSpec(NamedTuple):
    """Same fields and defaults as the JAX ``ConformerSpec``."""

    dim: int = 256
    num_layers: int = 8
    num_heads: int = 4
    conv_kernel_size: int = 15
    ff_expansion: int = 4
    compute_dtype: str = "float32"
    block: str = "conformer"  # "conformer" (macaron + conv) | "transformer" (pre-LN)
    depthwise_impl: str = "conv"  # "conv" | "shifts": the same function here
    moe_experts: int = 0  # > 1: each block's final FF is a top-k expert bank
    moe_top_k: int = 2
    moe_aux_weight: float = 1e-2
    pos_encoding: str = "absolute"  # "absolute" | "relative" | "rotary"
    left_context: int = -1  # >= 0: chunk-causal attention window and causal conv

    @property
    def is_moe(self) -> bool:
        return bool(self.moe_experts and self.moe_experts > 1)

    def validate(self):
        """Raise a clear config error, as the JAX ``validate``."""
        if self.dim % self.num_heads:
            raise ValueError(f"conformer dim {self.dim} must be divisible by num_heads "
                             f"{self.num_heads}")
        if self.dim % 2:
            raise ValueError(f"conformer dim {self.dim} must be even (sinusoidal posenc "
                             f"pairs sin/cos channels)")
        if self.pos_encoding not in ("absolute", "relative", "rotary"):
            raise ValueError(f"pos_encoding must be 'absolute', 'relative' or 'rotary', "
                             f"got {self.pos_encoding!r}")
        if self.pos_encoding == "rotary" and (self.dim // self.num_heads) % 2:
            raise ValueError(f"rotary needs an even head dim, got {self.dim}/{self.num_heads} "
                             f"= {self.dim // self.num_heads}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: float32 or bfloat16")

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == "bfloat16"


def _uniform(shape, s: float, generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * s


def _xavier(fin: int, fout: int, generator) -> torch.Tensor:
    return _uniform((fin, fout), math.sqrt(6.0 / (fin + fout)), generator)


class Dense(nn.Module):
    """x @ w + b, w [fin, fout] Xavier-uniform and b zero (``_dense_init``);
    with ``bf16`` the product of ``_dense(p, x, bf16)``."""

    def __init__(self, fin: int, fout: int, generator=None, bf16: bool = False):
        super().__init__()
        self.bf16 = bf16
        self.w = nn.Parameter(_xavier(fin, fout, generator))
        self.b = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bf16_ops.linear(x, self.w, self.bf16) + self.b


class LayerNorm(nn.Module):
    """``_ln``: biased variance, eps inside the rsqrt, g = 1 and b = 0 at init."""

    def __init__(self, d: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d))
        self.b = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * self.g + self.b


class FeedForward(nn.Module):
    """``_ff``: LN -> dense -> swish -> dense (children ``ln``, ``in``, ``out``)."""

    def __init__(self, spec: ConformerSpec, generator=None):
        super().__init__()
        e = spec.dim * spec.ff_expansion
        self.ln = LayerNorm(spec.dim)
        self.add_module("in", Dense(spec.dim, e, generator, spec.bf16))
        self.out = Dense(e, spec.dim, generator, spec.bf16)

    def forward(self, x: torch.Tensor, shards: "Shards | None" = None) -> torch.Tensor:
        # column-parallel in (this rank's ff/M columns) -> row-parallel out, then its bias
        g = shards.model.group if shards is not None else None
        y = F.silu(self._modules["in"](copy_to(self.ln(x), g)))
        return reduce_from(bf16_ops.linear(y, self.out.w, self.out.bf16), g) + self.out.b


class _Weights(nn.Module):
    """A named group of raw parameters (``router``, the stacked expert ``in`` / ``out``,
    the relative-position projection ``pos``, which has no bias)."""

    def __init__(self, **params: torch.Tensor):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))


class MoEFeedForward(nn.Module):
    """``_moe_ff``: the top-k-gated expert bank with stacked weights
    (``in.w [E, d, ff]``, ``in.b [E, ff]``, ``out.w [E, ff, d]``, ``out.b
    [E, d]``) and the router ``router.w [d, E]`` (0.01 · normal, no bias)."""

    def __init__(self, spec: ConformerSpec, generator=None):
        super().__init__()
        d, e, n = spec.dim, spec.dim * spec.ff_expansion, spec.moe_experts
        s = math.sqrt(6.0 / (d + e))
        self.spec = spec
        self.ln = LayerNorm(d)
        self.router = _Weights(w=0.01 * torch.randn((d, n), generator=generator))
        self.add_module("in", _Weights(w=_uniform((n, d, e), s, generator), b=torch.zeros(n, e)))
        self.out = _Weights(w=_uniform((n, e, d), s, generator), b=torch.zeros(n, d))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, shards: "Shards | None" = None):
        """(out [B, T, d], aux loss scalar). Gates keep every expert whose
        probability is at least the k-th largest (ties keep more than k),
        renormalised; the aux loss is E · Σ_e fraction_e · mean_prob_e over
        the valid frames (1.0 = balanced), with fractions from the argmax.
        Inside a train step over ranks (``parallel.mesh.global_batch``) the
        frames are the global batch's: the fractions and the frame count
        are summed over the ranks that hold other rows or frames, and the
        aux loss is this rank's share of the global term
        (``train/accum.weighted_value_and_grad``). With ``expert`` shards
        (``parallel/ep.py``) the bank holds this rank's E/X experts: they
        run over every frame, and their gated sum is summed over the
        expert line."""
        n = self.spec.moe_experts
        k = min(self.spec.moe_top_k, n)
        y = self.ln(x)
        probs = torch.softmax(torch.matmul(y, self.router.w), dim=-1)  # [B, T, E]
        if k < n:
            kth = probs.topk(k, dim=-1).values[..., -1:]
            gates = torch.where(probs >= kth, probs, 0.0)
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        else:
            gates = probs
        experts = (shards if shards is not None else Shards.whole(mask)).expert
        local = n // experts.size  # this rank's experts: f on their inputs
        y_e = copy_to(y, experts.group)
        gates_e = copy_to(gates, experts.group)[..., experts.rank * local:
                                                (experts.rank + 1) * local]
        w_in, w_out = self._modules["in"], self.out
        if self.spec.bf16:  # y [1, B, T, d] @ w [E, 1, d, f]: every expert on every frame
            h = bf16_ops.matmul(y_e[None], w_in.w[:, None])
        else:
            h = torch.einsum("btd,edf->ebtf", y_e, w_in.w)
        h = F.silu(h + w_in.b[:, None, None, :])
        if self.spec.bf16:
            o = bf16_ops.matmul(h, w_out.w[:, None])
        else:
            o = torch.einsum("ebtf,efd->ebtd", h, w_out.w)
        o = o + w_out.b[:, None, None, :]
        out = reduce_from(torch.einsum("ebtd,bte->btd", o, gates_e),
                          experts.group)  # g: the other ranks' experts
        m = mask.to(probs.dtype)
        one_hot = F.one_hot(probs.argmax(dim=-1), n).to(probs.dtype)
        # inside a train step over ranks the counts are the global batch's,
        # and this rank's probabilities give its share of the global mean
        counts, frames = batch_sum((one_hot * m[..., None]).sum((0, 1)), m.sum())
        denom = frames.clamp_min(1.0)
        frac = counts / denom
        mean_p = (probs * m[..., None]).sum((0, 1)) / denom
        return out, n * (frac * mean_p).sum()


def sinusoids(pos: torch.Tensor, d: int) -> torch.Tensor:
    """``[sin | cos]`` halves of pos / 10000^(2i/d) for positions ``pos`` [...]:
    [..., d] (``_posenc``, ``_posenc_at`` and ``_rel_posemb``'s formula)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.to(torch.float32)[..., None] / torch.pow(10000.0, 2.0 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def posenc(t: int, d: int, device=None) -> torch.Tensor:
    """Absolute sinusoids [T, d] (``_posenc``)."""
    return sinusoids(torch.arange(t, dtype=torch.float32, device=device), d)


def rel_posemb(t: int, d: int, device=None) -> torch.Tensor:
    """Sinusoids of the relative offsets t-1 .. -(t-1): [2t-1, d], row k at
    offset t-1-k (``_rel_posemb``)."""
    return sinusoids(torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device), d)


def rope_at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x [B, h, T, dh] at positions ``pos`` [B, T]
    (``_rope_at``): channel pair (2i, 2i+1) rotates by pos / 10000^(2i/dh),
    and the pairs are written back interleaved."""
    b, h, t, dh = x.shape
    inv = torch.pow(10000.0, -2.0 * torch.arange(dh // 2, dtype=torch.float32,
                                                  device=x.device) / dh)
    theta = pos.to(torch.float32)[:, None, :, None] * inv  # [B, 1, T, dh/2]
    cos, sin = torch.cos(theta), torch.sin(theta)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(b, h, t, dh)


def rope(x: torch.Tensor) -> torch.Tensor:
    """``_rope``: ``rope_at`` at positions 0 .. T-1."""
    b, _, t, _ = x.shape
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[None].expand(b, t)
    return rope_at(x, pos)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, h, T, 2T-1] -> [B, h, T, T], out[..., i, j] = x[..., i, T-1-i+j]:
    the Transformer-XL pad-reshape of ``_rel_shift``."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)
    return x[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]


def window_mask(t: int, left_context: int, device=None) -> torch.Tensor:
    """[T, T] bool: query i sees key j iff j <= i and i - j <= left_context."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    return (j <= i) & (i - j <= left_context)


def rel_shift_at(x: torch.Tensor, qpos: torch.Tensor, t: int) -> torch.Tensor:
    """``rel_shift`` for queries at global frames ``qpos`` [Tq] of T:
    [B, h, Tq, 2T-1] -> [B, h, Tq, T], out[..., i, j] = x[..., i, T-1-qpos_i+j]."""
    idx = (t - 1 - qpos)[:, None] + torch.arange(t, device=x.device)[None, :]
    return torch.gather(x, -1, idx.expand(x.shape[:-1] + (t,)))


def window_at(qpos: torch.Tensor, t: int, left_context: int) -> torch.Tensor:
    """``window_mask``'s rows of the queries at global frames ``qpos``: [Tq, T]."""
    i = qpos[:, None]
    j = torch.arange(t, device=qpos.device)[None, :]
    return (j <= i) & (i - j <= left_context)


class Shards(NamedTuple):
    """This rank's part of a conformer inside a train step over a mesh
    (``parallel/``): the 1-D meshes of its ``model`` line (its h/M heads and
    ff/M FF columns) and its ``expert`` line (its E/X experts), its frames
    (``seq``, None without sequence shards) and the key mask of every frame
    [B, T padded]."""

    model: Mesh
    expert: Mesh
    seq: SeqShard | None
    key_mask: torch.Tensor

    @staticmethod
    def whole(key_mask: torch.Tensor) -> "Shards":
        """One rank holding every head, column, frame and expert."""
        one = Mesh(0, 1, key_mask.device)
        return Shards(one, one, None, key_mask)


def step_shards(t: int, lengths: torch.Tensor) -> Shards:
    """The ``Shards`` of a T-frame batch in the running train step (whole
    outside a step)."""
    mesh, _ = step_placement()
    seq = seq_shard(mesh, t)
    t_all = seq.padded if seq is not None else t
    key_mask = torch.arange(t_all, device=lengths.device)[None, :] < lengths[:, None]
    return Shards(mesh.along(MODEL_AXIS), mesh.along(EXPERT_AXIS), seq, key_mask)


class MHSA(nn.Module):
    """``_mhsa``: LN, q/k/v/o projections, positions by the spec's scheme
    (``pos`` [d, d] with no bias and ``pos_u`` / ``pos_v`` [h, dh] zeros for
    ``relative``), scores / sqrt(dh) masked with -1e30 (keys, then the
    window), softmax, and the output projection.

    With ``shards`` it runs this rank's heads (``model``: q / k / v
    column-parallel behind *f*, o row-parallel before *g* and its bias; the
    relative-position leaves behind *f* too, so each model rank gets their
    whole gradient) and frames (``seq``: local queries at their global
    frames, K and V gathered from every seq rank)."""

    def __init__(self, spec: ConformerSpec, generator=None):
        super().__init__()
        d = spec.dim
        self.spec = spec
        self.ln = LayerNorm(d)
        self.q, self.k = Dense(d, d, generator, spec.bf16), Dense(d, d, generator, spec.bf16)
        self.v, self.o = Dense(d, d, generator, spec.bf16), Dense(d, d, generator, spec.bf16)
        if spec.pos_encoding == "relative":
            h = spec.num_heads
            self.pos = _Weights(w=_xavier(d, d, generator))
            self.pos_u = nn.Parameter(torch.zeros(h, d // h))
            self.pos_v = nn.Parameter(torch.zeros(h, d // h))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                shards: Shards | None = None) -> torch.Tensor:
        shards = shards if shards is not None else Shards.whole(mask)
        b, t, d = x.shape
        h, m, seq = self.spec.num_heads, shards.model, shards.seq
        dh = d // h
        hl = h // m.size
        first = m.rank * hl  # this rank's first head
        heads, cols = slice(first, first + hl), slice(first * dh, (first + hl) * dh)
        y = copy_to(self.ln(x), m.group)
        split = lambda z: z.reshape(b, t, hl, dh).transpose(1, 2)  # noqa: E731  [B, h/M, T, dh]
        q, k, v = split(self.q(y)), split(self.k(y)), split(self.v(y))
        mm = lambda a, b: bf16_ops.linear(a, b, self.spec.bf16)  # noqa: E731
        t_all = seq.padded if seq is not None else t
        qpos = seq.positions(x.device) if seq is not None else None
        if self.spec.pos_encoding == "rotary":
            if seq is None:
                q, k = rope(q), rope(k)
            else:
                pos = qpos[None].expand(b, t)
                q, k = rope_at(q, pos), rope_at(k, pos)
        if seq is not None:
            k, v = gather_seq(k, seq, dim=2), gather_seq(v, seq, dim=2)
        if self.spec.pos_encoding == "relative":
            pos_w, pos_u, pos_v = (copy_to(p, m.group) for p in (self.pos.w, self.pos_u,
                                                                  self.pos_v))
            r = mm(rel_posemb(t_all, d, x.device), pos_w[:, cols])  # [2T-1, d/M]
            r = r.reshape(2 * t_all - 1, hl, dh).transpose(0, 1)
            ac = mm(q + pos_u[heads][None, :, None, :], k.transpose(-1, -2))
            bd = mm(q + pos_v[heads][None, :, None, :], r.transpose(-1, -2))
            scores = ac + (rel_shift(bd) if seq is None else rel_shift_at(bd, qpos, t_all))
        else:
            scores = mm(q, k.transpose(-1, -2))
        scores = scores / math.sqrt(dh)
        scores = torch.where(shards.key_mask[:, None, None, :], scores, MASK_FILL)
        if self.spec.left_context >= 0:
            win = (window_mask(t, self.spec.left_context, x.device) if seq is None
                   else window_at(qpos, t_all, self.spec.left_context))
            scores = torch.where(win[None, None], scores, MASK_FILL)
        out = mm(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, hl * dh)
        return reduce_from(bf16_ops.linear(out, self.o.w, self.o.bf16), m.group) + self.o.b


class ConvModule(nn.Module):
    """``_conv_module``: LN -> pw1 (2d) -> GLU -> mask -> depthwise conv
    (``dw`` [k, 1, d]; SAME padding, or k-1 frames on the left when
    ``left_context >= 0``) -> LN (``norm``) -> swish -> pw2."""

    def __init__(self, spec: ConformerSpec, generator=None):
        super().__init__()
        d, k = spec.dim, spec.conv_kernel_size
        self.spec = spec
        self.ln = LayerNorm(d)
        self.pw1 = Dense(d, 2 * d, generator, spec.bf16)
        self.dw = nn.Parameter(_uniform((k, 1, d), math.sqrt(6.0 / (k + d)), generator))
        self.norm = LayerNorm(d)
        self.pw2 = Dense(d, d, generator, spec.bf16)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                shards: Shards | None = None) -> torch.Tensor:
        a, g = self.pw1(self.ln(x)).chunk(2, dim=-1)
        y = a * torch.sigmoid(g) * mask[..., None]  # pad frames must not leak through the conv
        causal = self.spec.left_context >= 0
        if shards is not None and shards.seq is not None:  # the neighbours' frames as padding
            lo, hi = conv_padding(self.dw.shape[0], causal)
            y = depthwise_conv(halo(y, shards.seq, lo, hi), self.dw, causal, pad=False)
        else:
            y = depthwise_conv(y, self.dw, causal)
        return self.pw2(F.silu(self.norm(y)))


def conv_padding(k: int, causal: bool) -> tuple:
    """(left, right) frames of a k-tap depthwise conv: SAME, or k - 1 on the left."""
    lo = k - 1 if causal else (k - 1) // 2
    return lo, k - 1 - lo


def depthwise_conv(y: torch.Tensor, dw: torch.Tensor, causal: bool,
                   pad: bool = True) -> torch.Tensor:
    """y [B, T, d] * dw [k, 1, d] as one grouped cross-correlation (as
    ``conv_general_dilated``): w[c, 0, i] = dw[i, 0, c], no flip; padded
    ((k-1)//2, k-1-(k-1)//2) (SAME), or (k-1, 0) when ``causal``; with
    ``pad`` False ``y`` carries its padding frames already."""
    d = dw.shape[2]
    yp = y.transpose(1, 2)
    if pad:
        yp = F.pad(yp, conv_padding(dw.shape[0], causal))
    return F.conv1d(yp, dw.permute(2, 1, 0), groups=d).transpose(1, 2)


def final_ff(layer, x: torch.Tensor, mask: torch.Tensor, shards: Shards) -> tuple:
    """(the block's final FF of x, the MoE load-balance loss or None)."""
    if hasattr(layer, "moe"):
        return layer.moe(x, mask, shards)
    return (layer.ff if hasattr(layer, "ff") else layer.ff2)(x, shards), None


class ConformerLayer(nn.Module):
    """One macaron block: ``ff1``, ``mhsa``, ``conv``, ``ff2`` or ``moe``, ``ln``."""

    def __init__(self, spec: ConformerSpec, generator=None):
        super().__init__()
        self.ff1 = FeedForward(spec, generator)
        self.mhsa = MHSA(spec, generator)
        self.conv = ConvModule(spec, generator)
        if spec.is_moe:
            self.moe = MoEFeedForward(spec, generator)
        else:
            self.ff2 = FeedForward(spec, generator)
        self.ln = LayerNorm(spec.dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, shards: Shards, drop) -> tuple:
        """(x after the block, its MoE load-balance loss or None); ``drop``
        is the dropout of each of the four sites, before the macaron ½."""
        x = x + 0.5 * drop(self.ff1(x, shards))
        x = x + drop(self.mhsa(x, mask, shards))
        x = x + drop(self.conv(x, mask, shards))
        y, aux = final_ff(self, x, mask, shards)
        return self.ln(x + 0.5 * drop(y)), aux


class TransformerLayer(nn.Module):
    """One pre-LN block: ``mhsa``, ``ff`` or ``moe``."""

    def __init__(self, spec: ConformerSpec, generator=None):
        super().__init__()
        self.mhsa = MHSA(spec, generator)
        if spec.is_moe:
            self.moe = MoEFeedForward(spec, generator)
        else:
            self.ff = FeedForward(spec, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, shards: Shards, drop) -> tuple:
        """(x after the block, its MoE load-balance loss or None)."""
        x = x + drop(self.mhsa(x, mask, shards))
        y, aux = final_ff(self, x, mask, shards)
        return x + drop(y), aux


class Conformer(nn.Module):
    """The stack: ``proj`` [input_dim, dim], ``layers``, and ``ln_out`` for
    the transformer block. Weights drawn from ``generator`` as
    ``init_conformer`` draws them (Xavier-uniform dense weights, zero biases,
    LayerNorm 1 / 0, the router 0.01 · normal, ``dw`` uniform in
    ±sqrt(6 / (k + d)))."""

    def __init__(self, spec: ConformerSpec, input_dim: int, generator=None):
        super().__init__()
        spec.validate()
        self.spec = spec
        layer = TransformerLayer if spec.block == "transformer" else ConformerLayer
        self.layers = nn.ModuleList(layer(spec, generator) for _ in range(spec.num_layers))
        self.proj = Dense(input_dim, spec.dim, generator, spec.bf16)
        if spec.block == "transformer":
            self.ln_out = LayerNorm(spec.dim)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, keep_prob: float = 1.0,
                microbatches: int = 8):
        """[B, T, D] -> ([B, T, dim] with pad frames zeroed, aux): ``apply_conformer``.

        ``aux`` is the MoE load-balance loss, ``moe_aux_weight · Σ aux /
        num_layers``, when ``moe_experts > 1``, else None. With ``train`` and a
        ``generator`` (on the inputs' device), dropout at the four sites of
        each layer, drawn in the reference's site order; the macaron ½
        applies after the dropout. Inside a train step over a mesh with
        pipeline stages the layers run as this rank's stage of a GPipe
        pipeline over ``microbatches`` microbatches of its rows
        (``parallel/pp.py``; the weights of the other stages' layers are not
        given), dropout drawn from the stage's generator
        (``pp.stage_generator``).
        """
        spec = self.spec
        t = xs.shape[1]
        mask = torch.arange(t, device=xs.device)[None, :] < lengths.to(xs.device)[:, None]
        shards = step_shards(t, lengths.to(xs.device))
        seq = shards.seq
        if seq is not None:  # this rank's frames from here to the exit gather
            xs, mask = seq.cut(xs), seq.cut(shards.key_mask)
        x = self.proj(xs)
        if spec.pos_encoding == "absolute":
            if seq is None:
                x = x + posenc(t, spec.dim, xs.device)[None]
            else:
                x = x + sinusoids(seq.positions(xs.device), spec.dim)[None]

        def drop(z, gen=generator):
            if not (train and gen is not None):
                return z
            if seq is None or keep_prob >= 1.0:
                return dropout(z, keep_prob, train, gen)
            # every seq rank draws the mask of all frames and keeps its own
            shape = (z.shape[0], seq.padded) + tuple(z.shape[2:])
            keep = seq.cut(torch.rand(shape, generator=gen, device=z.device)) < keep_prob
            return torch.where(keep, z / keep_prob, 0.0)

        mesh, _ = step_placement()
        aux_total = []
        if mesh.degree(PIPE_AXIS) > 1:  # this rank's stage of the layers, in microbatches
            if train and generator is not None and keep_prob < 1.0:
                drop = functools.partial(drop, gen=stage_generator(generator,
                                                                   mesh.coord(PIPE_AXIS)))
            x = apply_conformer_pipelined(self.layers, x, mask, shards, drop, mesh,
                                          microbatches)
        else:
            for layer in self.layers:
                x, aux = layer(x, mask, shards, drop)
                aux_total.append(aux)
        if spec.block == "transformer":
            x = self.ln_out(x)
        out = x * mask[..., None]
        if seq is not None:  # every frame for the head and the loss
            out = gather_seq(out, seq)[:, :t]
        if not spec.is_moe:
            return out, None
        return out, spec.moe_aux_weight * torch.stack(aux_total).sum() / len(self.layers)
