"""Sequence (context) parallelism: the conformer's time axis over ``seq``.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/sp.py``.
The JAX package pins the encoder's activations to ``P(data, seq, None)``
at the stack entry and after every block and lets XLA derive the attention
gathers and conv halos. Here ``models/conformer.py`` runs them, with the
weights replicated:

- after ``proj`` and the absolute sinusoids, seq rank s of S keeps frames
  [s·T/S, (s+1)·T/S) of T padded up to a multiple of S (``SeqShard``); the
  padded frames are masked, which is exact: they act as SAME padding;
- MHSA keeps its queries local and all-gathers K and V (``gather_seq``,
  whose backward is a reduce-scatter); relative shifts, RoPE and the
  chunk-causal window take the queries' global frame indices;
- the depthwise conv swaps a halo with its neighbours (``halo``): (k - 1)/2
  frames each side, or k - 1 on the left when ``left_context >= 0``, zeros
  past the sequence's ends; the backward returns the halo's gradient to
  its owner;
- after the stack one all-gather over ``seq`` gives the head and loss all
  T frames. Each seq rank weighs its loss by 1/S and the gather's backward
  sums the ranks' cotangents, so every leaf's gradient is a sum over
  ``data`` x ``seq`` and what every seq rank computes whole counts once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import DATA_AXIS, SEQ_AXIS, Mesh, count_traffic, make_grid


def make_mesh_dp_sp(num_data: int, num_seq: int, device=None) -> Mesh:
    """A ``(data, seq)`` mesh over the process group's ranks, ``seq`` minor."""
    return make_grid({DATA_AXIS: num_data, SEQ_AXIS: num_seq}, device)


class SeqShard(NamedTuple):
    """This rank's frames of a T-frame sequence: ``n`` ranks along ``seq``,
    this one ``index``, ``local`` frames each of ``padded`` = n · local."""

    group: object
    n: int
    index: int
    local: int
    padded: int

    @property
    def start(self) -> int:
        return self.index * self.local

    def positions(self, device=None) -> torch.Tensor:
        """The global frame indices of this rank's frames."""
        return torch.arange(self.start, self.start + self.local, device=device)

    def cut(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's frames of ``x`` (whole along ``dim``), zero-padded to ``padded``."""
        t = x.shape[dim]
        if t < self.padded:
            pad = [0, 0] * (x.dim() - 1 - dim) + [0, self.padded - t]
            x = F.pad(x, pad)
        return x.narrow(dim, self.start, self.local)


def seq_shard(mesh: Mesh, t: int) -> SeqShard | None:
    """The ``SeqShard`` of a T-frame sequence on ``mesh``, None without ``seq`` shards."""
    line = mesh.along(SEQ_AXIS)
    if line.size == 1:
        return None
    local = -(-t // line.size)
    return SeqShard(line.group, line.size, line.rank, local, local * line.size)


def seq_shard_fn(mesh: Mesh):
    """``[B, T, D] -> this rank's frames`` (the counterpart of the JAX
    ``shard_fn`` that pins activations to ``P(data, seq, None)``)."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        shard = seq_shard(mesh, x.shape[1])
        return x if shard is None else shard.cut(x)

    return fn


def setup_sequence_parallel(mesh: Mesh, params: dict, opt_state=None, batch=None):
    """Place training state for dp x sp: parameters and moments replicated
    (broadcast from rank 0), the batch's rows by data index (every seq rank
    of a data line holds them whole; the encoder cuts its frames)."""
    from .fsdp import place

    return place(mesh, params, opt_state, None, batch)


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` of ``group``, in rank order."""
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    count_traffic("all_gather", x)
    dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    return out


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` (the ranks' blocks in order); the backward
    sums the ranks' cotangents and keeps this rank's block (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        parts = _all_gather(x.movedim(dim, 0), group, n)  # [n, local, ...]
        return parts.reshape((n * x.shape[dim],) + parts.shape[2:]).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((g.shape[0] // ctx.n,) + g.shape[1:], dtype=g.dtype, device=g.device)
        count_traffic("reduce_scatter", g)
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


def gather_seq(x: torch.Tensor, shard: SeqShard, dim: int = 1) -> torch.Tensor:
    """Every seq rank's frames of ``x`` along ``dim``: [..., padded, ...]."""
    return _GatherSeq.apply(x, shard.group, shard.n, dim)


class _Halo(torch.autograd.Function):
    """[B, local, d] -> [B, lo + local + hi, d]: the left neighbour's last
    ``lo`` frames and the right neighbour's first ``hi`` (zeros past the
    ends), by one all-gather of every rank's edges; the backward gathers the
    halos' gradients and adds each to the frames it came from."""

    @staticmethod
    def forward(ctx, y, group, n, index, lo, hi):
        ctx.group, ctx.n, ctx.index, ctx.lo, ctx.hi = group, n, index, lo, hi
        t = y.shape[1]
        edges = _all_gather(torch.cat([y[:, :hi], y[:, t - lo:]], 1), group, n)
        left = edges[index - 1][:, hi:] if index > 0 else y.new_zeros(y.shape[0], lo, y.shape[2])
        right = (edges[index + 1][:, :hi] if index < n - 1
                 else y.new_zeros(y.shape[0], hi, y.shape[2]))
        return torch.cat([left, y, right], 1)

    @staticmethod
    def backward(ctx, g):
        lo, hi, n, index = ctx.lo, ctx.hi, ctx.n, ctx.index
        t = g.shape[1] - lo - hi
        halos = _all_gather(torch.cat([g[:, :lo], g[:, lo + t:]], 1), ctx.group, n)
        gy = g[:, lo:lo + t].clone()
        if index < n - 1 and lo:  # the right neighbour's left halo is this rank's tail
            gy[:, t - lo:] += halos[index + 1][:, :lo]
        if index > 0 and hi:  # the left neighbour's right halo is this rank's head
            gy[:, :hi] += halos[index - 1][:, lo:]
        return gy, None, None, None, None, None


def halo(y: torch.Tensor, shard: SeqShard, lo: int, hi: int) -> torch.Tensor:
    """``y`` [B, local, d] with ``lo`` frames of its left neighbours before it
    and ``hi`` of its right ones after it, zeros past the sequence's ends: a
    depthwise conv of k taps over it needs no padding. A block shorter than
    the halo takes the frames from every rank (``gather_seq``)."""
    if shard.local >= max(lo, hi):
        return _Halo.apply(y, shard.group, shard.n, shard.index, lo, hi)
    whole = F.pad(gather_seq(y, shard), (0, 0, lo, hi))
    return whole[:, shard.start:shard.start + lo + shard.local + hi]
