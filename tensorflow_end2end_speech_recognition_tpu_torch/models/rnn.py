"""Recurrent layers: the LSTM kernels' layers, and the scan path's cells.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/rnn.py``.
The plain LSTM cell takes the Pallas branches of ``bidirectional_scan`` and
``rnn_scan`` there: the input projection ``x @ Wx + b`` for all timesteps is
one ``torch.matmul`` per direction, the backward direction's projection is
reversed over each row's valid prefix, and ``ops.lstm.lstm_bidi``
(``BiLSTM``) or ``ops.lstm.lstm_layer`` (``LSTM``, one direction) runs the
recurrence (through its ``torch.autograd.Function`` when a gradient may be
taken). With ``compute_dtype="bfloat16"`` these layers take the reference's
bf16 recipes: ``BiLSTM`` rounds ``xs`` and ``wx`` to bf16, sums the product
in float32, adds ``b`` and rounds ``xproj`` to bf16 once
(``bidirectional_scan``); ``LSTM`` forms the product in float32 (a bf16
``xs`` is promoted) and rounds ``xproj`` (``rnn_scan``). The kernels then
run with bf16 streams and return bf16 ``ys``. A streaming chunk's ``LSTM``
(a carried ``initial_state``) takes ``rnn_scan``'s scan branch instead: a
float32 ``xproj``, not rounded, each step's ``h @ Wh`` on bf16 operands
with float32 sums (``lstm_layer(..., bf16_product=True)``), float32 ``ys``.

The cells the kernels do not compute (``RNNSpec.on_kernels`` false: GRU,
and the LSTM with a peephole, a recurrent projection ``num_proj`` or a cell
clip ``clip_activation``, each read by truth, so 0 means off) take the scan
branch of ``rnn_scan`` there, as the reference does at every backend:
``ScanRNN`` (one direction) and ``ScanBiRNN`` (two independent scans) hoist
``xproj`` in float32 and run ``lstm_cell_step`` / ``gru_cell_step`` once per
time step in a Python loop, under autograd, from an optional carried state.
At ``compute_dtype="bfloat16"`` the option LSTM rounds ``h_prev`` and ``Wh``
for ``h @ Wh`` and sums in float32 (``ops/bf16.matmul``); the peephole, the
clip, ``wproj`` and ``xproj`` stay float32, and GRU casts nothing. Their
outputs are float32.

``lstm_step`` is one step of the plain cell (``_lstm_step`` there, which
the JAX package runs in XLA, not in a kernel): the attention decoder's cell,
and through ``lstm_scan`` (the scan branch of ``rnn_scan``, with a carried
``(h, c)``) the transducer's prediction net. ``dropout`` is the inverted
dropout of ``models/rnn.py`` there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops import bf16 as bf16_ops
from ..ops.lstm import lstm_bidi, lstm_layer


def flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix in time; identity on the pad tail."""
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    lengths = lengths.to(x.device)[:, None]
    src = torch.where(idx < lengths, lengths - 1 - idx, idx)
    src = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, src)


def length_mask(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T] float32 on ``xs``'s device: 1 on each row's first ``lengths`` steps."""
    return (torch.arange(xs.shape[1], device=xs.device)[None, :]
            < lengths.to(xs.device)[:, None]).to(torch.float32)


class LSTMParams(nn.Module):
    """One direction's weights in the JAX layout: wx [D,4H], wh [H,4H], b [4H]."""

    def __init__(self, input_dim: int, num_units: int, param_init: float,
                 generator: torch.Generator | None = None):
        super().__init__()

        def uniform(*shape):
            return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * param_init

        self.wx = nn.Parameter(uniform(input_dim, 4 * num_units))
        self.wh = nn.Parameter(uniform(num_units, 4 * num_units))
        self.b = nn.Parameter(torch.zeros(4 * num_units))


class BiLSTM(nn.Module):
    """One BLSTM layer: [B, T, D] -> [B, T, 2H] (forward ++ backward outputs),
    bf16 outputs under ``compute_dtype="bfloat16"``."""

    def __init__(self, input_dim: int, num_units: int, param_init: float = 0.1,
                 forget_bias: float = 1.0, generator: torch.Generator | None = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.forget_bias = forget_bias
        self.bf16 = compute_dtype == "bfloat16"
        self.fwd = LSTMParams(input_dim, num_units, param_init, generator)
        self.bwd = LSTMParams(input_dim, num_units, param_init, generator)

    def _project(self, xs: torch.Tensor, p: LSTMParams) -> torch.Tensor:
        if self.bf16:  # bf16 operands, float32 sums, + b, one rounding to bf16
            return (bf16_ops.matmul(xs, p.wx, bf16_cotangent=True) + p.b).to(bf16_ops.BF16)
        return torch.matmul(xs, p.wx) + p.b

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        xproj_f = self._project(xs, self.fwd)
        xproj_b = flip_valid(self._project(xs, self.bwd), lengths)
        ys_f, ys_b = lstm_bidi(xproj_f, xproj_b, self.fwd.wh, self.bwd.wh,
                               length_mask(xs, lengths), self.forget_bias)
        return torch.cat([ys_f, flip_valid(ys_b, lengths)], dim=-1)


class LSTM(LSTMParams):
    """One unidirectional LSTM layer: [B, T, D] -> [B, T, H].

    Its weights sit on the layer itself (``wx``, ``wh``, ``b``), as the JAX
    pytree of a unidirectional layer is ``{wx, wh, b}``. Steps past a row's
    length carry the state and emit 0. Without ``initial_state`` the final
    state is not returned (the encoder drops it, as ``apply_encoder`` does);
    with one (a streaming chunk's carried ``(h, c)``) the layer resumes from
    it and returns ``(ys, (hT, cT))``, as ``rnn_scan(..., initial_state=...)``.
    Under ``compute_dtype="bfloat16"`` ``ys`` is bf16, and with a carried
    state float32 from the bf16-product walk (that scan's numerics).
    """

    def __init__(self, input_dim: int, num_units: int, param_init: float = 0.1,
                 forget_bias: float = 1.0, generator: torch.Generator | None = None,
                 compute_dtype: str = "float32"):
        super().__init__(input_dim, num_units, param_init, generator)
        self.forget_bias = forget_bias
        self.bf16 = compute_dtype == "bfloat16"

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor, initial_state=None):
        carried_bf16 = self.bf16 and initial_state is not None
        if self.bf16 and not carried_bf16:
            # rnn_scan's Pallas branch: a float32 product (bf16 xs promoted), one rounding
            xproj = (torch.matmul(xs.float(), self.wx) + self.b).to(bf16_ops.BF16)
        else:  # float32, or the scan branch a carried state takes at bf16: not rounded
            xproj = torch.matmul(xs.float(), self.wx) + self.b
        return lstm_layer(xproj, self.wh, length_mask(xs, lengths), self.forget_bias,
                          initial_state, bf16_product=carried_bf16)


class RNNSpec(NamedTuple):
    """One recurrent layer's cell: the JAX ``RNNSpec`` fields the layers read."""

    cell: str = "lstm"  # "lstm" | "gru"
    num_units: int = 256
    num_proj: int | None = None  # LSTM recurrent projection width
    use_peephole: bool = False
    clip_activation: float | None = None  # LSTM cell-state clip
    forget_bias: float = 1.0
    compute_dtype: str = "float32"

    @property
    def on_kernels(self) -> bool:
        """The plain LSTM cell, which kernels #1-#4 compute (``pallas_eligible``)."""
        return (self.cell == "lstm" and not self.use_peephole and not self.num_proj
                and not self.clip_activation)

    @property
    def out_dim(self) -> int:
        return self.num_proj or self.num_units


def _uniform(shape, scale: float, generator: torch.Generator | None) -> nn.Parameter:
    return nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale)


class CellParams(nn.Module):
    """One direction's weights of a scan-path cell in the JAX layout
    (``init_rnn_params``): LSTM ``wx`` [D, 4H], ``wh`` [P or H, 4H], ``b``
    [4H], with ``peephole`` [3, H] (rows i, f, o) and ``wproj`` [H, P] when
    set; GRU ``wx`` [D, 3H], ``wh_zr`` [H, 2H], ``wh_n`` [H, H], ``b`` [3H]."""

    def __init__(self, spec: RNNSpec, input_dim: int, param_init: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if spec.cell not in ("lstm", "gru"):
            raise ValueError(f"unknown cell {spec.cell!r}")
        self.spec = spec
        h, r = spec.num_units, spec.out_dim
        if spec.cell == "gru":
            self.wx = _uniform((input_dim, 3 * h), param_init, generator)
            self.wh_zr = _uniform((r, 2 * h), param_init, generator)
            self.wh_n = _uniform((r, h), param_init, generator)
            self.b = nn.Parameter(torch.zeros(3 * h))
            return
        self.wx = _uniform((input_dim, 4 * h), param_init, generator)
        self.wh = _uniform((r, 4 * h), param_init, generator)
        self.b = nn.Parameter(torch.zeros(4 * h))
        if spec.use_peephole:
            self.peephole = _uniform((3, h), param_init, generator)
        if spec.num_proj:
            self.wproj = _uniform((h, spec.num_proj), param_init, generator)


def lstm_cell_step(p: CellParams, carry, xproj_t: torch.Tensor, mask_t: torch.Tensor):
    """``_lstm_step``: one LSTM step with the peephole, cell clip and projection
    that ``p.spec`` sets; ``carry`` ``(h [B, P or H], c [B, H])``, ``mask_t``
    [B, 1] bool. Masked rows carry the state and emit 0. Returns ``((h, c), y)``."""
    spec = p.spec
    h_prev, c_prev = carry
    if spec.compute_dtype == "bfloat16":  # bf16 operands, float32 sums
        gates = xproj_t + bf16_ops.matmul(h_prev, p.wh)
    else:
        gates = xproj_t + torch.matmul(h_prev, p.wh)
    i, f, g, o = gates.chunk(4, dim=-1)
    if spec.use_peephole:
        pi, pf, po = p.peephole.unbind(0)
        i = i + pi * c_prev
        f = f + pf * c_prev
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + spec.forget_bias)
    c = f * c_prev + i * torch.tanh(g)
    if spec.clip_activation:
        c = c.clamp(-spec.clip_activation, spec.clip_activation)
    if spec.use_peephole:
        o = o + po * c  # the clipped new cell state
    h = torch.sigmoid(o) * torch.tanh(c)
    if spec.num_proj:
        h = torch.matmul(h, p.wproj)
    h = torch.where(mask_t, h, h_prev)
    c = torch.where(mask_t, c, c_prev)
    return (h, c), torch.where(mask_t, h, 0.0)


def gru_cell_step(p: CellParams, carry, xproj_t: torch.Tensor, mask_t: torch.Tensor):
    """``_gru_step``: z before r in ``zr``, r applied to ``h_prev`` before its
    product with ``wh_n``, no h-side bias, ``h = (1 - z) n + z h_prev``; not
    ``torch.nn.GRU``'s cell. ``carry`` ``(h,)``; masked rows as in
    ``lstm_cell_step``. Casts nothing at any ``compute_dtype``."""
    (h_prev,) = carry
    units = p.spec.num_units
    x_zr, x_n = xproj_t[..., : 2 * units], xproj_t[..., 2 * units:]
    z, r = torch.sigmoid(x_zr + torch.matmul(h_prev, p.wh_zr)).chunk(2, dim=-1)
    n = torch.tanh(x_n + torch.matmul(r * h_prev, p.wh_n))
    h = (1.0 - z) * n + z * h_prev
    h = torch.where(mask_t, h, h_prev)
    return (h,), torch.where(mask_t, h, 0.0)


def zero_state(spec: RNNSpec, batch: int, device) -> tuple:
    """The scan's initial carry: LSTM ``(h [B, P or H], c [B, H])``, GRU ``(h,)``."""
    h = torch.zeros((batch, spec.out_dim), device=device)
    if spec.cell == "gru":
        return (h,)
    return h, torch.zeros((batch, spec.num_units), device=device)


def rnn_scan(p: CellParams, xs: torch.Tensor, lengths: torch.Tensor, reverse: bool = False,
             initial_state=None):
    """The scan branch of ``rnn_scan``: ``(ys [B, T, P or H], final state)``.

    ``xproj = xs @ wx + b`` in float32 for all steps, reversed over each
    row's valid prefix when ``reverse`` (and ``ys`` reversed back), then one
    cell step per time step from ``initial_state`` (zeros when None). Steps
    past a row's length carry its state, so the final state is the state at
    the row's length.
    """
    xproj = torch.matmul(xs.float(), p.wx) + p.b
    mask = length_mask(xs, lengths).bool()[..., None]  # [B, T, 1]
    if reverse:
        xproj = flip_valid(xproj, lengths)
    step = gru_cell_step if p.spec.cell == "gru" else lstm_cell_step
    carry = (zero_state(p.spec, xs.shape[0], xs.device) if initial_state is None
             else tuple(initial_state))
    ys = []
    for t in range(xs.shape[1]):
        carry, y = step(p, carry, xproj[:, t], mask[:, t])
        ys.append(y)
    ys = torch.stack(ys, dim=1)
    if reverse:
        ys = flip_valid(ys, lengths)
    return ys, carry


class ScanRNN(CellParams):
    """One unidirectional scan-path layer: [B, T, D] -> [B, T, P or H] float32.

    Its weights sit on the layer itself, as the JAX pytree of a
    unidirectional layer. Without ``initial_state`` the final state is not
    returned; with one (a streaming chunk's carry: LSTM ``(h, c)``, GRU
    ``(h,)``) the layer resumes from it and returns ``(ys, state)``.
    """

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor, initial_state=None):
        ys, state = rnn_scan(self, xs, lengths, initial_state=initial_state)
        return ys if initial_state is None else (ys, state)


class ScanBiRNN(nn.Module):
    """One bidirectional scan-path layer: [B, T, D] -> [B, T, 2 (P or H)]
    float32, two independent scans (``bidirectional_scan``'s scan branch)."""

    def __init__(self, spec: RNNSpec, input_dim: int, param_init: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fwd = CellParams(spec, input_dim, param_init, generator)
        self.bwd = CellParams(spec, input_dim, param_init, generator)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        fwd, _ = rnn_scan(self.fwd, xs, lengths)
        bwd, _ = rnn_scan(self.bwd, xs, lengths, reverse=True)
        return torch.cat([fwd, bwd], dim=-1)


def lstm_step(wh: torch.Tensor, carry, xproj_t: torch.Tensor):
    """One plain LSTM step: ``(h, c)`` from ``carry = (h, c)`` and ``xproj_t = x @ Wx + b``.

    Gates i, f, g, o of ``xproj_t + h @ Wh`` with the forget bias 1.0 added
    to f, as ``_lstm_step`` with every row unmasked (the decoder's case).
    """
    h_prev, c_prev = carry
    i, f, g, o = (xproj_t + torch.matmul(h_prev, wh)).chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_scan(params: LSTMParams, xs: torch.Tensor, initial_state=None):
    """The scan branch of ``rnn_scan`` with every step valid: ``(ys [B, U, H], (h, c))``.

    ``xs`` [B, U, D]; the projection ``xs @ wx + b`` is hoisted, then
    ``lstm_step`` runs U times from ``initial_state`` ``(h, c)`` (zeros when
    None). The prediction net's recurrence, plain because the JAX package
    runs it in XLA.
    """
    xproj = torch.matmul(xs, params.wx) + params.b
    if initial_state is None:
        zeros = xs.new_zeros((xs.shape[0], params.wh.shape[0]))
        initial_state = (zeros, zeros)
    carry, ys = initial_state, []
    for s in range(xs.shape[1]):
        carry = lstm_step(params.wh, carry, xproj[:, s])
        ys.append(carry[0])
    return torch.stack(ys, dim=1), carry


def dropout(x: torch.Tensor, keep_prob: float, train: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout, the reference's ``DropoutWrapper(output_keep_prob)``.

    Keeps each element with probability ``keep_prob`` (a uniform draw from
    ``generator``, which lives on ``x``'s device, below ``keep_prob``) and
    scales kept ones by ``1 / keep_prob``. Identity unless training.
    """
    if not train or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)
