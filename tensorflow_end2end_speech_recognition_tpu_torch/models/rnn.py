"""LSTM layers: hoisted input projection + fused recurrence, and the plain step.

Counterpart of the Pallas branches of ``bidirectional_scan`` and
``rnn_scan`` in ``tensorflow_end2end_speech_recognition_tpu/models/rnn.py``:
the input projection ``x @ Wx + b`` for all timesteps is one
``torch.matmul`` per direction, the backward direction's projection is
reversed over each row's valid prefix, and ``ops.lstm.lstm_bidi`` (``BiLSTM``)
or ``ops.lstm.lstm_layer`` (``LSTM``, one direction) runs the recurrence
(through its ``torch.autograd.Function`` when a gradient may be taken).
Only the plain LSTM cell is ported; peephole, projection, cell clip and GRU
raise. With ``compute_dtype="bfloat16"`` the layers take the reference's
bf16 recipes: ``BiLSTM`` rounds ``xs`` and ``wx`` to bf16, sums the product
in float32, adds ``b`` and rounds ``xproj`` to bf16 once
(``bidirectional_scan``); ``LSTM`` forms the product in float32 (a bf16
``xs`` is promoted) and rounds ``xproj`` (``rnn_scan``). The kernels then
run with bf16 streams and return bf16 ``ys``. A streaming chunk's ``LSTM``
(a carried ``initial_state``) takes ``rnn_scan``'s scan branch instead: a
float32 ``xproj``, not rounded, each step's ``h @ Wh`` on bf16 operands
with float32 sums (``lstm_layer(..., bf16_product=True)``), float32 ``ys``.
``lstm_step`` is one step of that cell in plain PyTorch
(``_lstm_step`` there, which the JAX package runs in XLA, not in a kernel):
the attention decoder's cell, and through ``lstm_scan`` (the scan branch of
``rnn_scan``, with a carried ``(h, c)``) the transducer's prediction net.
``dropout`` is the inverted dropout of ``models/rnn.py`` there.
"""

from __future__ import annotations

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
