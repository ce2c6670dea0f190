"""Attention seq2seq (+ joint CTC-attention) models: encoder, decoder step, greedy decode.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/
seq2seq.py`` for inference: ``Seq2SeqModel``'s module tree mirrors
``init_seq2seq``'s parameter tree (``encoder``, ``embedding`` [vocab, E],
``decoder_cell`` {``wx``, ``wh``, ``b``}, ``attention``, ``out_proj``
{``w``, ``b``} and, for joint models, ``ctc_head``), so weights cross with
``utils/bridge.py``. ``encode`` runs the encoder (and the joint CTC head),
``_decoder_step`` one LSTM-decoder step with its attention read after the
cell, and ``greedy_decode`` the argmax-feedback loop with EOS masking.

The JAX ``while_loop`` becomes a Python loop that runs
``decode_unroll_factor(max_len)`` steps and then reads "all finished" from
the device once, so a decode syncs with the host once every k steps; steps
past the all-finished point are gated by ``live`` exactly as the JAX body
gates them, so the outputs are those of the JAX loop. ``forward_train`` is
the teacher-forced unroll of training and of the dev NLL: a Python loop over
the label axis with scheduled sampling (a per-row Bernoulli(``ss_prob``)
draw at each step picks the model's previous argmax over the gold token)
and dropout on the embedding and on ``[h; context]``, all drawn from one
``torch.Generator``. Its attention read is the unfused arithmetic
(``fused=False``), as the JAX scan's is. Autograd keeps each step's
activations; the JAX scan recomputes them in its backward
(``jax.checkpoint``). ``Seq2SeqModel.forward`` runs the encoder, the
teacher-forced unroll and, optionally, the greedy decode in one call, so a
step can run them on a dict of weights (``functional_call``).

At ``compute_dtype: bfloat16`` the encoder emits bf16 rows, which the
attention reads widen (``models/attention.py``) or kernel #7 reads as they
are; the decoder, its carry, the logits and the alignments stay float32,
as the reference's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .attention import Attention, AttentionConfig
from .ctc import Affine
from .encoders import Encoder, EncoderConfig
from .rnn import LSTMParams, dropout, lstm_step



class Seq2SeqConfig(NamedTuple):
    encoder: EncoderConfig = EncoderConfig(encoder_type="pyramidal_blstm", num_layers=3)
    attention: AttentionConfig = AttentionConfig()
    num_classes: int = 61  # real units; sos = num_classes, eos = num_classes + 1
    decoder_num_units: int = 256
    embedding_dim: int = 128
    logits_temperature: float = 1.0
    scheduled_sampling_prob: float = 0.0
    max_decode_length: int = 100
    dropout_decoder_keep_prob: float = 1.0
    dropout_embedding_keep_prob: float = 1.0
    ctc_loss_weight: float = 0.0  # > 0: joint CTC-attention (a CTC head on the encoder)

    @property
    def sos_id(self) -> int:
        return self.num_classes

    @property
    def eos_id(self) -> int:
        return self.num_classes + 1

    @property
    def vocab(self) -> int:  # embedding / output vocabulary with sos and eos
        return self.num_classes + 2

    @property
    def is_joint(self) -> bool:
        return self.ctc_loss_weight > 0.0


class EncodeOutput(NamedTuple):
    outputs: torch.Tensor  # [B, T', He]
    lengths: torch.Tensor  # [B]
    ctc_logits: torch.Tensor | None = None  # [B, T', num_classes + 1], joint models
    ctc_logit_len: torch.Tensor | None = None
    aux_loss: torch.Tensor | None = None  # MoE load-balance loss (weighted)


class Seq2SeqOutput(NamedTuple):
    logits: torch.Tensor  # [B, U, vocab] teacher-forced; [B, max_len, vocab] decoded
    attention_weights: torch.Tensor  # [B, U or max_len, T']
    predicted_ids: torch.Tensor | None = None  # [B, max_len] int32, eos after the end
    ctc_logits: torch.Tensor | None = None
    ctc_logit_len: torch.Tensor | None = None
    enc_out: torch.Tensor | None = None
    enc_len: torch.Tensor | None = None
    steps: int = 0  # decoder steps run (the port's own count; a multiple of the unroll)
    aux_loss: torch.Tensor | None = None  # MoE load-balance loss (weighted)


class Seq2SeqModel(nn.Module):
    """Weights uniform in +-parameter_init from ``generator`` (biases zero),
    as ``init_seq2seq`` draws them; move the model with ``.to(device)``."""

    def __init__(self, cfg: Seq2SeqConfig, input_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        scale = cfg.encoder.parameter_init
        enc_dim = cfg.encoder.output_dim
        self.encoder = Encoder(cfg.encoder, input_dim, generator)
        self.embedding = nn.Parameter(
            (torch.rand((cfg.vocab, cfg.embedding_dim), generator=generator) * 2.0 - 1.0) * scale)
        self.decoder_cell = LSTMParams(cfg.embedding_dim + enc_dim, cfg.decoder_num_units, scale,
                                       generator)
        self.attention = Attention(cfg.attention, enc_dim, cfg.decoder_num_units, scale,
                                   generator)
        self.out_proj = Affine(cfg.decoder_num_units + enc_dim, cfg.vocab, scale, generator)
        if cfg.is_joint:
            self.ctc_head = Affine(enc_dim, cfg.num_classes + 1, scale, generator)

    def forward(self, feats, feat_len, labels_in, train: bool = False,
                generator: torch.Generator | None = None, ss_prob: float = 0.0,
                decode=False):
        """``(forward_train's output, the decode's output or None)`` from one
        encoder pass: the teacher-forced unroll over ``labels_in`` and, with
        ``decode``, the greedy decode (the eval step's pair), or, when
        ``decode`` is a callable, ``decode(self, feats, feat_len, enc)`` (the
        beam eval step's)."""
        enc = encode(self, feats, feat_len, train, generator)
        out = forward_train(self, feats, feat_len, labels_in, generator, ss_prob, train,
                            precomputed=enc)
        if callable(decode):
            return out, decode(self, feats, feat_len, enc)
        return out, (greedy_decode(self, feats, feat_len, precomputed=enc) if decode else None)


def encode(model: Seq2SeqModel, feats, feat_len, train: bool = False,
           generator: torch.Generator | None = None) -> EncodeOutput:
    """Encoder outputs and lengths, plus the joint CTC head's logits;
    ``train`` and ``generator`` pass to the encoder's dropout."""
    enc = model.encoder(feats, feat_len, train, generator)
    enc_out, enc_len, aux = enc.outputs, enc.lengths, enc.aux_loss
    if model.cfg.is_joint:
        return EncodeOutput(enc_out, enc_len, model.ctc_head(enc_out), enc_len, aux)
    return EncodeOutput(enc_out, enc_len, aux_loss=aux)


def _decoder_step(model: Seq2SeqModel, enc_out, enc_keys, enc_mask, carry, token,
                  group: int = 1, train: bool = False,
                  generator: torch.Generator | None = None, fused: bool = True):
    """One decoder step: ``((h, c, context, align), logits)``. The decode
    loops take the fused attention read (kernel #7 on the card), as both JAX
    decode loops run it; ``forward_train`` passes ``fused=False``. ``group``
    decoder rows per row of ``enc_out`` (``Attention.attend``). With
    ``train`` and a ``generator``, dropout on the embedding, then, with a
    draw of its own, on ``[h; context]``."""
    cfg = model.cfg
    h, c, context, align = carry
    drop = train and generator is not None
    emb = model.embedding[token]
    if drop:
        emb = dropout(emb, cfg.dropout_embedding_keep_prob, train, generator)
    x = torch.cat([emb, context], dim=-1)
    cell = model.decoder_cell
    h, c = lstm_step(cell.wh, (h, c), torch.matmul(x, cell.wx) + cell.b)
    context, align = model.attention.attend(enc_out, enc_keys, enc_mask, h, align, fused=fused,
                                            group=group)
    hc = torch.cat([h, context], dim=-1)
    if drop:
        hc = dropout(hc, cfg.dropout_decoder_keep_prob, train, generator)
    logits = model.out_proj(hc)
    if cfg.logits_temperature != 1.0:
        logits = logits / cfg.logits_temperature
    return (h, c, context, align), logits


def _init_decoder_carry(cfg: Seq2SeqConfig, rows: int, enc_out):
    """Zero ``(h, c, context, align)`` for ``rows`` decoder rows over ``enc_out``'s
    frames: float32 whatever ``enc_out``'s dtype, as the reference's carry is."""
    t, he = enc_out.shape[1:]
    zeros = lambda *s: enc_out.new_zeros(s, dtype=torch.float32)  # noqa: E731
    return zeros(rows, cfg.decoder_num_units), zeros(rows, cfg.decoder_num_units), \
        zeros(rows, he), zeros(rows, t)


def forward_train(model: Seq2SeqModel, feats, feat_len, labels_in,
                  generator: torch.Generator | None = None, ss_prob: float | None = None,
                  train: bool = True, precomputed: EncodeOutput | None = None
                  ) -> Seq2SeqOutput:
    """Teacher-forced unroll over ``labels_in`` [B, U] ([sos, l1, ...]) with
    scheduled sampling: ``Seq2SeqOutput`` with logits [B, U, vocab] and
    alignments [B, U, T'].

    At each step every row takes the model's token (the argmax of the last
    step's logits; sos at step 0) with probability ``ss_prob`` (default: the
    config's), drawn from ``generator`` on the inputs' device, else its gold
    token; ``ss_prob`` 0 draws nothing. ``train=False`` turns dropout off
    (the dev NLL); without a ``generator`` no dropout is drawn either.
    ``precomputed`` is ``encode``'s result, to share one encoder pass.
    """
    cfg = model.cfg
    enc = (precomputed if precomputed is not None
           else encode(model, feats, feat_len, train, generator))
    enc_out = enc.outputs
    enc_keys = model.attention.precompute_keys(enc_out)
    enc_mask = enc_mask_of(enc_out, enc.lengths)
    b = enc_out.shape[0]
    ss = cfg.scheduled_sampling_prob if ss_prob is None else ss_prob
    carry = _init_decoder_carry(cfg, b, enc_out)
    pred = torch.full((b,), cfg.sos_id, dtype=labels_in.dtype, device=enc_out.device)
    logits_steps, align_steps = [], []
    for step in range(labels_in.shape[1]):
        token = labels_in[:, step]
        if ss > 0.0:
            use_model = torch.rand((b,), generator=generator, device=enc_out.device) < ss
            token = torch.where(use_model, pred, token)
        carry, logits = _decoder_step(model, enc_out, enc_keys, enc_mask, carry, token,
                                      train=train, generator=generator, fused=False)
        pred = logits.argmax(dim=-1).to(labels_in.dtype)
        logits_steps.append(logits)
        align_steps.append(carry[3])
    return Seq2SeqOutput(
        torch.stack(logits_steps, dim=1), torch.stack(align_steps, dim=1),
        ctc_logits=enc.ctc_logits, ctc_logit_len=enc.ctc_logit_len,
        enc_out=enc_out, enc_len=enc.lengths, aux_loss=enc.aux_loss,
    )


def decode_unroll_factor(max_len: int) -> int:
    """Steps between two "all finished" checks: the largest k in 8..2 dividing
    ``max_len`` (else 1), so the loop never runs past ``max_len``."""
    for k in (8, 7, 6, 5, 4, 3, 2):
        if max_len % k == 0:
            return k
    return 1


def enc_mask_of(enc_out, enc_len):
    """[B, T] bool: frame t of row b is valid."""
    return torch.arange(enc_out.shape[1], device=enc_out.device)[None, :] < enc_len[:, None]


def greedy_decode(model: Seq2SeqModel, feats, feat_len,
                  precomputed: EncodeOutput | None = None) -> Seq2SeqOutput:
    """Argmax feedback decoding to ``max_decode_length`` with EOS masking.

    ``precomputed`` is ``encode``'s result, to share one encoder pass. Rows
    of the output buffers past the exit step keep their fill (ids: eos;
    logits and alignments: zeros), as in the JAX loop.
    """
    cfg = model.cfg
    enc = precomputed if precomputed is not None else encode(model, feats, feat_len)
    enc_out = enc.outputs
    enc_keys = model.attention.precompute_keys(enc_out)
    enc_mask = enc_mask_of(enc_out, enc.lengths)
    b, t = enc_out.shape[:2]
    max_len = cfg.max_decode_length
    k = decode_unroll_factor(max_len)
    dev = enc_out.device
    carry = _init_decoder_carry(cfg, b, enc_out)
    token = torch.full((b,), cfg.sos_id, dtype=torch.int32, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    # float32, as the step's logits and alignments are at either compute_dtype
    logits_buf = torch.zeros((max_len, b, cfg.vocab), device=dev)
    preds_buf = torch.full((max_len, b), cfg.eos_id, dtype=torch.int32, device=dev)
    aligns_buf = torch.zeros((max_len, b, t), device=dev)
    si = 0
    # the JAX loop's condition, read from the device once every k steps; at
    # si = 0 nothing has finished yet
    while si < max_len and (si == 0 or not bool(finished.all())):
        for _ in range(k):
            live = ~finished.all()  # whether this step would run with k = 1
            carry, logits = _decoder_step(model, enc_out, enc_keys, enc_mask, carry, token)
            pred = torch.where(finished, cfg.eos_id, logits.argmax(dim=-1).to(torch.int32))
            finished = finished | (pred == cfg.eos_id)
            logits_buf[si] = torch.where(live, logits, 0.0)
            preds_buf[si] = pred
            aligns_buf[si] = torch.where(live, carry[3], 0.0)
            token = pred
            si += 1
    return Seq2SeqOutput(
        logits_buf.transpose(0, 1), aligns_buf.transpose(0, 1), preds_buf.transpose(0, 1),
        ctc_logits=enc.ctc_logits, ctc_logit_len=enc.ctc_logit_len,
        enc_out=enc_out, enc_len=enc.lengths, steps=si,
    )
