"""Streaming (online) recognition: chunked audio in, incremental tokens out.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/streaming.py``.
Audio arrives in fixed chunks of C samples (a multiple of the hop); each
step advances every row of a batch by one chunk and emits the tokens its
frames decode, with fixed shapes, so a server runs one step program for a
stream's lifetime:

- **Framing carry.** Frames (25 ms window, 10 ms hop) straddle chunks, so
  the state keeps the last K samples (``carry_samples``: 320 at 16 kHz,
  hop-aligned) and each step frames ``cat(carry, chunk)`` with the offline
  frontend (``frontend/features.extract_features``). Preemphasis reads the
  sample before the buffer (``preemph_ctx``), so boundary frames equal the
  offline ones. The initial zero carry makes K / hop frames once; each row
  shifts them out.
- **Stacking carry** (``num_stack`` / ``num_skip`` > 1): the base frames
  not yet in a stacked window ride ``frame_carry``, right-aligned, so the
  encoder sees the offline ``stack_frames`` windows. A stacked stream that
  ends on a chunk boundary flushes with ``chunk_len = -1``; a partial final
  chunk flushes itself.
- **Encoder carry.** Each causal plain-LSTM layer resumes from its carried
  ``(h, c)`` through ``models/rnn.LSTM(..., initial_state=)``, which runs
  kernel #3 on the card (the ``lstm_layer_fwd_carry`` entry, or at
  ``compute_dtype: bfloat16`` ``lstm_layer_fwd_carry_bf16``: the
  reference's scan step with bf16 products and float32 streams) once per
  layer and chunk. A GRU layer carries ``(h,)`` and an LSTM with a
  peephole, projection or cell clip ``(h [B, P or H], c [B, H])``; both
  resume through the scan path (``models/rnn.ScanRNN``). A chunk-causal
  conformer / transformer keeps its KV and conv caches
  (``models/conformer_stream.py``).
- **Decode carry.** Greedy CTC carries the last frame's argmax; the
  transducer carries ``(g, prediction-net state)`` through the greedy
  ``decode_frame``; in beam mode the CTC prefix beam or the transducer beam
  rides the state too (``beam_advance`` per chunk; ``finalize_fn`` gives
  the transcript at stream end, equal to the offline beam's), with RNN-LM
  shallow fusion when an LM is given.

Rows are independent. A row gets a full chunk (``chunk_len == C``), its
final samples (``0 < chunk_len < C``; the row then emits nothing more),
the explicit flush (``chunk_len == -1``), or ``chunk_len == 0``: paused,
its whole state kept bit for bit (every update is a select, never a
blend), so a server multiplexes sessions over the batch rows and steps
whenever any has a chunk. A new stream takes a row with ``reset_rows``.
The state is a ``StreamState`` of tensors on the model's device, each with
a leading batch dim. Attention decoders cannot stream (not causal), and
``pos_encoding: relative`` is refused.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .decoding.ctc_greedy import compact_rows
from .decoding.ctc_prefix_beam import tree_map
from .frontend.features import extract_features
from .models.rnn import zero_state
from .train.ctc_task import CTCTaskConfig
from .train.transducer_task import TransducerTaskConfig


class StreamState(NamedTuple):
    sample_carry: torch.Tensor  # [B, K] the last samples (hop-aligned)
    samples_seen: torch.Tensor  # [B] valid samples fed so far
    frame_base: torch.Tensor  # [B] global frame index of buffer frame 0
    rnn_states: tuple  # per recurrent layer: LSTM (h, c), GRU (h,)
    prev_id: torch.Tensor  # [B] the previous frame's argmax (-1 before any frame)
    beam: Any = None  # the carried CTC prefix beam (BeamState) or transducer beam (dict)
    frame_carry: torch.Tensor | None = None  # [B, num_stack-1, D] right-aligned
    carry_len: torch.Tensor | None = None  # [B] valid frames in frame_carry
    transducer: tuple | None = None  # (g [B, J], prediction-net (h, c) per layer)
    conformer: tuple | None = None  # (enc_seen [B], per-layer (k, v[, conv]) caches)
    preemph_ctx: torch.Tensor | None = None  # [B, 1] the sample before the buffer


def _validate(task) -> None:
    """Raise for what cannot stream, as the JAX ``_validate``."""
    if not isinstance(task, (CTCTaskConfig, TransducerTaskConfig)):
        raise ValueError("streaming supports CTC and transducer tasks "
                         "(attention decoders are not causal)")
    fe = task.frontend
    if fe is None:
        raise ValueError("streaming needs the waveform frontend (precomputed-"
                         "feature corpora are offline by definition)")
    if fe.add_deltas:
        raise ValueError("streaming frontend must be causal: set add_deltas "
                         "false (deltas need future frames)")
    if fe.cmvn != "none":
        raise ValueError("per-utterance/per-speaker CMVN is not causal (or "
                         "needs out-of-band stats); use cmvn: none for "
                         "streaming models")
    if task.splice != 0:
        raise ValueError("streaming supports splice=0 only (context splicing is "
                         "non-causal: it needs future frames on the right edge)")
    if task.num_skip > task.num_stack:
        raise ValueError("streaming frame stacking needs num_skip <= num_stack (gapped "
                         "subsampling would need negative frame carry)")
    enc = task.model.encoder
    if enc.encoder_type in ("conformer", "transformer"):
        if enc.left_context < 0:
            raise ValueError("streaming a conformer/transformer needs left_context >= 0 "
                             "(chunk-causal attention + causal conv); bidirectional "
                             "stacks have an unbounded window")
        if enc.pos_encoding == "relative":
            raise ValueError("streaming supports pos_encoding absolute/rotary (the "
                             "relative scheme's rel-shift needs square score matrices)")
    elif enc.encoder_type not in ("lstm", "gru"):
        raise ValueError(f"streaming needs a causal encoder (lstm/gru, or conformer/"
                         f"transformer with left_context >= 0), got {enc.encoder_type!r}")
    if isinstance(task, CTCTaskConfig) and task.model.num_classes_sub is not None:
        raise ValueError("streaming decodes the main task only")


def reset_rows(state: StreamState, fresh: StreamState, rows_mask) -> StreamState:
    """The rows of ``rows_mask`` [B] (bool) taken from ``fresh`` (an
    ``init_fn`` state of the same batch), the others kept: slot reuse."""
    m = torch.as_tensor(rows_mask, dtype=torch.bool)

    def sel(f, o):
        return torch.where(m.to(o.device).reshape((-1,) + (1,) * (o.dim() - 1)), f, o)

    return tree_map(sel, fresh, state)


def carry_samples(frontend) -> int:
    """K: the samples carried between chunks (the window overlap, hop-aligned)."""
    length, step = frontend.frame_length, frontend.frame_step
    if length <= step:
        return 0
    return step * (-(-(length - step) // step))


def _floordiv(a: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(a, d, rounding_mode="floor")


def build_streaming_fn(task, model, chunk_samples: int, beam_width: int = 1,
                       top_k_classes: int = 16, max_prefix_len: int = 200, lm=None,
                       lm_weight: float = 0.0):
    """``(init_fn, step_fn)``, and ``finalize_fn`` third with ``beam_width > 1``.

    ``task`` is a ``CTCTaskConfig`` or ``TransducerTaskConfig`` and ``model``
    its ``CTCModel`` / ``TransducerModel``; the step runs on the model's
    device, without a gradient.

    - ``init_fn(batch_size)`` -> a zeroed ``StreamState``.
    - ``step_fn(state, chunk [B, C], chunk_len [B])`` -> ``(state, tokens
      [B, F] int32 -1-padded, tok_len [B] int32)``: the greedy tokens of the
      chunk's frames (CTC: F = C / hop or the stacked windows; the
      transducer: F times ``max_symbols_per_frame``). Token rows
      concatenated over chunks equal the offline greedy decode.
    - ``finalize_fn(state)`` -> ``(prefixes [B, W, L], lengths [B, W],
      scores [B, W])`` best first: the carried beam (CTC prefix beam or
      transducer beam), equal to the offline beam search of the whole
      stream. The per-chunk tokens stay the live greedy partials.

    ``lm`` (an ``RNNLM`` on the model's device) with a non-zero
    ``lm_weight`` is fused into the beam (greedy ignores it).
    """
    _validate(task)
    is_transducer = isinstance(task, TransducerTaskConfig)
    fe, cfg = task.frontend, task.model
    device = next(model.parameters()).device
    model.eval()
    fusion_lm = None
    if lm is not None and lm_weight and beam_width > 1:
        from .models.lm import make_fusion_lm

        fusion_lm = make_fusion_lm(lm, cfg.vocab_with_blank)  # blank last in both layouts
    is_conformer = cfg.encoder.encoder_type in ("conformer", "transformer")
    step_sz, length = fe.frame_step, fe.frame_length
    if chunk_samples % step_sz != 0:
        raise ValueError(f"chunk_samples ({chunk_samples}) must be a multiple of the hop "
                         f"({step_sz})")
    if chunk_samples + carry_samples(fe) < length:
        raise ValueError("chunk too short: carry + chunk must cover one window")
    k = carry_samples(fe)
    # K is sized so the buffer yields exactly C / hop frames per chunk
    assert (k + chunk_samples - length) // step_sz + 1 == chunk_samples // step_sz
    n_stack, n_skip = task.num_stack, task.num_skip
    stacked = n_stack > 1 or n_skip > 1
    feat_dim = fe.feature_dim

    @torch.no_grad()
    def init_fn(batch_size: int) -> StreamState:
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        conformer = rnn_states = None
        if is_conformer:
            from .models.conformer_stream import conformer_cache_init

            conformer = conformer_cache_init(cfg.encoder.conformer_spec(), batch_size, device)
            rnn_states = ()
        else:
            spec = cfg.encoder.spec()
            rnn_states = tuple(zero_state(spec, batch_size, device)
                               for _ in range(cfg.encoder.num_layers))
        beam = transducer = None
        if is_transducer:
            from .decoding.transducer_greedy import decoder_init

            g, states = decoder_init(model, batch_size, device)
            transducer = (g, tuple(states))
            if beam_width > 1:
                from .decoding.transducer_beam import beam_init

                beam = beam_init(model, batch_size, beam_width, max_prefix_len, fusion_lm,
                                 device)
        elif beam_width > 1:
            from .decoding.ctc_prefix_beam import beam_init

            beam = beam_init(batch_size, beam_width, max_prefix_len, fusion_lm, lm_weight,
                             device)
        return StreamState(
            sample_carry=zeros(batch_size, k),
            samples_seen=zeros(batch_size, dtype=torch.int64),
            # buffer frame 0 sits K samples before the stream start
            frame_base=torch.full((batch_size,), -(k // step_sz), dtype=torch.int64,
                                  device=device),
            rnn_states=rnn_states,
            prev_id=torch.full((batch_size,), -1, dtype=torch.int32, device=device),
            beam=beam,
            frame_carry=zeros(batch_size, n_stack - 1, feat_dim) if stacked else None,
            carry_len=zeros(batch_size, dtype=torch.int64) if stacked else None,
            transducer=transducer,
            conformer=conformer,
            preemph_ctx=zeros(batch_size, 1),
        )

    def stack_windows(state, feats, n_new, active, explicit_final, is_final):
        """The stacked windows of ``cat(frame_carry, new frames)`` (bit for bit
        the offline ``stack_frames`` windows, zero-padded past the stream
        end), how many to encode, and the re-packed remainder."""
        s, sk = n_stack, n_skip
        dev = feats.device
        v = state.carry_len + n_new  # valid base frames buffered
        buf_f = torch.cat([state.frame_carry, feats], dim=1)
        bf = buf_f.shape[1]  # s - 1 + Fb
        # the carry is right-aligned; shift left so the valid frames are [0, v)
        fidx = (torch.arange(bf, device=dev)[None, :]
                + ((s - 1) - state.carry_len)[:, None]).clamp_max(bf - 1)
        aligned = buf_f.gather(1, fidx[..., None].expand(-1, -1, feat_dim))
        aligned = aligned * (torch.arange(bf, device=dev)[None, :, None] < v[:, None, None])
        f_s = bf // sk + 1  # the static stacked-window capacity
        need = (f_s - 1) * sk + s
        if need > bf:
            aligned = torch.nn.functional.pad(aligned, (0, 0, 0, need - bf))
        widx = (torch.arange(f_s, device=dev)[:, None] * sk
                + torch.arange(s, device=dev)[None, :])
        xs_in = aligned[:, widx, :].reshape(aligned.shape[0], f_s, s * feat_dim)
        # complete windows mid-stream; ceil(v / skip) zero-padded at the end
        s_complete = (_floordiv(v - s, sk) + 1).clamp_min(0)
        s_flush = -_floordiv(-v, sk)
        n_enc = torch.where(is_final, s_flush, s_complete)
        consumed = n_enc * sk
        carry_len = torch.where(is_final, 0, (v - consumed).clamp(0, s - 1))
        # re-pack the remainder right-aligned for the next step
        pos = torch.arange(s - 1, device=dev)[None, :]
        src = (consumed[:, None] + pos - ((s - 1) - carry_len)[:, None]).clamp(
            0, aligned.shape[1] - 1)
        carry_f = aligned.gather(1, src[..., None].expand(-1, -1, feat_dim))
        carry_f = carry_f * (pos >= (s - 1 - carry_len)[:, None])[..., None]
        touched = active | explicit_final
        carry_f = torch.where(touched[:, None, None], carry_f, state.frame_carry)
        carry_len = torch.where(touched, carry_len, state.carry_len)
        return xs_in, n_enc, carry_f, carry_len

    @torch.no_grad()
    def step_fn(state: StreamState, chunk, chunk_len):
        chunk = torch.as_tensor(chunk, dtype=torch.float32).to(device)
        chunk_len = torch.as_tensor(chunk_len, dtype=torch.int64).to(device)
        # chunk_len < 0: the explicit end-of-stream flush, with no new samples
        explicit_final = chunk_len < 0
        eff_len = torch.where(explicit_final, 0, chunk_len)
        buf = torch.cat([state.sample_carry, chunk], dim=1)
        # preemphasis across chunk boundaries: the carried previous sample; at
        # the stream start the offline convention (prev = first sample), with
        # the last zero-carry sample patched to it so that global sample 0
        # preemphasizes as (1 - c) w0, as in the whole signal
        fresh = state.samples_seen == 0
        ctx = torch.where(fresh[:, None], chunk[:, :1], state.preemph_ctx)
        if k > 0:
            patched = torch.where(fresh, chunk[:, 0], buf[:, k - 1])
            buf = torch.cat([buf[:, : k - 1], patched[:, None], buf[:, k:]], dim=1)
        feats, _ = extract_features(buf, k + eff_len, fe, preemph_context=ctx)  # [B, Fb, D]
        fb = feats.shape[1]

        active = eff_len > 0  # rows with chunk_len == 0 are paused: frozen
        is_final = explicit_final | (active & (eff_len < chunk_samples))
        new_total = state.samples_seen + eff_len
        total_frames = (1 + _floordiv(new_total - length, step_sz)).clamp_min(0)
        emitted = state.frame_base.clamp_min(0)
        lead = (-state.frame_base).clamp_min(0)  # the initial zero-carry frames
        # per-row shift-out of the zero-carry preamble
        idx = (torch.arange(fb, device=device)[None, :] + lead[:, None]).clamp_max(fb - 1)
        feats = feats.gather(1, idx[..., None].expand(-1, -1, feats.shape[2]))
        n_new = (total_frames - emitted).clamp(0, fb)  # new base frames per row

        carry_f, carry_len = state.frame_carry, state.carry_len
        if stacked:
            xs, n_enc, carry_f, carry_len = stack_windows(state, feats, n_new, active,
                                                          explicit_final, is_final)
        else:
            xs, n_enc = feats, n_new
        f_frames = xs.shape[1]

        rnn_states, conformer = state.rnn_states, state.conformer
        if is_conformer:
            from .models.conformer_stream import conformer_stream_step

            xs, conformer = conformer_stream_step(model.encoder.conformer, state.conformer,
                                                  xs, n_enc)
        else:
            carried = []
            for layer, carry in zip(model.encoder.layers, state.rnn_states):
                xs, carry = layer(xs, n_enc, initial_state=carry)
                carried.append(carry)
            rnn_states = tuple(carried)

        beam, transducer, prev_id = state.beam, state.transducer, state.prev_id
        if is_transducer:
            # frame-synchronous greedy continues from the carried (g, prediction
            # state): the chunks' emissions concatenate to the offline decode
            from .decoding.transducer_greedy import decode_frame

            f_proj = model.enc_proj(xs)
            ok = torch.arange(f_frames, device=device)[:, None] < n_enc[None, :]
            g, states = state.transducer
            carry, em = (g, list(states)), []
            for i in range(f_frames):
                carry, e = decode_frame(model, carry, f_proj[:, i], ok[i])
                em.append(e)
            transducer = (carry[0], tuple(carry[1]))
            em = torch.stack(em, dim=1).reshape(xs.shape[0], -1)  # [B, F * S]
            tokens, tok_len = compact_rows(em, em >= 0)
            if beam_width > 1:
                from .decoding.transducer_beam import beam_advance

                beam = beam_advance(model, state.beam, f_proj, n_enc, fusion_lm=fusion_lm,
                                    lm_weight=lm_weight)
        else:
            logits = model.project(xs)  # [B, F, C + 1]
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
            valid = torch.arange(f_frames, device=device)[None, :] < n_enc[:, None]
            prev = torch.cat([state.prev_id[:, None], ids[:, :-1]], dim=1)
            keep = valid & (ids != prev) & (ids != cfg.blank_id)
            tokens, tok_len = compact_rows(ids, keep)
            last = (n_enc - 1).clamp(0, f_frames - 1)
            prev_id = torch.where(n_enc > 0, ids.gather(1, last[:, None])[:, 0], state.prev_id)
            if beam_width > 1:
                from .decoding.ctc_prefix_beam import beam_advance

                # the shared per-frame body freezes rows past n_enc, so the
                # chunks compose to the offline beam
                beam = beam_advance(state.beam, logits, n_enc, cfg.blank_id,
                                    top_k_classes=top_k_classes, lm_weight=lm_weight,
                                    fusion_lm=fusion_lm)

        new_state = StreamState(
            # paused rows keep their carry and frame alignment bit for bit
            sample_carry=torch.where(active[:, None], buf[:, chunk_samples: chunk_samples + k],
                                     state.sample_carry),
            samples_seen=new_total,
            frame_base=torch.where(active, state.frame_base + fb, state.frame_base),
            rnn_states=rnn_states,
            prev_id=prev_id,
            beam=beam,
            frame_carry=carry_f,
            carry_len=carry_len,
            transducer=transducer,
            conformer=conformer,
            # the sample before the next buffer's first carried sample
            preemph_ctx=torch.where(active[:, None], buf[:, chunk_samples - 1: chunk_samples],
                                    state.preemph_ctx),
        )
        return new_state, tokens, tok_len

    if beam_width <= 1:
        return init_fn, step_fn
    if is_transducer:
        from .decoding.transducer_beam import beam_finalize as t_beam_finalize

        @torch.no_grad()
        def finalize_fn(state: StreamState):
            return tuple(t_beam_finalize(state.beam))
    else:
        from .decoding.ctc_prefix_beam import beam_finalize

        @torch.no_grad()
        def finalize_fn(state: StreamState):
            return beam_finalize(state.beam, lm_weight=lm_weight)

    return init_fn, step_fn, finalize_fn
