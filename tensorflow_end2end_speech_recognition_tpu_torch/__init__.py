"""PyTorch + CUDA port of ``tensorflow_end2end_speech_recognition_tpu``.

The JAX package beside this one is the reference: every module here mirrors
the module of the same path there, keeps its parameter layout (``wx [D,4H]``,
``wh [H,4H]``, one ``b [4H]``, gates i,f,g,o, ``forget_bias`` added inside
the cell) and its batch-major ``[B, T, C]`` logits with blank =
``num_classes``, so weights carry across by a plain dict walk
(``utils/bridge.py``) and each module is held against its JAX counterpart.

This package imports ``torch`` and numpy, never ``jax``. Ported so far:

- CTC serving: waveform -> features -> frame stacking -> BLSTM encoder ->
  affine head -> greedy decode, behind the micro-batching HTTP server of
  ``bin/serve.py``;
- CTC training: ``bin/train.py`` -> ``train/loop.fit`` -> the train step
  (CTC loss, gradient through the BLSTM, clip, optimizer update, non-finite
  guard) and the dev eval, on the toy corpus;
- attention / joint CTC-attention serving: pyramidal BLSTM encoder ->
  LSTM decoder with location-aware attention -> greedy decoding or the
  attention beam search, behind the same server (``--beam-width``);
- attention / joint CTC-attention training: the teacher-forced decoder
  unroll with scheduled sampling and dropout, label smoothing, the joint
  CTC term with its λ anneal, guided attention, and the dev eval;
- beam decoding and evaluation: the CTC prefix beam, the attention beam
  eval with joint CTC rescoring, RNN-LM shallow fusion in both beams, and
  ``bin/eval``, ``bin/decode`` and ``bin/train_lm``;
- the conformer and transformer encoders (absolute, relative or rotary
  positions, the chunk-causal window, the MoE feed-forward and its
  load-balance loss) for the CTC, transducer and attention models, and
  SpecAugment in training;
- the VGG-BLSTM and multitask (B)LSTM encoders, the multitask CTC model's
  sub head and mixed loss, and the phone (61/48/39), capital-divided
  character, word, BPE and kana units with the hard toy corpus: every
  config in ``configs/`` runs;
- on-disk corpora: ``bin/prepare`` (wavs to per-utterance ``.npy``
  features), ``data_root`` configs trained and scored from them, MFCC,
  per-speaker CMVN, and gradient accumulation (``grad_accum_steps``);
- export (``bin/export``, ``bin/serve ARTIFACT``), streaming (``bin/serve
  --stream``), and the bf16 mode (``compute_dtype: bfloat16``);
- the rest of the encoder zoo: (B)GRU, the LSTM's peephole, projection and
  cell clip (the reference's scan path, plain PyTorch), ``cnn_zhang``, and
  GRU streaming;
- the tools: ``fit(profile_steps=)`` / ``bin/train --profile``
  (``torch.profiler``), ``utils/plot.py`` and ``bin/plot``, and the C++
  host runtime (``data/native.py``: batch assembly, edit distance).

Hand-written Hopper kernels (``csrc/``): the BLSTM layer forward
(``lstm_bidi_fwd.cu``) and backward (``lstm_bidi_bwd.cu``), the one-direction
LSTM layer forward and backward (``lstm_layer_{fwd,bwd}.cu``), the fused CTC
loss + gradient and the loss-only CTC (``ctc_loss.cu``), and the
location-aware attention read (``location_attend.cu``); ``csrc/asr_native.cpp``
is the host runtime, built with the host compiler.

Layout:

- ``frontend``  log-mel and MFCC features, deltas, CMVN (``torch.matmul``
                DFT/mel/DCT), per-speaker CMVN statistics, SpecAugment
- ``data``      frame stacking, tokenizers, toy and hard corpora, ``.npy``
                corpora, batching, prefetch, the C++ host runtime
- ``ops``       kernel wrappers (``lstm``, ``ctc``, ``attention``), losses, the
                nvcc builder
- ``csrc``      CUDA C++ sources of the kernels and the host runtime's C++
                (built at first use)
- ``models``    (B)LSTM layers, the scan-path GRU and option-LSTM layers,
                decoder LSTM step, dropout, the encoder zoo (pyramidal, VGG,
                multitask, ``cnn_zhang``, conformer and transformer), CTC
                model, attention scorers, seq2seq model, transducer, RNN-LM
- ``decoding``  CTC greedy collapse, CTC prefix beam, attention beam search,
                joint CTC rescoring
- ``train``     CTC, attention, transducer and LM tasks (pipeline, loss,
                train/eval steps), gradient accumulation, optimizers, LR
                controller, checkpoints, the loop
- ``utils``     JAX-pytree <-> ``state_dict`` bridge, experiment config,
                edit distance and error rates, TensorBoard event writer, plots
- ``serving``   inference function (CTC greedy or prefix beam; attention
                greedy or beam; transducer greedy) and micro-batcher
- ``bin``       HTTP server, corpus preparation, training, eval, decode,
                export, plot and LM-training CLIs
"""

import torch

__version__ = "0.1.0"


def set_full_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32 on the card.

    PyTorch lets cuDNN use TF32 (about three decimal digits) by default; the
    port is held against the float32 JAX reference, so every entry point
    that runs the port calls this first.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
