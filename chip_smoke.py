#!/usr/bin/env python3
"""Smoke run of the PyTorch port's CTC serving, CTC training, attention
serving, attention training, transducer serving and training, beam
decoding, eval / decode and RNN-LM paths, of the conformer / transformer
configs, of the VGG, multitask, BPE and word configs, of streaming
recognition and the transducer beam, of the bf16 mode (``compute_dtype:
bfloat16``) with ``bench.py``'s headline step, of training from a
prepared on-disk corpus with gradient accumulation, of exported artifacts
(``bin/export`` -> ``bin/serve ARTIFACT``) and streaming at bf16, and of
the scan-path encoders (GRU, the LSTM options), ``cnn_zhang``, profiling
and the C++ host runtime, of data parallelism and ZeRO-3 across ranks, and
of tensor, sequence, expert and pipeline parallelism, on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile-out DIR   # also write the steps' profile tables

Phases; any failure exits non-zero and prints no result line:

1. refuse to run without CUDA;
2. build the CUDA kernels from ``tensorflow_end2end_speech_recognition_tpu_torch/
   csrc`` with nvcc for sm_90a (one nvcc per source, in parallel; set-up);
3. serving kernel: ``lstm_bidi`` forward (#1: one cooperative launch; its
   launch plan, us per step, two calls bitwise equal) against its plain
   PyTorch version at the encoder's serving shape, B=8, T=400, D=360 ->
   H=512, ragged lengths that include 1 and T;
4. training kernels at the ls100_ctc train step's shapes (B=32, T=400,
   H=512; C=29, U=40), each against its plain version on the same inputs:
   the forward with its cell-state stream ``cs`` (plan, us per step,
   bitwise repeat), the backward (``lstm_bidi_bwd``: one cooperative
   launch; its launch plan, us per step, two calls bitwise equal, and
   ``LSTMBidi.backward`` whole, kernel + dWh, timed beside cuDNN's
   backward), the fused CTC loss + gradient (#5) and the loss-only CTC
   (#6), at U=40 and at U=180 (a 12 s transcript), each with two calls
   bitwise equal, its device launches per call from the profiler and its
   time per lattice step;
5. build the ``configs/ls100_ctc.yml`` model at full width in code (40 mel +
   deltas = 120 dims, 3/3 stacking -> 360, 5 x BLSTM-512, 28 + 1 character
   classes) with seeded uniform +-0.1 weights; check its logits and ids on
   the card against the CPU (plain path) on 2 x 1 s;
6. one full-width train step, dropout off, card against CPU: loss, every
   gradient, the weights after one SGD step, and the ids decoded after it;
7. time the serving phases on 8 x 12 s and serve 8 concurrent
   ``/recognize`` requests through ``bin/serve.make_server`` (the serving
   path; launch counts reset just before and read just after);
7a. the CTC prefix beam (W=20, K=16, as ``bin/eval`` runs ls100_ctc) on
    the card against the CPU beam on the same (card) logits, 2 x 1 s
    (prefixes and lengths of live slots equal, scores within 1e-3 + 1e-5 x
    |score|), its frame loop under CUDA's sync debug mode set to raise (no
    host sync);
7b. time the prefix beam on the logits of 8 x 12 s: wall, device time,
    busy share, device launches per frame, device memory above the logits;
7c. serve 8 concurrent ``/recognize`` requests through
    ``bin/serve.make_server(..., beam_width=20)`` (the CTC beam serving
    path; launch counts reset just before and read just after: 5 #1 per
    batch and nothing else);
8. time train steps at B=32 x 12 s (dropout 0.8, Adam): ms per step,
   utterances/s, peak memory, kernel launches per step (exactly 5 forward,
   5 backward, 1 CTC), and a profile of one step's device time by kernel,
   which must show exactly 5 device launches of the forward walk and 5 of
   the backward walk, and no per-step forward kernel;
9. ``train/loop.fit`` on the ls100_ctc config for one epoch of the toy corpus
   (the training path; launch counts reset just before and read just
   after): finite losses, no skipped step, the dev eval on the loss-only
   kernel, checkpoints and summary written;
10. attention kernel: ``location_attend`` (#7) against its plain version at
    the ls960_joint decoder's shapes (T=300, A=256, He=1024, C=10, W=101,
    utterance lengths that include 1, T and 0, the bias b added in the
    kernel): the beam's grouped call (N=64 rows reading 8 utterances,
    G=8), the same data in the tiled layout (keys + b formed outside, each
    utterance repeated 8 times, G=1; equal bits), and the greedy call
    (N=8, G=1), each timed from graph replays beside its bound with the
    profiler's split between the two kernels, plus a small case with an
    even W and sharpening 1.5;
11. ``lstm_bidi`` forward at the pyramidal encoder's first layer, B=8,
    T=1198, D=120 -> H=512, ragged lengths (plan, us per step, bitwise
    repeat);
12. build the ``configs/ls960_joint.yml`` model at full width in code (120
    dims, 5 x pyramidal BLSTM-512 with two 2x reductions, hybrid attention
    A=256, LSTM decoder 512, 28 characters + sos/eos, joint CTC head) with
    seeded uniform +-0.1 weights; on 2 x 1 s check the encoder outputs, CTC
    logits, greedy ids and logits and beam-8 tokens, lengths and scores on
    the card against the CPU (plain path);
12a. the beam eval step of ``bin/eval`` on ls960_joint (beam 8, joint
     rescoring at the config's λ 0.3, length penalty 0.6) on 2 x 1 s, card
     against CPU: ids and lengths equal, the teacher-forced NLL within 1e-4
     relative;
13. time the attention serving phases on 8 x 12 s (frontend, encoder,
    greedy decode, beam-8 decode, each with its steps and #7 launches) with
    a profile of each decode's device time and its device memory, check
    that no operator of the beam decode takes a tensor repeated per beam
    ([64, 300, 256] keys or [64, 300, 1024] encoder outputs), and serve 8 concurrent
    ``/recognize`` requests through ``bin/serve.make_server(...,
    beam_width=8)`` (the attention serving path; launch counts reset just
    before and read just after);
13a. kernel #6 at the joint-rescoring shape (N=64: 8 utterances x 8
     hypotheses, T=300, C=29, U up to 120, lengths 0..120, labels that
     include the blank id, rows without an alignment) against its plain
     version: two calls equal bit for bit, device launches per call, time
     from graph replays beside ``F.log_softmax`` + ``F.ctc_loss`` and the
     bound; a kernels entry of its own (``ctc_loss_fwd_only_rescoring``);
13b. time the beam eval step on one 8 x 12 s batch: wall, busy share and
     its launches (exactly 5 #1, one #7 per decoder step, one #6);
14. ``lstm_bidi`` forward with ``cs`` (#1) and its backward (#2) at the
    ls960_joint train step's first layer, B=32, T=1198, D=120 -> H=512,
    ragged lengths that include 1 and T, each against its plain version
    (plan, us per step, bitwise repeat, beside cuDNN's forward / backward);
15. kernel #7's gradient (``LocationAttend``: the kernel forward, the plain
    backward) against autograd through ``location_attend_plain`` at the
    ls960_joint decoder's shapes, N=8 (G=1) and N=64 (G=8): the gradients
    of keys, enc_out, q, prev_align, conv_w, w_loc, v and b; the plain
    backward's time per call;
16. one full-width ls960_joint train step on 2 x 1 s (dropout off, scheduled
    sampling 0, SGD), card against CPU: the loss, att_nll, ctc_nll and the
    guided term, every gradient, the weights after the step, and the greedy
    ids decoded after it;
17. time ls960_joint train steps at B=32 x 12 s (T=1198 -> T'=300, U=40,
    Adam, encoder dropout 0.8) at a global step inside the guided-attention
    and λ schedules with scheduled sampling on: ms per step, utterances/s,
    peak memory, launches per step (exactly 5 #1, 5 #2, 1 #5, no #6 or #7)
    and a profile of one step (exactly 5 device launches of each walk);
18. ``train/loop.fit`` on the ls960_joint config for one epoch of the toy
    corpus (the attention training path; launch counts reset just before
    and read just after): finite losses, no skipped step, the dev eval
    through the greedy decode on #7, checkpoints and summary written;
18a. the CLIs on the model dirs that phases 9 and 18 wrote, each with the
     launch counts reset just before and read just after: ``bin/eval`` on
     ls100_ctc (its beam 20: #1 and #6) and on ls960_joint (beam 8 with
     joint rescoring: #1, #7, #6), ``bin/decode --nbest 2`` on each (beam
     20; beam 8 with ``--joint-rescore``), ``bin/train_lm`` for one epoch
     on the ls960_joint toy corpus at the CLI's default width (256 units,
     embedding 128, one layer; no kernel), and ``bin/eval --lm-dir`` at
     beam 8 on both model dirs;
18b. shallow fusion with that LM, card against CPU on 2 x 1 s: the CTC
     prefix beam (W=20, carried LM state) on the same (card) logits, and
     the attention beam (beam 8, length penalty 0.6, then joint rescoring)
     on the same (card) encoder outputs;
19. unidirectional layer kernel: ``lstm_layer`` forward (#3, one cooperative
    launch) against its plain version at the ls_transducer encoder's serving
    shape, B=8, T=400, D=120 -> H=512, lengths that include 1 and T, and
    with ``cs`` at B=32 (each with its plan, us per step, bitwise repeat);
20. its backward (#4, ``lstm_layer_bwd``) at B=32, T=400, H=512 (launch
    plan, us per step, two calls bitwise equal, ``LSTMLayer.backward``
    whole timed), and ``LSTMLayer``'s gradients (dxproj, dWh) against
    autograd through the plain forward;
21. build the ``configs/ls_transducer.yml`` model at full width in code (40
    mel, no deltas, 3/3 stacking -> 120, 4 x LSTM-512, prediction net
    embedding 32 + LSTM-128, joint 256, 28 + 1 characters, 4 symbols per
    frame) with seeded uniform +-0.1 weights; on 2 x 1 s check ``f_proj``,
    the teacher-forced nll and the greedy ids on the card against the CPU,
    and one train step (dropout off, SGD): loss, every gradient, weights;
22. time the transducer serving phases on 8 x 12 s (frontend, encoder,
    greedy decode with its frames and prediction-net steps) with a profile
    of the decode's device time, and serve 8 concurrent ``/recognize``
    requests through ``bin/serve.make_server`` (the transducer serving path;
    launch counts reset just before and read just after: 4 #3 per batch);
23. time transducer train steps at B=32 x 12 s (U=40, dropout 0.9, Adam):
    ms per step, utterances/s, peak memory, launches per step (exactly 4
    #3 and 4 #4) and a profile of one step's device time by kernel (exactly
    4 device launches of each walk, no per-step forward kernel);
24. ``train/loop.fit`` on the ls_transducer config for one epoch of a
    256-utterance toy corpus (the transducer training path; launch counts
    reset just before and read just after): finite losses, no skipped
    step, a dev eval through the greedy decode, checkpoints written;
25. build ``configs/ls960_conformer_ctc.yml`` at full width in code (120
    dims, 3/3 stacking -> 360, 4 x conformer-144, 4 heads, kernel 15, FF
    576, 28 + 1 characters) with seeded weights; logits and ids on 2 x 1 s
    and one SGD train step card against CPU (the key bias's gradient, zero
    in exact arithmetic, held near zero on both sides);
26. its serving phases on 8 x 12 s (frontend, encoder, head + greedy, the
    prefix beam at W=20) and 8 concurrent ``/recognize`` requests (no
    kernel launched); Adam train steps at B=32 x 12 s, dropout 0.9
    (exactly one #5 and no LSTM walk; the profile's device time by kind of
    kernel); ``fit`` for one toy epoch (#5, #6) and ``bin/eval`` on the
    model dir it wrote (#6);
27. ``configs/ls960_transformer_ctc.yml`` and ``configs/ls960_moe_conformer.yml``
    card against CPU (logits, ids, the MoE term, one train step) and timed
    train steps;
28. ``configs/ls_conformer_transducer.yml`` (rotary, left context 32,
    prediction net 128, joint 256): ``f_proj``, nll and greedy ids card
    against CPU, one train step, the serving phases and 8 requests, timed
    train steps and ``fit`` on a 256-utterance toy corpus;
29. ``configs/ls_streaming_conformer.yml`` (offline) card against CPU;
30. ``fit`` on ``configs/ls960_conformer_ctc_sa.yml`` for one toy epoch,
    every train step's SpecAugment drawn on the card;
31. timed train steps of the conformer CTC model at d=512, 8 layers, 8
    heads (the scale ls960_conformer_ctc.yml names for LibriSpeech-960;
    not a config of the repo);
32. the kernels at the shapes of the configs below, each against its plain
    version: #1 with ``cs`` and #2 at B=32, T=300, D=1408 -> H=320
    (csj_joint's first layer after the VGG stack) and T=780, D=123 -> H=256
    (timit_multitask_ctc's); #5 and #6 at C=62 (T=780, U=80), C=87 (T=300,
    U=60) and C=1030 (T=100, U=40; the 1029 units bpe_1000 gives on
    LibriSpeech), held with the float32 plain version to the float64 one;
    #7 for the pure location scorer (no keys) at A=128, He=640, T=300,
    N=32 (G=4) and N=8;
33. ``configs/csj_joint.yml`` (read from the file, as 34-36) at full width
    (123 dims, VGG 64-64 / 128-128 -> 1408, 4 x BLSTM-320, location
    attention A=128, decoder 320, 86 kana + sos/eos): card against CPU on
    2 x 1 s (encoder, CTC logits, greedy, beam 4) and one train step (the
    CPU takes the card's max-pool decisions), serving phases on 8 x 12 s
    (T=1198 -> T'=300) and 8 requests at beam 4, Adam steps at B=32 x 12 s
    (exactly 4 #1, 4 #2, 1 #5), ``fit`` for one toy epoch, ``bin/eval`` at
    beam 4 with joint rescoring and ``bin/decode --joint-rescore``;
34. ``configs/timit_multitask_ctc.yml`` (123 dims, 3 x BLSTM-256, the sub
    head after layer 2, 61 + 1 phones and 28 + 1 characters): both heads
    card against CPU and one train step, serving on 8 x 7.8 s (TIMIT's
    longest; requests of 1.5-7.8 s), Adam steps at B=32 x 7.8 s (exactly 3
    #1, 3 #2, 2 #5), ``fit``, greedy ``bin/eval`` and ``bin/decode``;
35. ``configs/ls960_joint_bpe.yml`` (the ls960_joint encoder at two
    pyramid levels, T=1198 -> 400 -> 100, hybrid attention, 58 toy BPE
    units): card against CPU and one train step, serving and 8 requests at
    beam 8, Adam steps, ``fit``, ``bin/eval`` at beam 8 with rescoring and
    ``bin/decode``; then at 1029 units card against CPU (the beam reported,
    not held: see ``run_families``) and timed Adam steps;
36. ``configs/ls_word_ctc.yml`` (360 dims, 5 x BLSTM-512, 51 words of the
    hard corpus): card against CPU, one train step, the prefix beam at W=8
    card against CPU and timed, 8 requests at beam 8, Adam steps, ``fit``
    on the hard corpus, ``bin/eval`` at beam 8 and ``bin/decode``;
37-40. ``configs/ls_streaming_ctc.yml``, ``ls_transducer.yml``,
    ``ls_streaming_conformer.yml`` and ``ls_conformer_transducer.yml``
    (read from the files) at full width, streamed on 8 x 12 s and shorter
    (four rows end on a chunk boundary) in 100 ms chunks: the greedy tokens
    equal the port's offline decode on the card; the prefix beam at W=8
    (ls_streaming_ctc) and the transducer beam at W=4 (ls_transducer)
    finalize to the offline beam, and again with an RNN-LM over the
    characters fused (8 x 4 s); card against CPU on 2 x 1 s; a paused and
    resumed session equal to the straight one, every paused row's state
    kept bit for bit; ms per chunk step at B=8 (host clock), one step's
    device time, busy share and device launches (exactly 4 ``fwd_walk``
    launches and 4 on ``lstm_layer.launches`` per step for the LSTM
    configs, 0 for the conformers; the plain LSTM step refused);
41. ``bin/serve --stream`` (``make_stream_server``) on ls_streaming_ctc, 8
    slots: 8 concurrent sessions posting 12 s in 100 ms posts at real time
    (tokens equal the offline decode), a ninth session refused with 503;
    /stream/audio and /stream/end latencies; launch counts reset just
    before and read just after (4 #3 per step);
42. the offline transducer beam at W=4 on 8 x 12 s (ls_transducer): wall,
    and the device time and busy share of its first 50 frames; ``bin/eval``
    and ``bin/decode`` at ``--beam-width 4`` on the model dir phase 24's
    ``fit`` wrote;
43. kernel #3 resuming from a carried state (``lstm_layer_fwd_carry``) at
    the two streaming chunk shapes, B=8, H=512: T=10, D=40
    (ls_streaming_ctc's 100 ms) and T=5, D=120 (ls_transducer's five
    stacked windows), random (h0, c0), lengths 0..T, against its plain
    version (rows at 0 give back h0 and c0 bit for bit); its device
    launches per call, timed with CUDA events and from graph replays,
    beside cuDNN's unidirectional ``nn.LSTM`` with (h0, c0) and the bound;
44. ``compute_dtype: bfloat16``: kernels #1-#4 with bf16 streams (their
    ``*_bf16`` entries) against their plain versions at B=128, T=400,
    H=512, every row full (the headline's shape; with ``cs``) and at B=32
    with ragged lengths, within two bf16 ulps (rtol 8e-3, atol 1e-5) on
    ys, cs and dxproj and 1e-3 of the largest entry on the autograd
    Function's dWh; CUDA-event times beside the float32 kernels at the
    same shape and cuDNN ``nn.LSTM`` in bf16 (where torch takes it; the
    forward also beside cuDNN's float32 forward, and the forward's step
    phases from its own trace), device launches per call, the bound of the
    bf16 streams' bytes; then #1-#4 in float32 and bf16 streams at B=128
    with ragged lengths and at B=100 (not a multiple of the 16-row tiles),
    and #1 and #3 at the serving batch B=8 (their FFMA product), against
    their plain versions (KERNEL_ATOL, BWD_ATOL; two bf16 ulps), two calls
    bitwise equal, one launch per call, timed beside their 3xTF32 and FFMA
    bounds, with each forward's step phases;
45. the headline step: ``bench.py``'s task (5 x BLSTM-512, 120 dims, 3/3
    stacking, 28 classes, U=40, Adam with clip 5.0) at B=128 x 12 s in
    float32 and in bf16, 10 timed steps each after warm-up: ms per step,
    utterances/s, peak memory, busy share from a profiled step, and
    exactly 5 #1, 5 #2 and 1 #5 per step (the bf16 entries in the bf16
    run); the bf16 step card against CPU on 2 x 1 s (the loss within 1e-3
    relative, each gradient within 2e-2 of its largest entry);
46. ``configs/ls100_ctc.yml`` at bf16: ``build_inference_fn`` on the card
    against the CPU on the 8 request lengths (logits within 5e-2, frame
    argmax equal except where the CPU's top two logits lie within 5e-2),
    and 8 requests through ``bin/serve.make_server`` (5 bf16 #1 per batch);
47. ``configs/ls_transducer.yml`` at bf16: ``f_proj`` and one train step
    card against CPU, timed train steps at B=32 x 12 s (4 bf16 #3 and 4
    bf16 #4 per step), the encoder and greedy decode of 8 x 12 s (4 bf16
    #3);
48. the conformer CTC model at d=512 x 8 in bf16 (the scale and dtype
    ``configs/ls960_conformer_ctc.yml`` recommends for LibriSpeech-960):
    logits and one train step card against CPU, timed train steps beside
    phase 31's float32 ones;
49. kernel #7 on bf16 encoder rows (``location_attend_bf16``, the attention
    families at bfloat16) against its plain version at the float32
    tolerances: ls960_joint's beam call (N=64, G=8) and greedy call (N=8),
    csj_joint's beam call without keys (N=32, G=4, A=128, He=640); two
    calls bitwise equal and equal to the float32 kernel on the rows
    widened, two device launches per call, graph-replay times
    beside the float32 kernel on the rows widened and the bound;
50. ``configs/ls960_joint.yml`` at bf16, full width: card against CPU on 2 x
    1 s (CTC logits within 5e-2 with argmax flips only at near-ties; greedy
    ids equal, a row decoding apart only after a near-tie; the beam-8 best
    after joint rescoring equal or a printed near-tie; one train step: terms
    within 1e-3, gradients within 2e-2 of each maximum); 8 requests at beam
    8 through ``bin/serve.make_server`` (bf16 #1 and ``location_attend_bf16``
    alone: no float32 #7 call); Adam steps at B=32 x 12 s in bf16 beside
    phase 17's float32 ones (exactly 5 bf16 #1, 5 bf16 #2, 1 #5);
51. ``configs/csj_joint.yml`` at bf16: card against CPU (beam 4, rescored)
    and one train step (the card's max-pool decisions replayed);
52. ``configs/timit_attention.yml`` and ``ls960_joint_bpe.yml`` at bf16:
    greedy card against CPU and one train step each; then the bf16
    products' gradients, read off phases 45 and 48 (step times, the
    conformer's cuBLAS time, gradients card against CPU);
53. on-disk corpora: 112 utterances of the hard toy corpus (2-12 s, 16
    speakers, character labels) written as 16-bit PCM wavs in the splits
    train (64), dev_clean, dev_other and test_clean (16 each); ``bin/prepare``
    on the card with ls100_ctc's frontend (40 mel, no energy, deltas) at
    ``--cmvn utterance`` and ``none`` (every split), ``speaker`` and
    ``--feature mfcc`` (train), every ``.npy`` held against the same CLI
    on the CPU (atol 1e-4; raw log-mel also 1e-5 relative) and
    ``transcripts.tsv`` byte for byte; utterances per second (no kernel
    launched);
54. ``train/loop.fit`` on ls100_ctc at full width for one epoch of the
    prepared corpus (``data_root``, 2 steps of batch 32 in 4 microbatches of
    8): finite losses, no skipped step, exactly 4 x (5 #1, 5 #2, 1 #5) per
    step and one #6 (with 5 #1) per dev batch; ``bin/eval`` on the model dir
    scores dev_clean, dev_other and test_clean by name (the prefix beam at
    20, #1 and #6); ``fit`` again with ``cmvn: speaker`` on the ``--cmvn
    none`` corpus, the same launch counts;
55. gradient accumulation at B=32 x 12 s: one SGD step (dropout off) over
    4 microbatches against the one-batch step on the card (the loss within
    1e-5 relative, every weight's update within 1e-3 of the tensor's
    largest), then Adam steps timed both ways (``time_train_steps``: ms per
    step, peak memory, exactly 4 x and 1 x (5 #1, 5 #2, 1 #5), walks in
    the profile); the accumulated step's peak memory must be the lower;
56. ``bin/export --frames 1200 --selfcheck`` of phase 54's ls100_ctc
    ``data_root`` model on the card, then ``bin/serve ARTIFACT``
    (``make_artifact_server``) answering 8 concurrent feature requests of the
    prepared dev_clean utterances: ids equal the in-process ``infer`` on the
    card, exactly 5 #1 launches per batch; artifact size, load + warmup,
    first-request latency;
57. ls960_joint at beam 8 (#1, #7) and ls_transducer greedy (#3) exported
    with ``serving.export_model`` and loaded back on the card: ids, lengths
    and launch counts on 8 x 12 s equal the in-process serving's;
58. ls_streaming_ctc exported as a streaming artifact at beam 8 and served by
    ``bin/serve ARTIFACT``'s session API (8 concurrent sessions): each
    finalized beam equals the in-process stream's, exactly 4
    ``lstm_layer_fwd_carry`` launches per step;
59. #3's carried walk with bf16 products (``lstm_layer_fwd_carry_bf16``) at
    both chunk shapes against its plain version (one step within 1e-4,
    the chunk within atol 1e-3 + rtol 1e-3: an h may round to the other bf16
    neighbour on each side), a paused row's state bit for bit, timed from
    graph replays beside the float32 carried walk and cuDNN bf16
    ``nn.LSTM`` with (h0, c0);
60. the four causal configs at compute_dtype bfloat16 and full width,
    streamed on 8 x up to 4 s: exactly one bf16-product walk per LSTM layer
    and step; every chunk step run again with the card's plain walk from the
    same state (a bf16 rounding that lands the other way compounds over a
    stream, so each step is held alone): encoder outputs within 5e-3 of their
    largest entry, tokens equal unless the decisions part at a near-tie (top
    two logits within 5e-2); the chunk step timed beside the float32 one;
61. ls100_ctc at full width with three other encoders, built in code: 5 x
    BGRU-512, 5 x BLSTM-512 with peephole, cell clip 50 and a 256-wide
    projection (the scan path, no kernel), and ``cnn_zhang`` (5x3
    convolutions of 128, 128, 256, 256 channels, frequency pools, a 1024
    dense layer); each card against CPU on 2 x 1 s (logits 1e-3, ids equal)
    and one SGD train step (loss, every gradient 1e-3 of max, weights, ids;
    ``cnn_zhang``'s pools replay the card's argmax on the CPU);
62. each served: encoder ms on 8 x 12 s, one batch profiled (device time,
    busy share, device launches), 8 concurrent ``/recognize`` requests
    (none of the counted kernels launched);
63. each one's Adam steps at B=32 x 12 s: ms per step, peak memory, busy
    share, device launches, and exactly one #5 and no walk (#1-#4) per step;
64. configs/ls_streaming_ctc.yml with ``encoder_type: gru``, and with the
    option cell, streamed on 8 x up to 4 s: no kernel launched (no #3),
    tokens equal the offline decode and the CPU's stream; the chunk step at
    B=8 x 100 ms timed and profiled;
65. ``fit`` on the ``cnn_zhang`` config for one toy epoch with
    ``profile_steps=(1, 2)``: the Chrome trace holds the card's kernels, one
    #5 per step and #6 in the dev eval; ``bin/eval`` (beam 20) and
    ``bin/export --selfcheck`` on its model dir, the artifact's ids equal
    to in-process serving;
66. the C++ host runtime (``data/native.py``) built with the host compiler,
    ``batch_assemble`` and ``levenshtein_batch`` bit-equal to their numpy /
    Python fallbacks (a failed build fails the phase);
67. plotting is not run (the card's machine has no matplotlib; the CPU tests
    draw the PNGs);
68. data parallelism (``parallel/``), two ranks on the one card over gloo
    (NCCL refuses two ranks on one GPU), spawned with the kernels already
    built: ls100_ctc at full width, dropout off, one Adam step on B = 32 x
    12 s, 16 rows per rank, against the one-process step on the same 32
    rows (rank 0 computes it): loss within 1e-5, each gradient leaf within
    ``DP_GRAD_RTOL`` (3e-4) of its largest entry, the weights within 1e-5 of the
    initial ones less Adam's first update from the rank's moments
    (``adam_first_weights``; Adam's first step amplifies a gradient near 0,
    so the weights themselves are reported against one process), weights
    bit-identical across ranks, exactly 5 #1, 5 #2 and 1 #5 per rank per
    step; ms per step per rank (not a scaling number), the bytes all-reduced
    per step and the all-reduce's ms; then a world of 1 over nccl in this
    process, bit-equal to the one-process step; with two or more cards, a
    world of min(cards, 4) over nccl, one card per rank;
69. the same at ``fsdp: true`` (ZeRO-3): each rank holds half of every
    divisible leaf and of its Adam moments (bytes beside DP's); after 2 Adam
    steps the gathered weights equal phase 68's DP run of the same 2 steps
    within 1e-6 of each leaf's largest entry; the all-gather's and
    reduce-scatter's ms; the same launches per rank;
70. ls960_joint at full width under DP (world 2), one Adam step against one
    process as phase 68; then ``fit`` for one toy epoch of ls100_ctc with
    ``num_devices: 2`` (#6 in each rank's dev eval): its dev error equals a
    one-process ``fit`` of the same data, dropout off, its dev and train
    losses within 1e-4 of that run's, and rank 0's checkpoint restored in
    one process scores the same dev error and its dev loss within 1e-4;
71. the model axes (``parallel/tp.py``, ``sp.py``, ``ep.py``), ranks on the
    one card over gloo as phases 68-70, each a full-width config from its
    dict, dropout off, one Adam step on B = 32 x 12 s against the
    one-process step on the same rows (rank 0 computes it): the loss within
    1e-5, each gradient leaf within ``DP_GRAD_RTOL`` of its largest entry (a
    key bias of exact gradient 0 within ``CANCELLED_RTOL`` of the largest
    entry of all), the gathered weights within 1e-5 of the initial ones
    less Adam's first update from the rank's moments, exactly one #5 per
    rank (none for the transducer); ms per step per rank, bytes by
    collective and the weights + Adam MiB resident per rank:
    ls960_conformer_ctc under tp2, sp2 (world 2), tp2 x sp2 and dp2 x tp2 +
    fsdp (world 4); ls960_moe_conformer under ep2, ep4 and dp2 x ep2 + fsdp;
    ls_conformer_transducer (rotary, left context 32) under sp2;
72. ``fit`` for one toy epoch of ls960_conformer_ctc (256 utterances,
    dropout off) with ``num_model_shards: 2``: its dev error equals a
    one-process ``fit`` of the same data, its losses within 1e-4, and
    ``bin/eval`` restores its checkpoint in one process (dev error equal);
    with four or more cards, dp2 x tp2 over nccl, one card per rank;
73. pipeline stages (``parallel/pp.py``) in the same spawns and with the
    same gates as phase 71, in the default 4 x stages microbatches:
    ls960_conformer_ctc, ls960_transformer_ctc and ls_conformer_transducer
    under pp2 (world 2), ls960_conformer_ctc under pp4 (one layer per
    stage), dp2 x pp2 and pp2 x tp2 (world 4), with the stage hops' bytes
    among the collectives'; the phase 72 ``fit`` with
    ``num_pipeline_stages: 2`` beside it, and its checkpoint through
    ``bin/eval`` in one process; with four or more cards, pp2 x tp2 over
    nccl too.

Each kernel is timed with CUDA events in the order plain, kernel, kernel,
plain, beside one PyTorch call that computes the same function where there
is one (cuDNN ``nn.LSTM``, bidirectional for #1/#2 and unidirectional for
#3/#4; ``F.log_softmax`` + ``F.ctc_loss``; none for the attention read),
which the port never calls; the calls of #5-#7, short beside their Python
wrapper, are timed from CUDA-graph replays (#3 with a carried state too).
Prints a JSON line of the kernels (and the prefix beam's, the conformers',
the families', the streams', the encoder zoo's and phases 68-72's numbers;
each kernel's ``launches_<path>`` counts include the ranks' paths, per
rank), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import http.client
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import types
import wave
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tensorflow_end2end_speech_recognition_tpu_torch import set_full_fp32
from tensorflow_end2end_speech_recognition_tpu_torch.bin import decode as decode_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import export as export_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import prepare as prepare_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train_lm as train_lm_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin.serve import (
    make_artifact_server,
    make_server,
)
from tensorflow_end2end_speech_recognition_tpu_torch.data.hard_corpus import HardCorpus
from tensorflow_end2end_speech_recognition_tpu_torch.data.tokenizers import CHAR_UNITS
from tensorflow_end2end_speech_recognition_tpu_torch.decoding import (
    attention_beam_search,
    ctc_prefix_beam,
    ctc_prefix_beam_search,
    joint_rescore,
)
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.ctc_greedy import (
    ctc_greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch import streaming
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_beam import (
    transducer_beam_search,
)
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_greedy import (
    transducer_greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models import rnn, seq2seq
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.lm import make_fusion_lm
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import pred_tokens
from tensorflow_end2end_speech_recognition_tpu_torch.ops import attention, build, ctc, lstm
from tensorflow_end2end_speech_recognition_tpu_torch.ops.transducer import rnnt_loss
from tensorflow_end2end_speech_recognition_tpu_torch.serving import (
    build_inference_fn,
    export_model,
    export_streaming_model,
    load_exported,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train import (
    att_task,
    ctc_task,
    transducer_task,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import device_pipeline
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import (
    build_corpus_splits,
    build_task,
    fit,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    ExperimentConfig,
    corpus_tokenizer,
    experiment_from_dict,
)

SR = 16000
B, T_ENC, D_IN, H, LAYERS = 8, 400, 360, 512, 5  # serving batch
B_TRAIN, C, U = 32, len(CHAR_UNITS) + 1, 40  # training batch, classes, labels
U_LONG = 180  # a 12 s transcript of read English, at about 15 characters a second
CTC_REPS = 50  # kernel #5 / #6 calls per timed graph replay
# float32 tolerances. The kernels and cuBLAS sum each 512-long dot product in
# different orders, and the difference is carried through 400 recurrent steps
KERNEL_ATOL = 1e-4
BWD_ATOL = 1e-4  # dxproj: the same, through the reverse walk
CTC_LOSS_RTOL = 1e-5  # losses of about 1e3, a sum of 400 log terms
CTC_GRAD_ATOL = 1e-5  # gradients are probabilities in [-1, 1]
MODEL_ATOL = 1e-3  # logits after the frontend, 5 BLSTM-512 layers and the head
# a beam score sums up to 120 log-probabilities, each within about 1e-5
BEAM_SCORE_RTOL = 1e-5
LOSS_RTOL = 1e-4  # full-width train step, card vs CPU
GRAD_RTOL = 1e-3  # each gradient within 1e-3 of its largest entry
CANCELLED_RTOL = 1e-6  # a gradient zero in exact arithmetic, of the largest gradient entry
REQUEST_SECONDS = (12.0, 12.0, 10.5, 9.0, 7.0, 5.0, 3.0, 1.0)
TIMED_STEPS = 5
# H100 SXM peak rates: float32 outside the tensor cores, TF32 on them, HBM
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
F32 = 4
PKG = "tensorflow_end2end_speech_recognition_tpu_torch"
KERNELS = {
    "lstm_bidi_fwd": {"source": f"{PKG}/csrc/lstm_bidi_fwd.cu",
                      "replaces": "tensorflow_end2end_speech_recognition_tpu/ops/pallas/"
                                  "lstm_kernel.py:372"},
    "lstm_bidi_bwd": {"source": f"{PKG}/csrc/lstm_bidi_bwd.cu",
                      "replaces": "tensorflow_end2end_speech_recognition_tpu/ops/pallas/"
                                  "lstm_kernel.py:414"},
    "ctc_loss": {"source": f"{PKG}/csrc/ctc_loss.cu",
                 "replaces": "tensorflow_end2end_speech_recognition_tpu/ops/pallas/"
                             "ctc_kernel.py:62"},
    "ctc_loss_fwd_only": {"source": f"{PKG}/csrc/ctc_loss.cu",
                          "replaces": "tensorflow_end2end_speech_recognition_tpu/ops/pallas/"
                                      "ctc_kernel.py:281"},
    "location_attend": {"source": f"{PKG}/csrc/location_attend.cu",
                        "replaces": "tensorflow_end2end_speech_recognition_tpu/ops/pallas/"
                                    "attention_kernel.py:47"},
    "lstm_layer_fwd": {"source": f"{PKG}/csrc/lstm_layer_fwd.cu",
                       "replaces": "tensorflow_end2end_speech_recognition_tpu/ops/pallas/"
                                   "lstm_kernel.py:55"},
    "lstm_layer_bwd": {"source": f"{PKG}/csrc/lstm_layer_bwd.cu",
                       "replaces": "tensorflow_end2end_speech_recognition_tpu/ops/pallas/"
                                   "lstm_kernel.py:85"},
}
# the bf16-stream instantiations of #1-#4 (compute_dtype: bfloat16): their own C
# entries in the same sources, each counted apart from its float32 one
KERNELS.update({f"{name}_bf16": KERNELS[name] for name in (
    "lstm_bidi_fwd", "lstm_bidi_bwd", "lstm_layer_fwd", "lstm_layer_bwd")})
# #7 on bf16 encoder rows (the attention families at bfloat16): its own C entry
KERNELS["location_attend_bf16"] = KERNELS["location_attend"]
# #3's carried walk with bf16 products (streaming at bfloat16): its own C entry
KERNELS["lstm_layer_fwd_carry_bf16"] = KERNELS["lstm_layer_fwd"]


class Bf16Count:
    """A wrapper's bf16 launch count (``launches_bf16``, or the counter named
    ``attr``) under the ``launches`` name that ``reset_counts`` and
    ``read_counts`` use."""

    def __init__(self, fn, attr: str = "launches_bf16"):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.fn, self.attr, value)


COUNTERS = {"lstm_bidi_fwd": lstm.lstm_bidi, "lstm_bidi_bwd": lstm.lstm_bidi_bwd,
            "ctc_loss": ctc.ctc_loss_fwd_bwd, "ctc_loss_fwd_only": ctc.ctc_loss_fwd_only,
            "location_attend": attention.location_attend,
            "lstm_layer_fwd": lstm.lstm_layer, "lstm_layer_bwd": lstm.lstm_layer_bwd,
            "lstm_bidi_fwd_bf16": Bf16Count(lstm.lstm_bidi),
            "lstm_bidi_bwd_bf16": Bf16Count(lstm.lstm_bidi_bwd),
            "lstm_layer_fwd_bf16": Bf16Count(lstm.lstm_layer),
            "lstm_layer_bwd_bf16": Bf16Count(lstm.lstm_layer_bwd),
            "location_attend_bf16": Bf16Count(attention.location_attend),
            "lstm_layer_fwd_carry_bf16": Bf16Count(lstm.lstm_layer, "launches_bf16_product")}
NONE_LAUNCHED = dict.fromkeys(COUNTERS, 0)
# attention serving: configs/ls960_joint.yml at full width
B_ATT, T_PYR, D_PYR = 8, 1198, 120  # 12 s: 1198 frames of 40 mel + deltas, no stacking
ATT_T, ATT_A, ATT_HE, ATT_C, ATT_W = 300, 256, 1024, 10, 101  # encoder frames after 2 x 2x
BEAM = 8
# the CTC prefix beam of configs/ls100_ctc.yml (beam_width 20) and the JAX
# eval step's top-K classes; the longest hypothesis joint rescoring scores
CTC_BEAM, CTC_TOPK = 20, 16
RESCORE_U = 120
# float32: one read sums 101 taps, 256 scores and 300 context terms in other
# orders than the plain version's conv / matmul / softmax
ATT_ALIGN_ATOL = 1e-5
ATT_CTX_ATOL = 1e-4
ATT_REQUEST_SECONDS = (12.0, 11.0, 9.5, 8.0, 6.0, 4.0, 2.5, 1.0)
ATT_GRAD_ATOL = 1e-5  # #7's gradient: the same plain arithmetic on the same inputs
# the timed attention train step's global step: inside the λ anneal (60 steps)
# and the guided-attention decay (192), on the scheduled-sampling ramp
ATT_TRAIN_STEP = 30
# configs/ls960_joint.yml and configs/ls100_ctc.yml as dicts (the card machine
# may have no yaml)
LS960_JOINT = {
    "model_type": "joint_ctc_attention", "corpus": "toy", "label_type": "character",
    "train_data_size": "train960h", "input_size": 40, "use_energy": False, "use_delta": True,
    "num_stack": 1, "num_skip": 1, "encoder_type": "pyramidal_blstm", "num_units": 512,
    "num_layers": 5, "num_pyramid_levels": 2, "attention_type": "hybrid", "attention_dim": 256,
    "decoder_num_units": 512, "embedding_dim": 256, "ctc_loss_weight": 0.3,
    "guided_attention_weight": 5.0, "guided_attention_sigma": 0.2,
    "guided_attention_decay_steps": 192, "ctc_loss_weight_init": 0.6,
    "ctc_loss_weight_anneal_steps": 60, "label_smoothing_prob": 0.05,
    "scheduled_sampling_prob": 0.2, "scheduled_sampling_ramp_max_step": 20000,
    "max_decode_length": 120, "dropout": 0.8, "batch_size": 32, "num_epoch": 15,
    "optimizer": "adam", "learning_rate": 2.0e-3, "warmup_steps": 20, "decay_start_epoch": 5,
    "decay_rate": 0.9, "decay_patient_epoch": 1, "clip_grad_norm": 5.0, "sort_utt": True,
    "sort_stop_epoch": 5, "beam_width": 8, "length_penalty": 0.6, "toy_num_utts": 512,
    "toy_min_units": 8, "toy_max_units": 20,
}
# transducer serving and training: configs/ls_transducer.yml at full width
TR_LAYERS, D_TR = 4, 120  # 40 mel, no deltas, 3/3 stacking
TR_REQUEST_SECONDS = (12.0, 11.5, 10.0, 8.5, 6.5, 4.5, 2.0, 1.0)
TR_TIMED_STEPS = 2
PROFILE_FRAMES = 50
LS_TRANSDUCER = {
    "model_type": "transducer", "corpus": "toy", "label_type": "character", "feature": "fbank",
    "input_size": 40, "use_energy": False, "use_delta": False, "cmvn": "none", "num_stack": 3,
    "num_skip": 3, "encoder_type": "lstm", "num_units": 512, "num_layers": 4,
    "pred_num_units": 128, "pred_num_layers": 1, "embedding_dim": 32, "joint_dim": 256,
    "max_symbols_per_frame": 4, "parameter_init": 0.1, "dropout": 0.9, "dropout_decoder": 1.0,
    "batch_size": 32, "num_epoch": 40, "optimizer": "adam", "learning_rate": 1.0e-3,
    "warmup_steps": 0, "decay_start_epoch": 10, "decay_rate": 0.9, "decay_patient_epoch": 1,
    "clip_grad_norm": 5.0, "weight_decay": 1.0e-8, "sort_utt": True, "sort_stop_epoch": 10,
    "beam_width": 1, "toy_num_utts": 2048,
}
LS100_CTC = {
    "model_type": "ctc", "corpus": "toy", "label_type": "character",
    "train_data_size": "train100h", "input_size": 40, "use_energy": False,
    "use_delta": True, "num_stack": 3, "num_skip": 3, "encoder_type": "blstm",
    "num_units": 512, "num_layers": 5, "dropout": 0.8, "batch_size": 32, "num_epoch": 20,
    "optimizer": "adam", "learning_rate": 1.0e-3, "decay_start_epoch": 5, "decay_rate": 0.9,
    "decay_patient_epoch": 1, "clip_grad_norm": 5.0, "weight_decay": 1.0e-8,
    "sort_utt": True, "sort_stop_epoch": 5, "beam_width": 20, "toy_num_utts": 256,
}
# the conformer / transformer configs at full width (tests/test_torch_conformer_train.py
# holds each dict against its YAML file)
LS960_CONFORMER_CTC = {
    "model_type": "ctc", "corpus": "librispeech", "label_type": "character", "feature": "fbank",
    "input_size": 40, "use_energy": False, "num_stack": 3, "num_skip": 3,
    "encoder_type": "conformer", "num_units": 144, "num_layers": 4, "num_heads": 4,
    "conv_kernel_size": 15, "ff_expansion": 4, "dropout": 0.9, "batch_size": 32, "num_epoch": 25,
    "optimizer": "adam", "learning_rate": 1.0e-3, "warmup_steps": 50, "decay_start_epoch": 8,
    "decay_rate": 0.85, "decay_patient_epoch": 1, "clip_grad_norm": 5.0, "beam_width": 20,
    "toy_num_utts": 512, "toy_vocab_size": None,
}
LS960_TRANSFORMER_CTC = {k: v for k, v in LS960_CONFORMER_CTC.items()
                         if k != "conv_kernel_size"} | {"encoder_type": "transformer"}
LS960_MOE_CONFORMER = LS960_CONFORMER_CTC | {"moe_num_experts": 4, "moe_top_k": 2,
                                             "moe_aux_weight": 1.0e-2}
LS_STREAMING_CONFORMER = LS960_CONFORMER_CTC | {
    "use_delta": False, "cmvn": "none", "pos_encoding": "rotary", "left_context": 32,
    "beam_width": 1}
LS960_CONFORMER_CTC_SA = LS960_CONFORMER_CTC | {"use_specaugment": True}
LS_CONFORMER_TRANSDUCER = {k: v for k, v in LS_STREAMING_CONFORMER.items()
                           if k not in ("model_type",)} | {
    "model_type": "transducer", "pred_num_units": 128, "embedding_dim": 32, "joint_dim": 256,
    "num_epoch": 30, "decay_start_epoch": 10}
# the scale configs/ls960_conformer_ctc.yml names for real LibriSpeech-960: not a config
CONFORMER_WIDE = LS960_CONFORMER_CTC | {"num_units": 512, "num_layers": 8, "num_heads": 8}
CONFORMER_LAYERS, D_CONF = LS960_CONFORMER_CTC["num_layers"], LS960_CONFORMER_CTC["num_units"]


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs, CUDA events."""
    fn()  # warm: caches, allocator
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def plain_kernel_ms(plain, kernel, reps_plain: int, reps_kernel: int) -> dict:
    """Times in the order plain, kernel, kernel, plain."""
    p = [cuda_ms(plain, reps_plain)]
    k = [cuda_ms(kernel, reps_kernel) for _ in range(2)]
    p.append(cuda_ms(plain, reps_plain))
    return {"ms": sum(k) / 2, "plain_ms": sum(p) / 2, "ms_runs": k, "plain_ms_runs": p}


@functools.lru_cache(maxsize=None)
def side_stream() -> torch.cuda.Stream:
    """The one stream that warms up every captured call: each new stream that
    runs a cuBLAS call gets a workspace that stays allocated for the process
    (and so in the peak memory of every later phase)."""
    return torch.cuda.Stream()


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` from CUDA events around one replay of a CUDA
    graph that holds ``reps`` calls: no host enqueue between the kernels, for
    calls shorter than their Python wrapper."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: library, allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clock(what: str, t0: float) -> None:
    """Print the command time so far, so a run shows where its time limit goes."""
    print(f"[{time.perf_counter() - t0:.1f} s] {what}", flush=True)


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time for the work: bytes over HBM rate vs float32 ops over peak."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations"}


def check(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    """Max abs error of ``got`` against ``want``; raise beyond atol + rtol * |want|."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name}: output {tuple(g.shape)} is misshapen or not finite")
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= atol + rtol * w.abs()).all())
    print(f"{name}: max abs err {err:.3e} (tolerance atol {atol:g} rtol {rtol:g})", flush=True)
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version: {err}")
    return err


def lstm_inputs(dev, b: int, lengths, seed: int, t: int = T_ENC, d: int = D_IN, h: int = H):
    """The projections ``BiLSTM.forward`` hands the kernel, for a first layer."""
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(b, t, d, generator=g).to(dev)
    layer = rnn.BiLSTM(d, h, generator=g).to(dev)
    lengths = torch.tensor(lengths, device=dev)
    with torch.no_grad():
        xproj_f = torch.matmul(xs, layer.fwd.wx) + layer.fwd.b
        xproj_b = rnn.flip_valid(torch.matmul(xs, layer.bwd.wx) + layer.bwd.b, lengths)
    mask = (torch.arange(t, device=dev)[None] < lengths[:, None]).float()
    return (xproj_f, xproj_b, layer.fwd.wh.detach(), layer.bwd.wh.detach(), mask,
            layer.forget_bias), xs, lengths


def layer_inputs(dev, b: int, lengths, seed: int, t: int = T_ENC, d: int = D_TR):
    """The projection ``LSTM.forward`` hands kernel #3, for a first layer."""
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(b, t, d, generator=g).to(dev)
    layer = rnn.LSTM(d, H, generator=g).to(dev)
    lengths = torch.tensor(lengths, device=dev)
    with torch.no_grad():
        xproj = torch.matmul(xs, layer.wx) + layer.b
    return (xproj, layer.wh.detach(), rnn.length_mask(xs, lengths), layer.forget_bias), xs, lengths


def cudnn_lstm(dev, xs, lengths, seed: int, bidirectional: bool = True, h: int = H,
               dtype: torch.dtype = torch.float32):
    """cuDNN ``nn.LSTM`` on a packed sequence: forward, backward calls."""
    torch.manual_seed(seed)
    net = torch.nn.LSTM(xs.shape[-1], h, batch_first=True,
                        bidirectional=bidirectional).to(dev, dtype)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        xs.requires_grad_(True), lengths.cpu(), batch_first=True, enforce_sorted=False)
    out = net(packed)[0]
    grad = torch.randn_like(out.data)
    leaves = [xs, *net.parameters()]

    def forward():
        with torch.no_grad():
            net(packed)

    def backward():
        torch.autograd.grad(out.data, leaves, grad, retain_graph=True)

    return forward, backward


def lstm_work(lengths, h: int, with_cs: bool, backward: bool, t: int = T_ENC,
              dirs: int = 2, elem: int = F32) -> dict:
    """Bytes each input read once / output written once, and float32 operations
    of the valid steps (a masked step needs no work), for one layer's call of
    ``dirs`` directions; ``elem`` bytes per element of xproj, ys, cs, gys and
    dxproj (2 under bf16 streams). The forward's product runs where
    ``fwd_plan`` puts it: float32 FFMA for a launch of up to FWD_FFMA_ROWS
    rows, else float32-accurate on the tensor cores in three TF32 passes (h
    is float32 under either stream type). The backward's (#2, #4) are on the
    tensor cores, three passes each (two for the gates' product on bf16 ys
    rows, which are TF32 values). Tensor-core passes count at PEAK_TF32, the
    gate math at PEAK_F32, and ``bound_ffma_ms`` is the same work as float32
    FFMA."""
    b, valid = len(lengths), float(sum(lengths))
    stream = b * t * h * elem  # one [B, T, H] tensor
    weights = h * 4 * h * F32
    mask = b * t * F32
    product = dirs * valid * 2 * h * 4 * h  # one recurrent product
    if not backward:  # per direction: xproj, wh in; ys (and cs) out
        moved = dirs * (4 * stream + weights + (2 if with_cs else 1) * stream) + mask
        math = dirs * valid * 30 * h
        if not lstm.fwd_plan_for(torch.device("cuda", 0), h, dirs, b).cluster:
            return dict(bound(moved, product + math),
                        bound_ffma_ms=bound(moved, product + math)["bound_ms"])
        passes = 3
    else:  # per direction: xproj, wh, ys, cs, gys in; dxproj out
        moved = dirs * (4 * stream + weights + 3 * stream + 4 * stream) + mask
        math = dirs * valid * 60 * h
        passes = (2 if elem < F32 else 3) + 3
    t_bytes = moved / PEAK_BYTES * 1e3
    t_ops = max(passes * product / PEAK_TF32, math / PEAK_F32) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations",
            "bound_ffma_ms": bound(moved, (2 if backward else 1) * product + math)["bound_ms"]}


def walk_extras(name: str, kernel, plan, dev) -> dict:
    """Kernels #1-#4 beside their timing: two calls equal bit for bit, and the
    launch plan the wrapper takes at this shape."""
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    first, second = (x if isinstance(x, tuple) else (x,) for x in (first, second))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError(f"{name}: two calls on the same inputs differ")
    sm_count = lstm._sm_count(dev.index or 0)
    if isinstance(plan, lstm.FwdPlan) and not plan.cluster:
        path = f", FFMA on {plan.rows} rows a chunk"
    else:
        path = f", clusters of {plan.cluster}, Wh {'split' if plan.split else 'whole'}"
    print(f"{name}: two calls bitwise equal; launch plan {plan.units} units per block, "
          f"{plan.blocks} blocks on {sm_count} SMs{path}, {plan.smem_bytes} B shared "
          f"memory per block, Wh slice {'resident' if plan.resident else 'streamed from L2'} "
          f"({plan.resident_bytes} B), {plan.chunks} launch(es) per call", flush=True)
    return {"deterministic": True, "plan": plan._asdict()}


def forward_extras(name: str, kernel, dirs: int, b: int, dev, t_ms: dict, steps: int,
                   h: int = H) -> dict:
    """Kernel #1 or #3: ``walk_extras`` and the time per step of ``t_ms``."""
    return dict(walk_extras(name, kernel, lstm.fwd_plan_for(dev, h, dirs, b), dev),
                us_per_step=t_ms["ms"] * 1e3 / steps)


def backward_extras(name: str, kernel, function_backward, dirs: int, dev, h: int = H) -> dict:
    """Kernel #2 or #4: ``walk_extras`` at the train step's shape, and the
    autograd Function's whole backward (the kernel and the dWh
    contractions), the unit that cuDNN's backward compares with."""
    return dict(walk_extras(name, kernel, lstm.bwd_plan_for(dev, h, dirs, B_TRAIN), dev),
                function_backward_ms=cuda_ms(function_backward, 10))


def check_serving_kernel(dev, gpu: str) -> dict:
    """Kernel #1 without ``cs`` at the serving shape; its bound and cuDNN's time."""
    lengths = [T_ENC, 1, 399, 250, 128, 7, 333, T_ENC]
    args, xs, lens = lstm_inputs(dev, B, lengths, seed=0)
    kernel = lambda: lstm.lstm_bidi(*args)  # noqa: E731
    with torch.no_grad():
        got = kernel()
        want = lstm.lstm_bidi_fwd_plain(*args)[:2]
        torch.cuda.synchronize()
        err = check(f"lstm_bidi_fwd (serving) B={B} T={T_ENC} H={H}", got, want, KERNEL_ATOL)
        t = plain_kernel_ms(lambda: lstm.lstm_bidi_fwd_plain(*args), kernel, 2, 20)
        extras = forward_extras("lstm_bidi_fwd (serving)", kernel, 2, B, dev, t, T_ENC)
    lib_fwd, _ = cudnn_lstm(dev, xs, lens, seed=0)
    r = dict(t, max_abs_err=err, library_ms=cuda_ms(lib_fwd, 10), **extras,
             **lstm_work(lengths, H, with_cs=False, backward=False))
    print(f"phase lstm_bidi_fwd serving B={B} T={T_ENC} H={H}: kernel {r['ms']:.3f} ms (runs "
          f"{t['ms_runs'][0]:.3f}, {t['ms_runs'][1]:.3f}; {r['us_per_step']:.2f} us per step), "
          f"plain {t['plain_ms']:.3f} ms (runs "
          f"{t['plain_ms_runs'][0]:.3f}, {t['plain_ms_runs'][1]:.3f}), bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuDNN nn.LSTM forward "
          f"{r['library_ms']:.3f} ms, max abs err {err:.3e}  [{gpu}]", flush=True)
    return r


def check_training_lstm(dev, gpu: str, t: int = T_ENC, d: int = D_IN, seed: int = 1,
                        what: str = "train", h: int = H) -> dict:
    """Kernels #1 (with ``cs``) and #2 at a train step's first layer: B=32,
    ``t`` frames of ``d`` features into ``h`` units (ls100_ctc's by default)."""
    rng = np.random.RandomState(seed + 3)
    lengths = [t, 1] + [int(x) for x in rng.randint(t // 2, t + 1, B_TRAIN - 2)]
    args, xs, lens = lstm_inputs(dev, B_TRAIN, lengths, seed=seed, t=t, d=d, h=h)
    gys = [torch.from_numpy(rng.randn(B_TRAIN, t, h).astype(np.float32)).to(dev)
           for _ in range(2)]
    fwd_k = lambda: lstm.lstm_bidi_fwd(*args, with_cs=True)  # noqa: E731
    with torch.no_grad():
        got = fwd_k()
        want = lstm.lstm_bidi_fwd_plain(*args)
        torch.cuda.synchronize()
        fwd_err = check(f"lstm_bidi_fwd with cs B={B_TRAIN} T={t} H={h}", got, want,
                        KERNEL_ATOL)
        bwd_args = (*args[:5], *want, *gys, args[5])
        got = lstm.lstm_bidi_bwd(*bwd_args)
        want_dx = lstm.lstm_bidi_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        bwd_err = check(f"lstm_bidi_bwd B={B_TRAIN} T={t} H={h}", got, want_dx, BWD_ATOL)
        tf = plain_kernel_ms(lambda: lstm.lstm_bidi_fwd_plain(*args), fwd_k, 1, 10)
        fwd_extras = forward_extras("lstm_bidi_fwd with cs", fwd_k, 2, B_TRAIN, dev, tf, t, h)
        tb = plain_kernel_ms(lambda: lstm.lstm_bidi_bwd_plain(*bwd_args),
                             lambda: lstm.lstm_bidi_bwd(*bwd_args), 1, 10)
        ctx = types.SimpleNamespace(saved_tensors=(*args[:5], *want), forget_bias=args[5])
        extras = backward_extras(
            "lstm_bidi_bwd", lambda: lstm.lstm_bidi_bwd(*bwd_args),
            lambda: lstm.LSTMBidi.backward(ctx, *gys), 2, dev, h)
    lib_fwd, lib_bwd = cudnn_lstm(dev, xs, lens, seed=seed, h=h)
    lf, lb = cuda_ms(lib_fwd, 10), cuda_ms(lib_bwd, 10)
    out = {
        "lstm_bidi_fwd": dict(tf, max_abs_err=fwd_err, library_ms=lf, **fwd_extras,
                              **lstm_work(lengths, h, with_cs=True, backward=False, t=t)),
        "lstm_bidi_bwd": dict(tb, max_abs_err=bwd_err, library_ms=lb, **extras,
                              us_per_step=tb["ms"] * 1e3 / t,
                              **lstm_work(lengths, h, with_cs=True, backward=True, t=t)),
    }
    for name, r in out.items():
        print(f"phase {name} {what} B={B_TRAIN} T={t} D={d} H={h}: kernel {r['ms']:.3f} ms (runs "
              f"{r['ms_runs'][0]:.3f}, {r['ms_runs'][1]:.3f}; {r['ms'] * 1e3 / t:.2f} us per "
              f"step), plain {r['plain_ms']:.3f} ms "
              f"(runs {r['plain_ms_runs'][0]:.3f}, {r['plain_ms_runs'][1]:.3f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuDNN nn.LSTM "
              f"{'backward' if 'bwd' in name else 'forward'} {r['library_ms']:.3f} ms"
              + (f", LSTMBidi.backward (kernel + dWh) {r['function_backward_ms']:.3f} ms"
                 if 'bwd' in name else "") + f"  [{gpu}]", flush=True)
    return out


def ctc_inputs(dev, seed: int, u: int = U, c: int = C, t: int = T_ENC):
    """B=32, ``t`` frames (400), ``c`` classes (29), at most ``u`` labels,
    ragged logit and label lengths (all alignable: at least 2u+1 frames)."""
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(B_TRAIN, t, c) * 3).astype(np.float32)).to(dev)
    label_len = rng.randint(1, u + 1, B_TRAIN).astype(np.int32)
    label_len[0] = u
    labels = np.full((B_TRAIN, u), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, c - 1, n)
    logit_len = rng.randint(2 * u + 1, t + 1, B_TRAIN).astype(np.int32)
    logit_len[0] = t
    as_t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return logits, as_t(logit_len), as_t(labels), as_t(label_len)


def device_launches(fn, reps: int = 5) -> dict:
    """Per kernel that ``fn`` launches: device launches per call and µs per
    launch, from the profiler. One warm-up step of the profiler's schedule
    runs ``fn`` once with the tracer already on, and only the active step's
    ``reps`` calls are read: a window that opens on the first call can miss
    its launches. The active step starts with about 1 ms of a spin kernel
    of its own, left out of the counts: a kernel that starts at once after
    the window opens can fall before its edge, which is read on the host's
    clock (seen twice: one ``ctc_frames`` launch of 5 calls missing). The
    tracer can still lose launches (seen once: 1 of 5 calls' kernels
    recorded; in PR 14, three windows in three runs that recorded no
    kernel at all), never add them: a window that recorded nothing, or
    whose count of some kernel is not a whole number per call, is read
    again, up to ten windows. Scheduled windows and plain ones (a profile
    around the spin kernel and the calls, as ``device_busy`` reads a step)
    take turns: late in a long run the scheduled windows have come back
    empty many times in a row (31 in phase 44 of one run, 5 of 5 in phase
    43 of another), and four windows of either kind have come back empty or
    short before the fifth read every launch."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(10):
        events = []
        if attempt % 2 == 0:
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: events.extend(p.key_averages())) as prof:
                fn()
                torch.cuda.synchronize()
                prof.step()
                torch.cuda._sleep(2_000_000)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        else:
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(2_000_000)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
        out = {e.key.split("(")[1].split("::")[-1]: {"per_call": e.count / reps,
                                                      "us": e.self_device_time_total / e.count}
               for e in events if e.self_device_time_total > 0 and "spin_kernel" not in e.key}
        if out and all(v["per_call"] == int(v["per_call"]) for v in out.values()):
            break
        print(f"device_launches: the profiler's window {attempt + 1} recorded {out}; reading "
              "another", flush=True)
    return out


def ctc_work(logit_len, label_len, u: int, grad: bool, b: int = B_TRAIN,
             t: int = T_ENC, c: int = C) -> dict:
    """Bytes (logits read, gradient written, labels, lengths, loss) and float32
    operations of the valid frames: per frame about 4 C ops of log-softmax
    and 12 per lane for alpha; for training also beta, gamma (12 each per
    lane) and the gradient (C softmax terms, one posterior per lane)."""
    valid = logit_len.double()
    lanes = 2 * label_len.double() + 1
    logits_b = b * t * c * F32
    small = (b * u + 3 * b) * F32
    if grad:
        return bound(2 * logits_b + small, float((valid * (6 * c + 40 * lanes)).sum()))
    return bound(logits_b + small, float((valid * (4 * c + 12 * lanes)).sum()))


def check_ctc(dev, gpu: str) -> dict:
    """Kernels #5 and #6 against their plain versions at U = 40 (the train
    step's) and U = 180: two calls equal bit for bit, device launches per
    call, times from graph replays beside the plain versions and
    ``F.log_softmax`` + ``F.ctc_loss``."""
    blank = C - 1
    cases = {u: ctc_inputs(dev, seed=5, u=u) for u in (U, U_LONG)}
    out = {}
    for u, args in cases.items():
        logits, logit_len, labels, label_len = args
        shape = f"B={B_TRAIN} T={T_ENC} C={C} U={u}"
        got = ctc.ctc_loss_fwd_bwd(*args, blank)
        again = ctc.ctc_loss_fwd_bwd(*args, blank)
        want = ctc.ctc_loss_plain(*args, blank)
        fwd, fwd_again = (ctc.ctc_loss_fwd_only(*args, blank) for _ in range(2))
        torch.cuda.synchronize()
        loss_err = check(f"ctc_loss {shape}: loss", got[:1], want[:1], 0.0, CTC_LOSS_RTOL)
        grad_err = check(f"ctc_loss {shape}: grad", got[1:], want[1:], CTC_GRAD_ATOL)
        fwd_err = check(f"ctc_loss_fwd_only {shape}: loss", [fwd], want[:1], 0.0, CTC_LOSS_RTOL)
        if not (all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(fwd, fwd_again)):
            raise RuntimeError(f"ctc_loss {shape}: two calls on the same inputs differ")
        print(f"ctc_loss {shape}: two calls bitwise equal (loss, grad; loss-only)", flush=True)
        x = logits.clone().requires_grad_(True)
        ones = torch.ones(B_TRAIN, device=dev)

        def library(backward: bool):
            with torch.set_grad_enabled(backward):
                lp = F.log_softmax(x, dim=-1).transpose(0, 1)
                nll = F.ctc_loss(lp, labels.long(), logit_len.long(), label_len.long(),
                                 blank=blank, reduction="none")
                if backward:
                    torch.autograd.grad(nll, x, ones)
            return nll

        lib_diff = float((library(False) - want[0]).abs().max() / want[0].abs().max())
        print(f"F.ctc_loss vs the plain loss at U={u}: max rel diff {lib_diff:.2e}", flush=True)
        out[u] = {
            "ctc_loss": dict(max_abs_err=max(loss_err, grad_err), deterministic=True,
                             library_ms=cuda_ms(lambda: library(True), 20),
                             device_launches=device_launches(
                                 lambda: ctc.ctc_loss_fwd_bwd(*args, blank)),
                             **ctc_work(logit_len, label_len, u, grad=True)),
            "ctc_loss_fwd_only": dict(max_abs_err=fwd_err, deterministic=True,
                                      library_ms=cuda_ms(lambda: library(False), 20),
                                      device_launches=device_launches(
                                          lambda: ctc.ctc_loss_fwd_only(*args, blank)),
                                      **ctc_work(logit_len, label_len, u, grad=False)),
        }
        for name, r in out[u].items():
            r["plan"] = ctc.ctc_plan(B_TRAIN, T_ENC, 2 * u + 1, name == "ctc_loss")._asdict()
            r["ms_runs"], r["plain_ms_runs"] = [], []
        for name, plain in (("ctc_loss", ctc.ctc_loss_plain),
                            ("ctc_loss_fwd_only", ctc.ctc_loss_fwd_only_plain)):
            out[u][name]["plain_ms_runs"].append(cuda_ms(lambda: plain(*args, blank), 2))

    # plain, kernel, kernel, plain
    kernels = {"ctc_loss": ctc.ctc_loss_fwd_bwd, "ctc_loss_fwd_only": ctc.ctc_loss_fwd_only}
    for _ in range(2):
        for u, args in cases.items():
            for name, fn in kernels.items():
                out[u][name]["ms_runs"].append(graph_ms(lambda: fn(*args, blank), CTC_REPS))
    for u, args in cases.items():
        for name, plain in (("ctc_loss", ctc.ctc_loss_plain),
                            ("ctc_loss_fwd_only", ctc.ctc_loss_fwd_only_plain)):
            out[u][name]["plain_ms_runs"].append(cuda_ms(lambda: plain(*args, blank), 2))
        for name, r in out[u].items():
            r["ms"] = sum(r["ms_runs"]) / 2
            r["plain_ms"] = sum(r["plain_ms_runs"]) / 2
            r["us_per_step"] = r["ms"] * 1e3 / T_ENC
            split = ", ".join(f"{k} {v['per_call']:g} x {v['us']:.2f} us"
                              for k, v in r["device_launches"].items())
            print(f"phase {name} B={B_TRAIN} T={T_ENC} C={C} U={u}: kernel {r['ms']:.4f} ms "
                  f"(runs {r['ms_runs'][0]:.4f}, {r['ms_runs'][1]:.4f}; graph replays; "
                  f"{r['us_per_step']:.3f} us per lattice step), plain "
                  f"{r['plain_ms']:.3f} ms (runs {r['plain_ms_runs'][0]:.3f}, "
                  f"{r['plain_ms_runs'][1]:.3f}), bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), F.log_softmax+F.ctc_loss {r['library_ms']:.3f} ms; "
                  f"device launches per call: {split}; plan {r['plan']['route']} "
                  f"K={r['plan']['lanes_per_thread']} warps={r['plan']['chain_warps']}  [{gpu}]",
                  flush=True)
    result = out[U]
    for name in kernels:
        result[name]["long"] = out[U_LONG][name]
    return result


def ls100_ctc_task():
    """configs/ls100_ctc.yml at full width, built in code (no yaml on the card)."""
    exp = experiment_from_dict(LS100_CTC)
    return exp.ctc_task(len(CHAR_UNITS))


def frames_out(task, samples: int) -> int:
    """Model frames of ``samples`` of audio: 10 ms frames of 25 ms, then the
    stacking's skip (the CTC models here have no pyramid and no VGG)."""
    return -(-(1 + (samples - 400) // 160) // task.num_skip)


def check_model(task, model_cpu, model_dev, dev, name: str = "ls100_ctc") -> None:
    """Logits and ids on the card against the plain path on the CPU, short
    input; a MoE encoder's load-balance term and a multitask model's sub
    head too."""
    rng = np.random.RandomState(1)
    wav = (rng.randn(2, SR) * 0.1).astype(np.float32)
    lens = np.asarray([SR, 9600], np.int32)
    wav[1, 9600:] = 0.0
    outs = []
    for model, device in ((model_cpu, torch.device("cpu")), (model_dev, dev)):
        with torch.inference_mode():
            feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(device),
                                        "input_len": torch.from_numpy(lens).to(device)})
            out = model(feats, fl)
            ids, n = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
        sub = out.logits[..., :0] if out.sub_logits is None else out.sub_logits
        outs.append((torch.cat([out.logits, sub], -1).cpu(), out.logit_len.cpu(), ids.cpu(),
                     n.cpu(), None if out.aux_loss is None else float(out.aux_loss)))
    (lc, lenc, idc, nc, ac), (lg, leng, idg, ng, ag) = outs
    classes = task.model.vocab_with_blank + (task.model.num_classes_sub or -1) + 1
    if lg.shape != (2, frames_out(task, SR), classes) or not bool(torch.isfinite(lg).all()):
        raise RuntimeError(f"logits {tuple(lg.shape)} are misshapen or not finite")
    err = float((lc - lg).abs().max())
    aux_err = None if ac is None else abs(ac - ag) / abs(ac)
    print(f"{name} on the card vs the CPU plain path, 2 x 1 s: logits "
          f"{'(main and sub heads) ' if task.model.num_classes_sub else ''}max abs err {err:.3e} "
          f"(tolerance {MODEL_ATOL:g}), ids equal: {torch.equal(idc, idg)}"
          + ("" if ac is None else f", moe_aux {ag:.6f} vs {ac:.6f} (rel err {aux_err:.2e}, "
             f"tolerance {LOSS_RTOL:g})"), flush=True)
    if not err <= MODEL_ATOL or not torch.equal(lenc, leng):
        raise RuntimeError(f"{name} on the card disagrees with the CPU: {err}")
    if (ac is None) != (ag is None) or (aux_err is not None and not aux_err <= LOSS_RTOL):
        raise RuntimeError(f"{name}'s moe_aux on the card disagrees with the CPU: {ag} vs {ac}")
    if not (torch.equal(idc, idg) and torch.equal(nc, ng)):
        raise RuntimeError("decoded ids on the card differ from the CPU")


def train_batch(n_rows: int, seconds: float, seed: int, max_labels: int) -> dict:
    """Seeded waveforms (the last rows shorter) and ragged character labels."""
    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    wav = (rng.randn(n_rows, n) * 0.1).astype(np.float32)
    input_len = np.full((n_rows,), n, np.int32)
    input_len[n_rows // 2:] = rng.randint(n // 2, n + 1, n_rows - n_rows // 2)
    for i, m in enumerate(input_len):
        wav[i, m:] = 0.0
    label_len = rng.randint(1, max_labels + 1, n_rows).astype(np.int32)
    labels = np.full((n_rows, max_labels), -1, np.int32)
    for i, m in enumerate(label_len):
        labels[i, :m] = rng.randint(0, len(CHAR_UNITS), m)
    return {"inputs": wav, "input_len": input_len, "labels": labels, "label_len": label_len,
            "weight": np.ones((n_rows,), np.float32)}


def zero_gradient(task, name: str) -> bool:
    """Whether the weight ``name`` has a zero gradient in exact arithmetic: a
    conformer's key bias unless keys are rotated (it shifts each row of
    scores by one constant, which the softmax ignores)."""
    enc = task.model.encoder
    return (enc.encoder_type in ("conformer", "transformer") and enc.pos_encoding != "rotary"
            and name.endswith("mhsa.k.b"))


@contextlib.contextmanager
def pool_decisions(decisions: list, replay: bool, flips: list):
    """Record each ``F.max_pool2d``'s argmax and each ``torch.relu``'s signs
    (``replay`` false), or route each pool through the recorded argmax and
    each ReLU through the recorded signs, counting in ``flips`` the windows
    and units whose own decision differs (``replay`` true). A VGG or
    ``cnn_zhang`` encoder's pools and ReLUs then send their gradient through
    the same elements on both devices: a near-tie (values within the
    forward's 1e-6, or a conv output that near 0) may resolve differently on
    the card and the CPU, and move a conv weight's gradient by a whole
    position's term."""
    plain, plain_relu = F.max_pool2d, torch.relu

    def pool(x, *args, **kw):
        out, idx = plain(x, *args, return_indices=True, **kw)
        if not replay:
            decisions.append(idx.cpu())
            return out
        want = decisions.pop(0).to(x.device)
        flips.append(int((want != idx).sum()))
        return x.flatten(2).gather(2, want.flatten(2)).view(want.shape)

    def relu(x):
        if not replay:
            decisions.append((x > 0).cpu())
            return plain_relu(x)
        want = decisions.pop(0).to(x.device)
        flips.append(int((want != (x > 0)).sum()))
        return torch.where(want, x, 0.0)

    F.max_pool2d, torch.relu = pool, relu
    try:
        yield
    finally:
        F.max_pool2d, torch.relu = plain, plain_relu


def check_train_step(task, task_mod, params_cpu, dev, seed: int = 6,
                     max_labels: int = 12) -> None:
    """One full-width train step of ``task_mod`` with dropout off, card against
    CPU: the loss and each term of it, every gradient, the weights after one
    SGD step, and the ids the eval step decodes after it. The CPU takes the
    card's max-pool decisions (``pool_decisions``)."""
    batch = train_batch(2, 1.0, seed=seed, max_labels=max_labels)
    opt = build_optimizer("sgd", 5.0)
    step, evaluate = task_mod.make_train_step(task, opt), task_mod.make_eval_step(task)
    res, decisions, flips = [], [], []
    for replay, device in ((False, dev), (True, torch.device("cpu"))):
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params = {k: v.to(device) for k, v in params_cpu.items()}
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with pool_decisions(decisions, replay, flips):
            loss, terms = task_mod.forward_loss(leaves, task, tb, True)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            new, _, aux = step(params, opt.init(params), tb, 0.1)
            ids, n, _ = evaluate(new, tb)
        res.append(({k: float(v.detach()) for k, v in terms.items()}, [g.cpu() for g in grads],
                    {k: v.cpu() for k, v in new.items()}, ids.cpu(), n.cpu(),
                    bool(aux["nonfinite"])))
    (tg, gg, pg, ig, ng, fg), (tc, gc, pc, ic, nc, fc) = res
    pools = task.model.encoder.has_vgg or task.model.encoder.is_cnn
    if decisions or (flips and not pools):
        raise RuntimeError(f"max-pool decisions left over: {len(decisions)}, flips {flips}")
    if flips:
        print(f"max-pools and ReLUs replayed on the CPU: {len(flips)} calls, {sum(flips)} "
              "windows or units whose CPU decision differs from the card's", flush=True)
    lc, lg = tc["loss"], tg["loss"]
    loss_err = max(abs(tc[k] - tg[k]) / abs(tc[k]) for k in tc)
    g_max = max(float(g.abs().max()) for g in gc)
    errs, cancelled = {}, {}
    for name, a, b in zip(params_cpu, gc, gg):
        if zero_gradient(task, name):  # both sides' rounding noise, held near 0
            cancelled[name] = max(float(a.abs().max()), float(b.abs().max())) / g_max
        else:
            errs[name] = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-12)
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    param_err = max(float((pc[k] - pg[k]).abs().max()) for k in pc)
    print(f"train step on the card vs the CPU, 2 x 1 s, SGD lr 0.1: loss {lg:.4f} vs {lc:.4f}, "
          + ", ".join(f"{k} {tg[k]:.4f} vs {tc[k]:.4f}" for k in tc if k != "loss")
          + f" (max rel err {loss_err:.2e}, tolerance {LOSS_RTOL:g}); grads max err / max |g| "
          f"{grad_err:.2e} ({worst}; tolerance {GRAD_RTOL:g}) over {len(errs)} tensors"
          + (f", {len(cancelled)} gradients zero in exact arithmetic at most "
             f"{max(cancelled.values()):.2e} of the largest entry (tolerance "
             f"{CANCELLED_RTOL:g})" if cancelled else "")
          + f"; weights after the step max abs err {param_err:.3e}; ids after the step equal: "
          f"{torch.equal(ic, ig) and torch.equal(nc, ng)}", flush=True)
    if fc or fg or not (loss_err <= LOSS_RTOL and grad_err <= GRAD_RTOL):
        raise RuntimeError("the train step on the card disagrees with the CPU")
    if cancelled and not max(cancelled.values()) <= CANCELLED_RTOL:
        raise RuntimeError(f"gradients that are zero in exact arithmetic are not: {cancelled}")
    if not param_err <= 0.1 * GRAD_RTOL * max(float(g.abs().max()) for g in gc):
        raise RuntimeError(f"weights after the step disagree: {param_err}")
    if not (torch.equal(ic, ig) and torch.equal(nc, ng)):
        raise RuntimeError("ids decoded after the step differ between the card and the CPU")


def time_phases(task, model, dev, gpu: str, name: str = "ls100_ctc",
                encoder: str = f"{LAYERS} x BLSTM-{H}", seconds: float = 12.0) -> None:
    """Frontend, encoder and head + greedy decode on 8 x ``seconds``."""
    rng = np.random.RandomState(2)
    n = int(seconds * SR)
    wav = torch.from_numpy((rng.randn(B, n) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((B,), n, dtype=torch.int64, device=dev)
    t_out = frames_out(task, n)
    with torch.inference_mode():
        batch = {"inputs": wav, "input_len": lens}
        feats, fl = device_pipeline(task, batch)
        enc, el, *_ = model.encoder(feats, fl)
        if feats.shape != (B, t_out, task.input_dim) or enc.shape != (
                B, t_out, task.model.encoder.output_dim):
            raise RuntimeError(f"unexpected shapes {tuple(feats.shape)} {tuple(enc.shape)}")

        def head_decode():
            logits = model.project(enc)
            return ctc_greedy_decode(logits, el, task.model.blank_id)

        times = {
            "frontend+stacking": host_ms(lambda: device_pipeline(task, batch), 5),
            f"encoder ({encoder})": host_ms(lambda: model.encoder(feats, fl), 3),
            "head+greedy decode": host_ms(head_decode, 5),
        }
    for phase, ms in times.items():
        print(f"phase {name} {phase}: {ms:.3f} ms per batch of {B} x {seconds:g} s (T'={t_out})"
              f"  [{gpu}]", flush=True)


# ---- phases 56-60: exported artifacts, and streaming at bfloat16 -------------------

EXPORT_FRAMES = 1200  # the data_root artifact's padded input: 12 s of 10 ms frames
ARTIFACT_SECONDS = (12.0, 11.0, 9.5, 8.0, 6.0, 4.0, 2.5, 1.0)
SESSION_SECONDS = (4.0, 3.8, 3.2, 2.9, 2.0, 1.6, 1.1, 0.6)  # the streaming artifact's sessions
BF16_STREAM_SECONDS = (4.0, 3.55, 3.0, 2.53, 2.0, 1.47, 1.0, 0.52)
# #3 with bf16 products against its plain version over a chunk: an h whose
# float32 sums ran in another order may round to the other bf16 neighbour (one
# bf16 ulp, up to 2^-8 |h|) and move the next step's gates by that times |Wh|
# (seen: 5.6e-4 at ls_streaming_ctc's chunk). One step (operands h0 and Wh,
# inputs rounded alike on both sides) keeps KERNEL_ATOL.
CARRY_BF16_TOL = dict(atol=1e-3, rtol=1e-3)
# one bf16 chunk step's encoder outputs, card kernels against the card's plain
# walk from the same state, of their largest entry: CARRY_BF16_TOL through 4 layers
STREAM_BF16_RTOL = 5e-3


def export_data_root(dev, gpu: str, work: Path) -> dict:
    """Phase 56: ``bin/export --frames`` of phase 54's ls100_ctc ``data_root``
    model on the card, then ``bin/serve ARTIFACT`` (``make_artifact_server``)
    answering 8 feature requests of the prepared dev_clean utterances: ids
    equal the in-process ``infer`` on the card, exactly 5 #1 launches per
    batch and nothing else; artifact size, load, warmup and first-request
    latency."""
    model_dir, out = work / "ls100_ctc_data_root", work / "ls100_ctc_data_root.art"
    _, counts = run_cli(
        f"bin/export ls100_ctc data_root --frames {EXPORT_FRAMES} --selfcheck", export_cli.main,
        [str(model_dir), str(out), "--batch", str(B), "--frames", str(EXPORT_FRAMES),
         "--selfcheck", "--device", "cuda"], ("lstm_bidi_fwd",), gpu)
    if counts["lstm_bidi_fwd"] != LAYERS:
        raise RuntimeError(f"bin/export --selfcheck launched {counts}")
    meta = json.loads(out.with_suffix(".art.json").read_text())
    feats = [np.load(f) for f in sorted((work / "data_utterance" / "dev_clean" / "feats")
                                        .glob("*.npy"))[:B]]
    if meta["input_rank"] != 3 or meta["feature_dim"] != feats[0].shape[1]:
        raise RuntimeError(f"the data_root artifact's contract {meta}")
    # the in-process infer on the card, from the model dir
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    task, _ = build_task(exp, corpus_tokenizer(exp), feats[0].shape[1])
    _, model = eval_cli.restore_model(model_dir, task, ctc_task, None, dev)
    batch = np.zeros((B, EXPORT_FRAMES, feats[0].shape[1]), np.float32)
    lens = np.asarray([min(len(f), EXPORT_FRAMES) for f in feats], np.int32)
    for i, f in enumerate(feats):
        batch[i, : lens[i]] = f[: lens[i]]
    ids, n = build_inference_fn(task, model)(batch, lens)
    want = [ids[i, : n[i]].tolist() for i in range(B)]
    params = sum(v.numel() for v in model.state_dict().values())
    del model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server = make_artifact_server(out, dev, port=0, max_wait_ms=50.0)
    up_s = time.perf_counter() - t0
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    results = [None] * B

    def request(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t1 = time.perf_counter()
        conn.request("POST", "/recognize", json.dumps({"features": feats[i].tolist()}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        results[i] = (resp.status, json.loads(resp.read()), (time.perf_counter() - t1) * 1e3)
        conn.close()

    try:
        request(0)  # the first request, alone
        first = results[0]
        reset_counts()
        server.batcher.batches_run = 0
        threads = [threading.Thread(target=request, args=(i,)) for i in range(B)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        counts, batches = read_counts(), server.batcher.batches_run
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    if any(r is None or r[0] != 200 for r in results) or first[0] != 200:
        raise RuntimeError(f"a features request failed: {[r and r[:2] for r in results]}")
    got = [r[1]["ids"] for r in results]
    lat = sorted(r[2] for r in results)
    size = out.stat().st_size
    print(f"phase bin/serve ARTIFACT ls100_ctc data_root ({params} parameters, artifact "
          f"{size / 1e6:.1f} MB + {out.with_suffix('.art.json').stat().st_size} B contract): "
          f"load + warmup {up_s:.2f} s, first request {first[2]:.1f} ms; {B} concurrent feature "
          f"requests in {batches} batch(es), p50 {lat[B // 2]:.1f} ms, max {lat[-1]:.1f} ms; "
          f"ids equal the in-process infer on the card: {got == want}; launches {counts}  "
          f"[{gpu}]", flush=True)
    if got != want or batches < 1 or counts != dict(NONE_LAUNCHED,
                                                    lstm_bidi_fwd=LAYERS * batches):
        raise RuntimeError(f"the data_root artifact served {got} vs {want}, launches {counts} "
                           f"over {batches} batch(es)")
    return {"counts": counts, "numbers": {
        "params": params, "artifact_bytes": size, "load_and_warmup_s": up_s,
        "first_request_ms": first[2], "p50_ms": lat[B // 2], "max_ms": lat[-1],
        "batches": batches}}


def export_and_hold(name: str, raw: dict, task, model, beam: int, dev, gpu: str, work: Path,
                    launched: tuple) -> dict:
    """Phase 57, one model: ``export_model`` of the card ``model``, loaded back
    with ``load_exported`` on the card; 8 x 12 s padded (ragged to 1 s)
    decoded through the artifact and in process: ids, lengths and launch
    counts equal, each kernel of ``launched`` launched and no other."""
    t0 = time.perf_counter()
    path = export_model(task, model, work / f"{name}.art", B, int(12 * SR), beam_width=beam,
                        units=CHAR_UNITS, label_type="character",
                        experiment=experiment_from_dict(raw), platforms=(dev.type,),
                        extra_meta={"model_type": raw["model_type"], "sample_rate": SR})
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    infer = load_exported(path, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    wav, lens = stream_audio(ARTIFACT_SECONDS, seed=71)
    runs = {}
    for what, fn in (("artifact", infer), ("in-process", build_inference_fn(task, model, beam))):
        reset_counts()
        t0 = time.perf_counter()
        ids, n = fn(wav, lens)
        torch.cuda.synchronize()
        runs[what] = (ids.cpu(), n.cpu(), read_counts(), (time.perf_counter() - t0) * 1e3)
    (ids, n, counts, ms), (w_ids, w_n, w_counts, w_ms) = runs["artifact"], runs["in-process"]
    same = torch.equal(ids, w_ids) and torch.equal(n, w_n)
    print(f"phase {name} artifact (beam {beam}, {path.stat().st_size / 1e6:.1f} MB): export "
          f"{export_s:.2f} s, load {load_s:.2f} s; {B} x 12 s: artifact {ms:.1f} ms, in-process "
          f"{w_ms:.1f} ms (first calls); ids and lengths equal the in-process serving: {same}; "
          f"lengths {n.tolist()}; launches {counts}  [{gpu}]", flush=True)
    if not same or counts != w_counts or min(counts[k] for k in launched) < 1 or any(
            counts[k] for k in COUNTERS if k not in launched):
        raise RuntimeError(f"{name}: the artifact disagrees with in-process serving "
                           f"(ids equal {same}, launches {counts} vs {w_counts})")
    return {"counts": counts, "numbers": {"artifact_bytes": path.stat().st_size,
                                          "export_s": export_s, "load_s": load_s,
                                          "artifact_ms": ms, "in_process_ms": w_ms}}


def serve_stream_artifact(dev, gpu: str, work: Path) -> tuple:
    """Phase 58: ls_streaming_ctc exported as a streaming artifact at beam 8
    (``export_streaming_model``) and served by ``bin/serve ARTIFACT``'s session
    API: 8 concurrent sessions posting their audio in 100 ms posts; each
    ``/stream/end`` gives the finalized beam ("final": true), equal to the
    in-process stream's ``finalize``; exactly 4 ``lstm_layer_fwd_carry``
    launches per step and nothing else."""
    raw, task, units, _, model = stream_models("ls_streaming_ctc", dev)
    path = export_streaming_model(task, model, work / "ls_streaming_ctc.art", B, STREAM_CHUNK,
                                  units=units, label_type="character",
                                  experiment=experiment_from_dict(raw), platforms=(dev.type,),
                                  beam_width=BEAM)
    wav, lens = stream_audio(SESSION_SECONDS, seed=72)
    fns = streaming.build_streaming_fn(task, model, STREAM_CHUNK, beam_width=BEAM)
    state, live, _ = stream_rows(fns, wav, lens)
    pref, flen, _ = (x.cpu() for x in fns[2](state))
    want = [pref[i, 0, : flen[i, 0]].tolist() for i in range(B)]
    del model
    t0 = time.perf_counter()
    server = make_artifact_server(path, dev, port=0, max_wait_ms=2.0)
    up_s = time.perf_counter() - t0
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    finals, partials, errors = [None] * B, [None] * B, []

    def post(path_, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", path_, body, {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
        conn.close()
        return out

    def session(i, sid):
        try:
            got = []
            for k in range(-(-lens[i] // STREAM_CHUNK)):
                status, body = post(f"/stream/audio?session={sid}",
                                    wav[i, k * STREAM_CHUNK: min((k + 1) * STREAM_CHUNK,
                                                                 lens[i])].tobytes())
                if status != 200:
                    raise RuntimeError(f"/stream/audio returned {status}: {body}")
                got += body["ids"]
            status, body = post(f"/stream/end?session={sid}")
            if status != 200 or not body.get("final"):
                raise RuntimeError(f"/stream/end returned {status}: {body}")
            partials[i], finals[i] = got, body["ids"]
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread below
            errors.append(e)

    try:
        reset_counts()
        server.batcher.steps_run = 0
        sids = [post("/stream/start")[1]["session"] for _ in range(B)]
        threads = [threading.Thread(target=session, args=(i, sid)) for i, sid in enumerate(sids)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts, steps = read_counts(), server.batcher.steps_run
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"a streaming artifact session failed: {errors}")
    # the live greedy partials delivered before /stream/end: a prefix of the stream's
    partials_ok = all(r[: len(p)] == p for r, p in zip(live, partials))
    print(f"phase bin/serve ARTIFACT ls_streaming_ctc streaming beam {BEAM} "
          f"({path.stat().st_size / 1e6:.1f} MB): load + warmup {up_s:.2f} s; {B} concurrent "
          f"sessions of up to {max(SESSION_SECONDS):g} s posted as fast as answered "
          f"({wall:.2f} s wall, {steps} steps, {wall * 1e3 / max(steps, 1):.2f} ms per step): "
          f"final beams equal the in-process stream's: {finals == want}; the live greedy "
          f"partials a prefix of its greedy tokens: {partials_ok}; launches {counts}  [{gpu}]",
          flush=True)
    if finals != want or not partials_ok or counts != dict(NONE_LAUNCHED,
                                                          lstm_layer_fwd=4 * steps):
        raise RuntimeError(f"the streaming artifact served {finals} vs {want}, launches "
                           f"{counts} over {steps} steps")
    return counts, {"artifact_bytes": path.stat().st_size, "load_and_warmup_s": up_s,
                    "wall_s": wall, "steps": steps}


def run_export(args, dev, gpu: str, work: Path, t0: float) -> tuple:
    """Phases 56-58; returns (launch counts by path, numbers)."""
    counts, numbers = {}, {}
    r = export_data_root(dev, gpu, work)
    counts["artifact_data_root_serving"], numbers["ls100_ctc_data_root"] = (r["counts"],
                                                                            r["numbers"])
    clock("the ls100_ctc data_root model exported and served", t0)
    att = ls960_joint_task()
    att_model = att_task.init_model(att, torch.Generator().manual_seed(0)).to(dev).eval()
    r = export_and_hold("ls960_joint", LS960_JOINT, att, att_model, BEAM, dev, gpu, work,
                        ("lstm_bidi_fwd", "location_attend"))
    counts["artifact_att_beam"], numbers["ls960_joint_beam8"] = r["counts"], r["numbers"]
    del att_model
    tr = ls_transducer_task()
    tr_model = transducer_task.init_model(tr, torch.Generator().manual_seed(0)).to(dev).eval()
    r = export_and_hold("ls_transducer", LS_TRANSDUCER, tr, tr_model, 1, dev, gpu, work,
                        ("lstm_layer_fwd",))
    counts["artifact_transducer"], numbers["ls_transducer_greedy"] = r["counts"], r["numbers"]
    del tr_model
    clock("ls960_joint and ls_transducer artifacts held against in-process serving", t0)
    counts["artifact_stream_serving"], numbers["ls_streaming_ctc_stream_beam8"] = (
        serve_stream_artifact(dev, gpu, work))
    clock("the ls_streaming_ctc streaming artifact served", t0)
    return counts, numbers


def check_carry_bf16_kernel(dev, gpu: str) -> dict:
    """Phase 59: #3's carried walk with bf16 products (``lstm_layer_fwd_carry_bf16``)
    at both streaming chunk shapes against its plain version, from a random
    (h0, c0) with lengths 0..T (a row at 0 gives back h0 and c0 bit for bit),
    one step held to KERNEL_ATOL; timed from graph replays beside the float32
    carried walk and cuDNN's bf16 ``nn.LSTM`` with (h0, c0). Its bound is the
    float32 carried walk's: the same bytes and operations."""
    out = {}
    for name, (t, d) in CARRY_SHAPES.items():
        lengths = [t, 0, t, t - 1, 3, t, 1, 0]
        args, xs, _ = layer_inputs(dev, B, lengths, seed=80 + t, t=t, d=d)
        g = torch.Generator().manual_seed(81 + t)
        state = tuple((torch.randn(B, H, generator=g) * 0.5).to(dev) for _ in range(2))

        def kernel(args=args, state=state):
            ys, (h_t, c_t) = lstm.lstm_layer(*args, initial_state=state, bf16_product=True)
            return ys, h_t, c_t

        def float32(args=args, state=state):
            return lstm.lstm_layer(*args, initial_state=state)

        plain = lambda: lstm.lstm_layer_fwd_plain(  # noqa: E731
            *args, initial_state=state, bf16_product=True)
        torch.manual_seed(82)
        net = torch.nn.LSTM(d, H, batch_first=True).to(dev, torch.bfloat16)
        xs16 = xs.to(torch.bfloat16)
        state16 = tuple(x.to(torch.bfloat16)[None] for x in state)
        cudnn = lambda: net(xs16, state16)  # noqa: E731
        shape = f"B={B} T={t} D={d} H={H}"
        with torch.no_grad():
            lstm.lstm_layer.launches_bf16_product = 0
            ys, h_t, c_t = kernel()
            torch.cuda.synchronize()
            if lstm.lstm_layer.launches_bf16_product != 1:
                raise RuntimeError("lstm_layer_fwd_carry_bf16 was not launched")
            want_ys, _, (want_h, want_c) = plain()
            err = check(f"lstm_layer_fwd_carry_bf16 ({name} chunk) {shape}", [ys, h_t, c_t],
                        [want_ys, want_h, want_c], **CARRY_BF16_TOL)
            one_args = (args[0][:, :1].contiguous(), args[1], args[2][:, :1].contiguous(),
                        args[3])
            one = lstm.lstm_layer(*one_args, initial_state=state, bf16_product=True)
            want_one = lstm.lstm_layer_fwd_plain(*one_args, initial_state=state,
                                                 bf16_product=True)
            one_err = check(f"lstm_layer_fwd_carry_bf16 ({name} chunk) one step", [one[0]],
                            [want_one[0]], KERNEL_ATOL)
            f_ys = float32()[0]
            versus_f32 = float((ys - f_ys).abs().max())
            paused = torch.tensor(lengths, device=dev) == 0
            if not (torch.equal(h_t[paused], state[0][paused])
                    and torch.equal(c_t[paused], state[1][paused]) and not ys[paused].any()):
                raise RuntimeError("lstm_layer_fwd_carry_bf16: a row with no valid step did not "
                                   "give back its (h0, c0) bit for bit")
            if not versus_f32 > 10 * one_err:
                raise RuntimeError(f"lstm_layer_fwd_carry_bf16 gives the float32 walk's outputs "
                                   f"({versus_f32:.2e} apart)")
            launches = device_launches(kernel)
            r = plain_kernel_ms(plain, kernel, 5, 50)
            graph = graph_ms(kernel, 50)
            float32_graph = graph_ms(float32, 50)
            library = cuda_ms(cudnn, 50)
            library_graph = graph_ms(cudnn, 50)
            extras = forward_extras(f"lstm_layer_fwd_carry_bf16 ({name} chunk)", kernel, 1, B,
                                    dev, {"ms": graph}, t)
        out[name] = dict(r, ms=graph, eager_ms=r["ms"], max_abs_err=err, one_step_err=one_err,
                         versus_float32_walk=versus_f32, float32_ms=float32_graph,
                         library_ms=library, library_graph_ms=library_graph,
                         device_launches=launches, shape=shape, **extras,
                         **carry_work(lengths, t, d))
        print(f"phase lstm_layer_fwd_carry_bf16 ({name} chunk) {shape}, lengths {lengths}: "
              f"kernel {graph * 1e3:.2f} us from graph replays ({graph * 1e3 / t:.2f} us per "
              f"step; eager CUDA events {r['ms'] * 1e3:.2f} us), the float32 carried walk "
              f"{float32_graph * 1e3:.2f} us, plain {r['plain_ms']:.3f} ms, bound "
              f"{out[name]['bound_ms'] * 1e3:.3f} us ({out[name]['bound_by']}), cuDNN bf16 "
              f"nn.LSTM with (h0, c0), all T steps: {library * 1e3:.2f} us eager, "
              f"{library_graph * 1e3:.2f} us from graph replays; outputs {versus_f32:.2e} from "
              f"the float32 walk's; device launches per call "
              f"{ {k: (v['per_call'], round(v['us'], 2)) for k, v in launches.items()} }"
              f"  [{gpu}]", flush=True)
        walks = [v["per_call"] for k, v in launches.items() if "fwd_walk" in k]
        if walks != [1.0]:
            raise RuntimeError(f"lstm_layer_fwd_carry_bf16: device launches {launches}; "
                               "expected one fwd_walk per call")
    return out


@contextlib.contextmanager
def plain_walk():
    """``models/rnn.LSTM`` takes the plain carried walk on the card (the plain
    version of whichever walk it asks for)."""
    kernel_layer = rnn.lstm_layer

    def plain(xproj, wh, mask, forget_bias, initial_state=None, bf16_product=False):
        ys, _, final = lstm.lstm_layer_fwd_plain(xproj, wh, mask, forget_bias, initial_state,
                                                 bf16_product)
        return ys, final

    rnn.lstm_layer = plain
    try:
        yield
    finally:
        rnn.lstm_layer = kernel_layer


@contextlib.contextmanager
def recorded(model, is_ctc: bool):
    """Lists that fill as the model runs inside the block: the encoder's chunk
    outputs (the inputs of the CTC head or of the transducer's ``enc_proj``)
    and the decisions' logits (the CTC head's outputs, or each
    ``joint_logits`` of the transducer's greedy decode), in order."""
    enc, dec = [], []
    target = model.head if is_ctc else model.enc_proj

    def record(x):
        out = type(target).forward(target, x)
        enc.append(x.detach().clone())
        if is_ctc:
            dec.append(out.detach().clone())
        return out

    def record_joint(f_t, g_u):
        out = type(model).joint_logits(model, f_t, g_u)
        dec.append(out.detach().clone())
        return out

    target.forward = record
    if not is_ctc:
        model.joint_logits = record_joint
    try:
        yield enc, dec
    finally:
        del target.forward
        if not is_ctc:
            del model.joint_logits


def top_gap(logits: torch.Tensor) -> torch.Tensor:
    """The gap between the largest and the second largest logit, per row or frame."""
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def parted_at_ties(is_ctc: bool, row: int, got, want) -> bool:
    """Whether a row's chunk decisions part only at near-ties (``want``'s
    top-two gap below BF16_LOGIT_ATOL): for CTC every frame whose argmax
    differs; for the transducer the first joint call whose argmax differs
    (later calls follow other prediction states)."""
    if is_ctc:
        g, w = got[0][row], want[0][row]
        differ = g.argmax(-1) != w.argmax(-1)
        return bool(differ.any()) and bool((top_gap(w)[differ] < BF16_LOGIT_ATOL).all())
    for g, w in zip(got, want):
        if int(g[row].argmax()) != int(w[row].argmax()):
            return float(top_gap(w[row])) < BF16_LOGIT_ATOL
    return False


def stream_against_plain(fns, model, is_ctc: bool, wav, lens) -> dict:
    """Drive a bf16 stream on the kernels, and run every chunk step a second
    time with the plain walk from the same state (teacher-forced: a bf16
    rounding that lands the other way compounds over a whole stream, so each
    step is held alone). Each step: the encoder outputs within
    STREAM_BF16_RTOL of their largest entry, and the tokens equal unless the
    decisions part at near-ties. Returns the kernels' rows, steps run, the
    worst encoder error and the rows that parted at ties."""
    init_fn, step_fn = fns[:2]
    b, c = wav.shape[0], STREAM_CHUNK
    n_chunks = -(-int(max(lens)) // c)
    with recorded(model, is_ctc) as (enc, dec):
        return teacher_forced(step_fn, init_fn(b), is_ctc, wav, lens, n_chunks, enc, dec)


def teacher_forced(step_fn, state, is_ctc: bool, wav, lens, n_chunks: int, enc: list,
                   dec: list) -> dict:
    """``stream_against_plain``'s loop over the chunks, with the recording lists."""
    b, c = wav.shape[0], STREAM_CHUNK
    rows, err, ties = [[] for _ in range(b)], 0.0, 0
    for k in range(n_chunks + 1):
        piece, cl = np.zeros((b, c), np.float32), np.zeros((b,), np.int32)
        for r in range(b):
            if k < n_chunks:
                piece[r] = wav[r, k * c: (k + 1) * c]
                cl[r] = min(max(lens[r] - k * c, 0), c)
            elif lens[r] % c == 0:
                cl[r] = -1
        enc.clear(), dec.clear()
        new_state, tok, n = step_fn(state, piece, cl)
        got_enc, got_dec = list(enc), list(dec)
        enc.clear(), dec.clear()
        with plain_walk():
            _, p_tok, p_n = step_fn(state, piece, cl)
        scale = float(enc[0].abs().max())
        if scale > 0:
            err = max(err, float((got_enc[0] - enc[0]).abs().max()) / scale)
        tok, n, p_tok, p_n = (x.cpu() for x in (tok, n, p_tok, p_n))
        for r in range(b):
            mine, plain = tok[r, : n[r]].tolist(), p_tok[r, : p_n[r]].tolist()
            if mine != plain:
                if not parted_at_ties(is_ctc, r, got_dec, dec):
                    raise RuntimeError(f"chunk {k} row {r}: the kernels' tokens {mine} differ from "
                                       f"the plain walk's {plain} away from a near-tie")
                ties += 1
            rows[r].extend(mine)
        state = new_state
    return {"rows": rows, "steps": n_chunks + 1, "encoder_rel_err": err, "tie_rows": ties}


def run_stream_bf16(dev, gpu: str, t0: float, float32: dict) -> tuple:
    """Phase 60: ls_streaming_ctc, ls_transducer, ls_streaming_conformer and
    ls_conformer_transducer at compute_dtype bfloat16 and full width, streamed
    on 8 x up to 4 s in 100 ms chunks: the LSTM configs launch exactly one
    bf16-product carried walk per layer and step (and nothing else; the
    conformers nothing); every chunk step held against the card's plain walk
    from the same state (``stream_against_plain``); the chunk step timed and
    profiled beside the float32 step of phases 37-40 (``float32``). Returns
    (launch counts by path, numbers)."""
    counts, numbers = {}, {}
    for name in STREAM_CONFIGS:
        raw, task, _, _, model = stream_models(name, dev, compute_dtype=BF16)
        is_ctc = isinstance(task, ctc_task.CTCTaskConfig)
        walks = raw["num_layers"] if raw["encoder_type"] == "lstm" else 0
        wav, lens = stream_audio(BF16_STREAM_SECONDS, seed=73)
        fns = streaming.build_streaming_fn(task, model, STREAM_CHUNK)
        reset_counts()
        r = stream_against_plain(fns, model, is_ctc, wav, lens)
        torch.cuda.synchronize()
        c = read_counts()
        print(f"phase {name} bf16 stream, {B} x up to {max(BF16_STREAM_SECONDS):g} s in 100 ms "
              f"chunks ({r['steps']} steps), each step against the card's plain walk from the "
              f"same state: encoder outputs max err {r['encoder_rel_err']:.2e} of their largest "
              f"entry (tolerance {STREAM_BF16_RTOL:g}), tokens equal but for "
              f"{r['tie_rows']} row-chunks that parted at near-ties (top-two gap below "
              f"{BF16_LOGIT_ATOL:g}); tokens per row {[len(x) for x in r['rows']]}; launches "
              f"{c}  [{gpu}]", flush=True)
        if c != dict(NONE_LAUNCHED, lstm_layer_fwd_carry_bf16=walks * r["steps"]):
            raise RuntimeError(f"{name} bf16 stream launches {c} over {r['steps']} steps")
        if not r["encoder_rel_err"] <= STREAM_BF16_RTOL or not any(r["rows"]):
            raise RuntimeError(f"{name}: the bf16 stream's encoder outputs are "
                               f"{r['encoder_rel_err']:.2e} off the plain walk's, or it "
                               "emitted nothing")
        counts[f"bf16_stream_{name}"] = c
        timed = time_stream_step(fns, wav, lens, dev, gpu, f"{name} bf16", walks,
                                 "lstm_layer_fwd_carry_bf16")
        f32 = float32[name]["greedy"]["step_ms"]
        print(f"{name} chunk step: bf16 {timed['step_ms']:.3f} ms, float32 (phases 37-40) "
              f"{f32:.3f} ms  [{gpu}]", flush=True)
        numbers[name] = dict(timed, float32_step_ms=f32, encoder_rel_err=r["encoder_rel_err"],
                             tie_rows=r["tie_rows"], tokens_per_row=[len(x) for x in r["rows"]])
        del model
        clock(f"{name} streamed at bf16", t0)
    return counts, numbers

def reset_counts() -> None:
    for c in COUNTERS.values():
        c.launches = 0


def read_counts() -> dict:
    return {k: c.launches for k, c in COUNTERS.items()}


def post_requests(task, model, seconds_list, seed: int, beam_width: int = 1,
                  units=CHAR_UNITS, label_type: str = "character") -> tuple:
    """Serve ``model`` through ``bin/serve.make_server`` and post one concurrent
    ``/recognize`` per entry of ``seconds_list``; the launch counts are reset
    just before the requests and read just after. Returns (responses as
    dicts, latencies in ms, launch counts, batches run, the /healthz body).
    """
    server = make_server(task, model, B, int(max(seconds_list) * SR), port=0,
                         max_wait_ms=50.0, warmup=True, units=units, label_type=label_type,
                         beam_width=beam_width)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.RandomState(seed)
    waves = [(rng.randn(int(s * SR)) * 0.1).astype(np.float32) for s in seconds_list]
    results = [None] * len(waves)

    def request(i):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/recognize", waves[i].tobytes(),
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        results[i] = (resp.status, resp.read(), (time.perf_counter() - t0) * 1e3)
        conn.close()

    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        reset_counts()
        server.batcher.batches_run = 0
        threads = [threading.Thread(target=request, args=(i,)) for i in range(len(waves))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        counts, batches = read_counts(), server.batcher.batches_run
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise RuntimeError("a request did not finish")
    for seconds, (status, body, _) in zip(seconds_list, results):
        if status != 200:
            raise RuntimeError(f"/recognize of {seconds} s returned {status}: {body[:200]!r}")
    return ([json.loads(r[1]) for r in results], sorted(r[2] for r in results), counts, batches,
            health)


def print_latency(what: str, responses, lat, batches: int, gpu: str) -> None:
    print(f"phase {what}: {len(lat)} concurrent requests in {batches} batch(es), "
          f"p50 {lat[len(lat) // 2]:.1f} ms, max {lat[-1]:.1f} ms  [{gpu}]", flush=True)
    print(f"responses: {[r['num_ids'] for r in responses]} ids", flush=True)


def serve_requests(task, model, gpu: str, name: str = "ls100_ctc",
                   per_batch: dict | None = None, seconds_list=REQUEST_SECONDS,
                   units=CHAR_UNITS, label_type: str = "character",
                   beam_width: int = 1) -> dict:
    """8 concurrent /recognize requests; returns the kernel launches they caused:
    ``per_batch`` for each batch (default: LAYERS of #1) and nothing else."""
    responses, lat, counts, batches, health = post_requests(
        task, model, seconds_list, seed=3, beam_width=beam_width, units=units,
        label_type=label_type)
    if health["beam_width"] != beam_width:
        raise RuntimeError(f"unexpected /healthz {health}")
    n_classes = task.model.num_classes
    for seconds, r in zip(seconds_list, responses):
        ids = r["ids"]
        frames = frames_out(task, int(seconds * SR))
        if (r["num_ids"] != len(ids) or len(ids) > frames
                or not all(isinstance(i, int) and 0 <= i < n_classes for i in ids)
                or r.get("text") is None or "truncated" in r):
            raise RuntimeError(f"malformed response for a {seconds} s request: {r}")
    print_latency(f"{name} request latency{f', beam {beam_width}' if beam_width > 1 else ''}",
                  responses, lat, batches, gpu)
    per_batch = {"lstm_bidi_fwd": LAYERS} if per_batch is None else per_batch
    want = dict(NONE_LAUNCHED, **{k: v * batches for k, v in per_batch.items()})
    print(f"{name} serving path launches: {counts}", flush=True)
    if batches < 1 or counts != want:
        raise RuntimeError(f"serving launches {counts} for {batches} batch(es); expected {want}")
    return counts


def time_train_steps(name: str, task, task_mod, params_cpu, dev, gpu: str,
                     profile_out: str | None, want: dict, walks: int,
                     steps: int = TIMED_STEPS, shape: str = f"T'={T_ENC}",
                     global_step: int | None = None, seconds: float = 12.0,
                     batch: dict | None = None, grad_accum: int = 1) -> dict:
    """Adam steps with the config's dropout at B=32 x 12 s (or on ``batch``),
    over ``grad_accum`` microbatches: time, rate, memory, launches (exactly
    ``want``), and a profile of one step by kernel, in which each LSTM walk
    (forward and backward) ran exactly ``walks`` device launches and no
    per-step forward kernel ran. An attention step takes ``global_step`` for
    its schedules. Returns the numbers."""
    if batch is None:
        batch = train_batch(B_TRAIN, seconds, seed=7, max_labels=U)
        batch["input_len"][:] = int(seconds * SR)  # one bucket: every row the same T
    rows = len(batch["input_len"])
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = {k: v.to(dev) for k, v in params_cpu.items()}
    opt = build_optimizer("adam", 5.0)
    state = opt.init(params)
    step = task_mod.make_train_step(task, opt, grad_accum=grad_accum)
    if global_step is not None:
        step = functools.partial(step, step=global_step)
    gen = torch.Generator(device=dev).manual_seed(1)
    params, state, aux = step(params, state, tb, 1e-3, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    params, state, aux = step(params, state, tb, 1e-3, gen)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if counts != want:
        raise RuntimeError(f"one {name} train step launched {counts}; expected {want}")
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, aux = step(params, state, tb, 1e-3, gen)
        losses.append(aux["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or bool(aux["nonfinite"]):
        raise RuntimeError(f"timed {name} train steps gave losses {losses}")
    print(f"phase {name} train step B={rows} x {seconds:g} s ({shape}, U={U}), Adam, "
          + (f"{grad_accum} microbatches, " if grad_accum > 1 else "") + "dropout keep "
          f"{task.model.encoder.dropout_keep_prob}: {ms:.3f} ms per step ({steps} steps), "
          f"{rows / ms * 1e3:.1f} utterances/s, peak memory {peak / 2**30:.3f} GiB, launches "
          f"per step {counts}, losses {[round(x, 3) for x in losses]}  [{gpu}]", flush=True)
    table = None if profile_out is None else Path(profile_out) / f"{name}_train_step_profile.txt"

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, tb, 1e-3, gen)

    # the tracer loses launches, never adds them (device_launches): a profile
    # with fewer walks than the step launched is read again, up to three steps
    for attempt in range(3):
        wall, busy, kernels = device_busy(one_step, table)
        device = {w: sum(n for key, _, n in kernels if w in key)
                  for w in ("fwd_walk", "bwd_walk")}
        per_step = sum(n for key, _, n in kernels if "fwd_step" in key)
        if min(device.values()) >= walks:
            break
        print(f"{name} train step profile {attempt + 1} recorded {device} walk launches; "
              "reading another step", flush=True)
    print(f"profile of one {name} train step: {wall:.3f} ms wall (profiled), {busy:.3f} ms of "
          f"device kernel time ({100 * busy / wall:.1f} % busy); top kernels by device time:",
          flush=True)
    for key, t, n in kernels[:12]:
        print(f"  {t:9.3f} ms  {n:6d} launches  {key[:90]}", flush=True)
    print(f"{name} train step device launches: {device}, per-step forward kernel {per_step}",
          flush=True)
    if device != {"fwd_walk": walks, "bwd_walk": walks} or per_step:
        raise RuntimeError(f"one {name} train step ran {device} and {per_step} per-step forward "
                           f"launches; expected {walks} of each walk and none")
    return {"ms": ms, "utts_per_sec": rows / ms * 1e3, "peak_gib": peak / 2**30,
            "launches": counts, "busy_share": busy / wall, "device_launches": device,
            "profile_wall_ms": wall, "device_ms": busy, "by_kind": kernel_kinds(kernels)}


KINDS = (("matmul (cuBLAS)", ("gemm", "cublas", "cutlass", "sm90_xmma", "splitk")),
         ("softmax", ("softmax",)), ("depthwise conv", ("conv", "depthwise", "implicit")),
         ("CTC (#5/#6)", ("ctc_",)), ("LSTM walks", ("_walk",)),
         ("reductions", ("reduce",)), ("copies and layout", ("copy", "cat", "transpose")))


def kernel_kinds(kernels) -> dict:
    """A profile's device ms and launches by kind of kernel (name keywords,
    first match; the rest are elementwise: masks, LayerNorm, activations,
    the optimizer)."""
    out = {}
    for key, t, n in kernels:
        low = key.lower()
        kind = next((k for k, words in KINDS if any(w in low for w in words)), "elementwise")
        ms, launches = out.get(kind, (0.0, 0))
        out[kind] = (ms + t, launches + n)
    return {k: {"ms": round(v[0], 3), "launches": v[1]}
            for k, v in sorted(out.items(), key=lambda kv: -kv[1][0])}


def train_one_epoch(name: str, raw: dict, gpu: str, launched: tuple, model_dir: Path) -> dict:
    """``fit`` on the config ``raw`` for one toy epoch into ``model_dir`` (the
    CLI phases read it later): the training path's launch counts. Each kernel
    in ``launched`` must run, and no other."""
    exp = experiment_from_dict(dict(raw, num_epoch=1))
    lines = []

    def log(s):
        lines.append(s)
        print(s, flush=True)

    reset_counts()
    t0 = time.perf_counter()
    summary = fit(exp, model_dir, log_every=1, print_fn=log, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    written = {f: (Path(model_dir) / f).exists() for f in
               ("summary.json", "metrics.csv", "config.yml", "checkpoints/epoch_0.pt")}
    losses = [float(s.split(" loss ")[1].split()[0]) for s in lines if " loss " in s]
    corpus = (f"data_root {Path(exp.data_root).name}" if exp.data_root
              else f"toy, {exp.toy_num_utts} utterances")
    print(f"phase fit {name} 1 epoch ({corpus}): {wall:.1f} s wall "
          f"(model init and data included), {summary['utts_per_sec']:.1f} training "
          f"utterances/s, {summary['steps']} steps, dev loss {summary['dev_loss']:.4f}, dev "
          f"error {summary['dev_error_rate']:.4f}, launches {counts}  [{gpu}]", flush=True)
    if (not losses or len(losses) != summary["steps"] or not all(np.isfinite(losses))
            or summary["nonfinite_steps"] != 0 or not np.isfinite(summary["dev_loss"])):
        raise RuntimeError(f"fit logged losses {losses} with summary {summary}")
    if not all(written.values()):
        raise RuntimeError(f"fit did not write its files: {written}")
    if any(counts[k] < 1 for k in launched) or any(counts[k] for k in COUNTERS
                                                   if k not in launched):
        raise RuntimeError(f"the {name} training path launched {counts}; expected {launched}")
    return counts


def attend_inputs(dev, n_utt: int, lengths, seed: int, group: int = 1, t=ATT_T, a=ATT_A,
                  he=ATT_HE, c=ATT_C, w=ATT_W):
    """One decoder step's read at the given shape for ``n_utt`` utterances of
    ``group`` rows each: keys, enc_out and mask per utterance, q and prev per
    row, alignments from a softmax, weights uniform in +-0.1 as the model
    draws them. Returns (the positional arguments, b)."""
    rng = np.random.RandomState(seed)
    n = n_utt * group
    logits = rng.randn(n, t).astype(np.float32)
    prev = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    arrays = [
        rng.randn(n_utt, t, a).astype(np.float32) * 0.5,  # keys = enc @ W_enc
        rng.randn(n_utt, t, he).astype(np.float32) * 0.3,  # enc_out
        rng.randn(n, a).astype(np.float32) * 0.5,  # q = dec_state @ W_dec
        prev.astype(np.float32),
        np.arange(t)[None, :] < np.asarray(lengths)[:, None],  # enc_mask
        ((rng.rand(w, 1, c) - 0.5) * 0.2).astype(np.float32),  # conv
        ((rng.rand(c, a) - 0.5) * 0.2).astype(np.float32),  # w_loc
        ((rng.rand(a) - 0.5) * 0.2).astype(np.float32),  # v
    ]
    b = torch.from_numpy(((rng.rand(a) - 0.5) * 0.2).astype(np.float32)).to(dev)
    return [torch.from_numpy(x).to(dev) for x in arrays], b


def tiled_attend_inputs(args, b, group: int) -> list:
    """The layout before grouped reads: keys + b formed outside the kernel
    and each utterance's keys, enc_out and mask repeated ``group`` times."""
    keys, enc, q, prev, mask = args[:5]
    return [(keys + b).repeat_interleave(group, dim=0), enc.repeat_interleave(group, dim=0), q,
            prev, mask.repeat_interleave(group, dim=0), *args[5:]]


def attend_work(lengths, group: int, t=ATT_T, a=ATT_A, he=ATT_HE, c=ATT_C, w=ATT_W,
                with_b: bool = True, counts: bool = False, keys: bool = True,
                enc_elem: int = F32):
    """Bytes and float32 operations one read needs on these inputs, for
    ``group`` rows per utterance of ``lengths``: per utterance the keys of its
    valid frames, the enc rows of its valid frames (every frame when it has
    none: its weights are 1/T; ``enc_elem`` bytes a value, 2 for bf16 rows)
    and its mask, once; per row prev and q in, align and ctx out; the shared
    weights (and b) once. Masked frames need no keys or enc row (their
    weight is 0)."""
    moved = ops = 0.0
    for length in lengths:
        frames = length if length > 0 else t
        moved += (length * a * F32 if keys else 0) + frames * he * enc_elem + t
        moved += group * ((t + a) * F32 + (t + he) * F32)
        # per row and valid frame: conv taps, location projection, score (add,
        # add, add, tanh, multiply-add), context; per row and frame: softmax
        ops += group * (length * (2 * w * c + 2 * c * a + 6 * a) + frames * 2 * he + 5 * t)
    moved += (w * c + c * a + a + (a if with_b else 0)) * F32
    return (moved, ops) if counts else bound(moved, ops)


def kernel_split(fn, reps: int = 20) -> dict:
    """Device µs per call of each kernel ``fn`` launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[1].split("::")[-1]: e.self_device_time_total / e.count
            for e in prof.key_averages() if e.self_device_time_total > 0}


def check_attention_kernel(dev, gpu: str) -> dict:
    """Kernel #7 against its plain version at the ls960_joint decoder's shapes:
    the beam's grouped call, the same data in the tiled layout, and the greedy call."""
    small, small_b = attend_inputs(dev, 3, [37, 5, 1], seed=9, t=37, a=16, he=12, c=4, w=10)
    got = attention.location_attend(*small, 1.5, b=small_b)
    want = attention.location_attend_plain(*small, 1.5, b=small_b)
    torch.cuda.synchronize()
    check("location_attend N=3 T=37 A=16 He=12 C=4 W=10 (even), sharpening 1.5: align",
          got[1:], want[1:], ATT_ALIGN_ATOL)
    check("location_attend small: ctx", got[:1], want[:1], ATT_CTX_ATOL)
    rng = np.random.RandomState(11)
    lengths = [ATT_T, 1, 0] + [int(x) for x in rng.randint(1, ATT_T + 1, B_ATT - 3)]
    beam_args, beam_b = attend_inputs(dev, B_ATT, lengths, seed=11, group=BEAM)
    rng = np.random.RandomState(10)
    greedy_lengths = [ATT_T, 1, 0] + [int(x) for x in rng.randint(1, ATT_T + 1, B_ATT - 3)]
    greedy_args, greedy_b = attend_inputs(dev, B_ATT, greedy_lengths, seed=10)
    # the beam's call now (8 utterances x 8 rows, each utterance read once),
    # the same data tiled as before this layout, and the greedy call
    calls = {
        "grouped": (beam_args, dict(b=beam_b, group=BEAM), lengths, BEAM, True),
        "tiled": (tiled_attend_inputs(beam_args, beam_b, BEAM), {},
                  [x for x in lengths for _ in range(BEAM)], 1, False),
        "n8": (greedy_args, dict(b=greedy_b), greedy_lengths, 1, True),
    }
    out = {}
    for name, (args, kw, lens, group, with_b) in calls.items():
        n = args[2].shape[0]
        got = attention.location_attend(*args, 1.0, **kw)
        want = attention.location_attend_plain(*args, 1.0, **kw)
        torch.cuda.synchronize()
        shape = (f"N={n} (G={group}, {len(lens)} encoder rows) T={ATT_T} A={ATT_A} He={ATT_HE} "
                 f"C={ATT_C} W={ATT_W}")
        err = max(check(f"location_attend {name} {shape}: align", got[1:], want[1:],
                        ATT_ALIGN_ATOL),
                  check(f"location_attend {name} {shape}: ctx", got[:1], want[:1], ATT_CTX_ATOL))
        for row, length in enumerate(x for x in lens for _ in range(group)):
            if length == 0 and not torch.allclose(got[1][row], torch.full((ATT_T,), 1.0 / ATT_T,
                                                                           device=dev)):
                raise RuntimeError(f"location_attend {name}: the length-0 row {row} is not 1/T")
        again = attention.location_attend(*args, 1.0, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
            raise RuntimeError(f"location_attend {name}: two calls differ")
        if name == "tiled" and not (torch.equal(got[0], out["grouped"]["ctx"])
                                    and torch.equal(got[1], out["grouped"]["align"])):
            raise RuntimeError("location_attend: the tiled call's bits differ from the grouped")
        plain = lambda: attention.location_attend_plain(*args, 1.0, **kw)  # noqa: E731
        kernel = lambda: attention.location_attend(*args, 1.0, **kw)  # noqa: E731
        # device time from graph replays (plain, kernel, kernel, plain); the
        # eager calls' time also holds the wrapper's host work
        p = [graph_ms(plain, 50)]
        k = [graph_ms(kernel, 50) for _ in range(2)]
        p.append(graph_ms(plain, 50))
        eager = cuda_ms(kernel, 200)
        split = kernel_split(kernel)
        r = out[name] = dict(ms=sum(k) / 2, plain_ms=sum(p) / 2, ms_runs=k, plain_ms_runs=p,
                             eager_ms=eager, max_abs_err=err, library_ms=None,
                             deterministic=True, split_us=split, ctx=got[0], align=got[1],
                             **attend_work(lens, group, with_b=with_b))
        print(f"phase location_attend {name} {shape}: kernel {r['ms'] * 1e3:.2f} us (runs "
              f"{k[0] * 1e3:.2f}, {k[1] * 1e3:.2f}; graph replay; "
              + ", ".join(f"{key} {us:.2f} us" for key, us in split.items())
              + f"), eager call {eager * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us (runs "
              f"{p[0] * 1e3:.2f}, {p[1] * 1e3:.2f}), bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}), no single library call, max abs err {err:.3e}, two calls "
              f"bitwise equal  [{gpu}]", flush=True)
    print(f"location_attend: the grouped beam call takes {out['grouped']['ms'] * 1e3:.2f} us, "
          f"the tiled one {out['tiled']['ms'] * 1e3:.2f} us "
          f"({out['tiled']['ms'] / out['grouped']['ms']:.2f}x; equal bits)  [{gpu}]", flush=True)
    res = out["grouped"]
    for name in ("n8", "tiled"):
        res[name] = {k: out[name][k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                               "bound_by", "max_abs_err", "split_us")}
    return res


def check_pyramidal_lstm(dev, gpu: str) -> dict:
    """Kernel #1 at the pyramidal encoder's first layer: B=8, T=1198, D=120."""
    rng = np.random.RandomState(12)
    lengths = [T_PYR, 1] + [int(x) for x in rng.randint(T_PYR // 2, T_PYR + 1, B_ATT - 2)]
    args, xs, lens = lstm_inputs(dev, B_ATT, lengths, seed=12, t=T_PYR, d=D_PYR)
    with torch.no_grad():
        got = lstm.lstm_bidi(*args)
        want = lstm.lstm_bidi_fwd_plain(*args)[:2]
        torch.cuda.synchronize()
        err = check(f"lstm_bidi_fwd (pyramidal layer 0) B={B_ATT} T={T_PYR} H={H}", got, want,
                    KERNEL_ATOL)
        kernel = lambda: lstm.lstm_bidi(*args)  # noqa: E731
        t = plain_kernel_ms(lambda: lstm.lstm_bidi_fwd_plain(*args), kernel, 1, 10)
        extras = forward_extras("lstm_bidi_fwd (pyramidal layer 0)", kernel, 2, B_ATT, dev, t,
                                T_PYR)
    lib_fwd, _ = cudnn_lstm(dev, xs, lens, seed=12)
    r = dict(t, max_abs_err=err, library_ms=cuda_ms(lib_fwd, 10), **extras,
             **lstm_work(lengths, H, with_cs=False, backward=False, t=T_PYR))
    print(f"phase lstm_bidi_fwd pyramidal B={B_ATT} T={T_PYR} D={D_PYR} H={H}: kernel "
          f"{r['ms']:.3f} ms (runs {r['ms_runs'][0]:.3f}, {r['ms_runs'][1]:.3f}; "
          f"{r['us_per_step']:.2f} us per step), plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), cuDNN "
          f"nn.LSTM forward {r['library_ms']:.3f} ms, max abs err {err:.3e}  [{gpu}]",
          flush=True)
    return r


def ls960_joint_task(**overrides):
    """configs/ls960_joint.yml at full width, built in code (no yaml on the card)."""
    return experiment_from_dict(dict(LS960_JOINT, **overrides)).att_task(len(CHAR_UNITS))


def check_attention_grad(dev, gpu: str) -> dict:
    """Kernel #7's gradient (``LocationAttend``) against autograd through the
    plain read on the card, at the greedy (N=8) and the beam's (N=64, G=8)
    shapes; the plain backward's time per call (eager, and its device time
    from the profiler) beside its bound."""
    out = {}
    names = ("keys", "enc_out", "q", "prev_align", "conv_w", "w_loc", "v", "b")
    for label, group, seed in (("n8", 1, 30), ("grouped", BEAM, 31)):
        rng = np.random.RandomState(seed)
        lengths = [ATT_T, 1, 0] + [int(x) for x in rng.randint(1, ATT_T + 1, B_ATT - 3)]
        args, b = attend_inputs(dev, B_ATT, lengths, seed=seed, group=group)
        n = B_ATT * group
        cts = [torch.from_numpy(rng.randn(n, x).astype(np.float32)).to(dev)
               for x in (args[1].shape[2], args[1].shape[1])]  # d ctx [N, He], d align [N, T]
        floats = (*args[:4], *args[5:], b)
        grads = []
        for fn in (attention.location_attend, attention.location_attend_plain):
            leaves = [x.clone().requires_grad_(True) for x in floats]
            before = attention.location_attend.launches
            outs = fn(*leaves[:4], args[4], *leaves[4:7], 1.0, b=leaves[7], group=group)
            grads.append(torch.autograd.grad(outs, leaves, cts))
            torch.cuda.synchronize()
            if attention.location_attend.launches - before != (fn is attention.location_attend):
                raise RuntimeError("LocationAttend did not launch #7 once for its forward")
        shape = (f"N={n} (G={group}) T={ATT_T} A={ATT_A} He={ATT_HE} C={ATT_C} W={ATT_W}")
        err = max(check(f"location_attend gradient {shape}: d{name}", [g], [w], ATT_GRAD_ATOL,
                        ATT_GRAD_ATOL) for name, g, w in zip(names, *grads))
        needs = (True,) * 8
        saved = (*args, b)
        bwd = lambda: attention.location_attend_bwd(saved, needs, 1.0, group, *cts)  # noqa: E731
        eager = cuda_ms(bwd, 20)
        _, device_ms, kernels = device_busy(bwd)
        # the VJP reads what the forward reads plus the two cotangents and
        # writes one gradient per input: about twice the forward's bytes and,
        # for its products, twice its operations
        moved, ops = attend_work(lengths, group, counts=True)
        launches = sum(n for _, _, n in kernels)
        r = out[label] = dict(max_abs_err=err, eager_ms=eager, device_ms=device_ms,
                              device_launches=launches, **bound(2 * moved, 2 * ops))
        print(f"phase location_attend backward {shape}: plain backward {eager:.3f} ms per call "
              f"eager, {device_ms:.3f} ms of device time in {launches} launches, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), gradients within "
              f"{err:.3e} of autograd through the plain read  [{gpu}]", flush=True)
    return out


def check_att_model(task, model_cpu, model_dev, dev, name: str = "ls960_joint",
                    beam: int = BEAM, t_enc: int | None = None, hold_beam: bool = True) -> None:
    """Encoder, CTC head, greedy and the beam on the card against the CPU plain
    path; ``t_enc``: the encoder frames of 1 s (ls960_joint's by default).
    ``hold_beam`` false reports the beam's agreement without holding it."""
    rng = np.random.RandomState(13)
    wav = (rng.randn(2, SR) * 0.1).astype(np.float32)
    lens = np.asarray([SR, 9600], np.int32)
    wav[1, 9600:] = 0.0
    outs = []
    for model, device in ((model_cpu, torch.device("cpu")), (model_dev, dev)):
        with torch.inference_mode():
            feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(device),
                                               "input_len": torch.from_numpy(lens).to(device)})
            enc = seq2seq.encode(model, feats, fl)
            greedy = seq2seq.greedy_decode(model, feats, fl, precomputed=enc)
            res = attention_beam_search(model, feats, fl, beam_width=beam, precomputed=enc)
        outs.append([x.cpu() for x in (enc.outputs, enc.ctc_logits, greedy.logits,
                                       greedy.predicted_ids, res.tokens, res.lengths,
                                       res.scores, enc.lengths)] + [greedy.steps, res.steps])
    (ec, cc, gc, ic, tc, lc, sc, nc, gsc, bsc), (eg, cg, gg, ig, tg, lg, sg, ng, gsg, bsg) = outs
    if t_enc is None:
        half = lambda x: -(-x // 2)  # noqa: E731  one pyramidal 2x reduction
        t_enc = half(half(1 + (SR - 400) // 160))
    cfg = task.model
    if eg.shape != (2, t_enc, cfg.encoder.output_dim) or cg.shape != (2, t_enc,
                                                                      cfg.num_classes + 1):
        raise RuntimeError(f"unexpected encoder shapes {tuple(eg.shape)} {tuple(cg.shape)}")
    errs = {"encoder outputs": float((ec - eg).abs().max()),
            "CTC logits": float((cc - cg).abs().max()),
            "greedy logits": float((gc - gg).abs().max()),
            f"beam-{beam} scores": float((sc - sg).abs().max())}
    same = {"encoder lengths": torch.equal(nc, ng), "greedy ids": torch.equal(ic, ig),
            f"beam-{beam} tokens": torch.equal(tc, tg), f"beam-{beam} lengths": torch.equal(lc, lg),
            "steps": (gsc, bsc) == (gsg, bsg)}
    print(f"{name} on the card vs the CPU plain path, 2 x 1 s: "
          + ", ".join(f"{k} max abs err {v:.3e}" for k, v in errs.items())
          + f" (tolerance {MODEL_ATOL:g}, beam scores {MODEL_ATOL:g} + {BEAM_SCORE_RTOL:g} x "
          "|score|); " + ", ".join(f"{k} equal: {v}" for k, v in same.items())
          + f"; greedy steps {gsg}, beam steps {bsg}, beam lengths {lg[:, 0].tolist()}",
          flush=True)
    if not all(bool(torch.isfinite(x).all()) for x in (eg, cg, gg, sg)):
        raise RuntimeError(f"{name} outputs on the card are not finite")
    score_ok = bool(((sc - sg).abs() <= MODEL_ATOL + BEAM_SCORE_RTOL * sc.abs()).all())
    if not hold_beam:
        score_ok = True
        same = {k: v for k, v in same.items() if "beam" not in k}
    if not all(v <= MODEL_ATOL for k, v in errs.items() if "scores" not in k) or not (
            score_ok and all(same.values())):
        raise RuntimeError(f"{name} on the card disagrees with the CPU: {errs} {same}")


def raw_device_kernels(prof) -> list:
    """(name, device ms, launches) of a finished profile's device events, read
    from the tracer's raw events without building the operator tree: the
    sums ``key_averages`` gives (``self_device_time_total`` and ``count`` per
    kernel name; equal on a 10 869-launch profile), in seconds instead of a
    minute for a step of 10^5 launches. "Command Buffer Full" is CUPTI's
    record of the host waiting on a full launch queue, not a kernel."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.name() == "Command Buffer Full":
            continue
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(k, ms, n) for k, (ms, n) in by_name.items() if ms > 0]


def device_busy(fn, table: Path | None = None) -> tuple:
    """(wall ms, device kernel ms, kernels by device time) of one profiled call
    of ``fn``; every kernel's line goes to ``table`` when given.

    Only the device is traced (no CPU operator events): a transducer train
    step launches about 170 k kernels, and reading their CPU-side events
    too took 50 s. A profile that recorded no kernel at all lost them (the
    tracer, as in ``device_launches``): ``fn`` runs again under a new one,
    up to five times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        kernels = sorted(raw_device_kernels(prof), key=lambda r: -r[1])
        print(f"(profile read in {time.perf_counter() - t0:.1f} s)", flush=True)
        if kernels:
            break
    if table is not None:
        table.parent.mkdir(parents=True, exist_ok=True)
        table.write_text("device ms, launches, kernel\n" + "".join(
            f"{t:10.3f} {n:7d}  {key}\n" for key, t, n in kernels))
    return wall, sum(r[1] for r in kernels), kernels


def time_att_phases(task, model, dev, gpu: str) -> None:
    """Frontend, encoder, greedy and beam-8 decode on 8 x 12 s; #7 launches per decode."""
    rng = np.random.RandomState(14)
    wav = torch.from_numpy((rng.randn(B_ATT, 12 * SR) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((B_ATT,), 12 * SR, dtype=torch.int64, device=dev)
    batch = {"inputs": wav, "input_len": lens}
    with torch.inference_mode():
        feats, fl = device_pipeline(task, batch)
        enc = seq2seq.encode(model, feats, fl)
        if feats.shape != (B_ATT, T_PYR, D_PYR) or enc.outputs.shape != (B_ATT, ATT_T, ATT_HE):
            raise RuntimeError(f"unexpected shapes {tuple(feats.shape)} "
                               f"{tuple(enc.outputs.shape)}")
        decodes = {
            "greedy decode": lambda: seq2seq.greedy_decode(model, feats, fl, precomputed=enc),
            f"beam-{BEAM} decode": lambda: attention_beam_search(model, feats, fl,
                                                                 beam_width=BEAM,
                                                                 precomputed=enc),
        }
        steps = {}
        for name, fn in decodes.items():
            torch.cuda.synchronize()
            before = attention.location_attend.launches
            steps[name] = fn().steps
            torch.cuda.synchronize()
            launches = attention.location_attend.launches - before
            if launches != steps[name]:
                raise RuntimeError(f"{name}: {launches} location_attend launches for "
                                   f"{steps[name]} decoder steps")
        times = {
            "frontend": host_ms(lambda: device_pipeline(task, batch), 5),
            f"encoder (5 x pyramidal BLSTM-512, T={T_PYR}->{ATT_T})":
                host_ms(lambda: seq2seq.encode(model, feats, fl), 3),
            **{name: host_ms(fn, 3) for name, fn in decodes.items()},
        }
        for name, ms in times.items():
            extra = ""
            if name in steps:
                extra = (f", {steps[name]} steps ({ms / steps[name]:.3f} ms per step), "
                         f"{steps[name]} location_attend launches")
            print(f"phase ls960_joint {name}: {ms:.3f} ms per batch of {B_ATT} x 12 s{extra}"
                  f"  [{gpu}]", flush=True)
        for name, fn in decodes.items():
            wall, busy, kernels = device_busy(fn)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(f"profile of one ls960_joint {name}: {wall:.3f} ms wall (profiled), "
                  f"{busy:.3f} ms of device kernel time ({100 * busy / wall:.1f} % busy), "
                  f"{peak:.1f} MiB of device memory above the encoder outputs; top kernels by "
                  "device time:", flush=True)
            for key, t, n in kernels[:6]:
                print(f"  {t:9.3f} ms  {n:6d} launches  {key[:90]}", flush=True)
        # the beam reads each utterance once: no operator of its decode takes
        # a tensor of the encoder output or keys repeated per beam
        tiled = [[B_ATT * BEAM, ATT_T, ATT_A], [B_ATT * BEAM, ATT_T, ATT_HE]]
        found = ops_on_shapes(decodes[f"beam-{BEAM} decode"], tiled)
        print(f"beam-{BEAM} decode: operators on a {tiled[0]} or {tiled[1]} tensor: {found}",
              flush=True)
        if found:
            raise RuntimeError(f"the beam decode still works on per-beam copies: {found}")


def ops_on_shapes(fn, shapes) -> list:
    """The operators of one call of ``fn`` that take a tensor of one of
    ``shapes`` (the profiler's record of CPU-side operator inputs)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages(group_by_input_shape=True)
                   if any(list(x) in shapes for x in e.input_shapes)})


def serve_att_requests(task, model, gpu: str, name: str = "ls960_joint", beam: int = BEAM,
                       layers: int = LAYERS, units=CHAR_UNITS,
                       label_type: str = "character", walk: str = "lstm_bidi_fwd",
                       read: str = "location_attend") -> dict:
    """8 concurrent /recognize requests at the beam; returns the launches they
    caused: ``layers`` of the ``walk`` counter per batch, one of the ``read``
    counter per decoder step (the bf16 entries' counters at bf16), and no
    other kernel."""
    responses, lat, counts, batches, health = post_requests(
        task, model, ATT_REQUEST_SECONDS, seed=15, beam_width=beam, units=units,
        label_type=label_type)
    if health["beam_width"] != beam or health["blank_id"] is not None:
        raise RuntimeError(f"unexpected /healthz {health}")
    cfg = task.model
    for seconds, r in zip(ATT_REQUEST_SECONDS, responses):
        ids = r["ids"]
        if (r["num_ids"] != len(ids) or len(ids) > cfg.max_decode_length
                or not all(isinstance(i, int) and 0 <= i < cfg.vocab and i != cfg.eos_id
                           for i in ids)
                or r.get("text") is None or "truncated" in r):
            raise RuntimeError(f"malformed response for a {seconds} s request: {r}")
    print_latency(f"{name} request latency, beam {beam}", responses, lat, batches, gpu)
    print(f"{name} attention serving path launches: {counts}", flush=True)
    k = seq2seq.decode_unroll_factor(cfg.max_decode_length)
    steps = counts[read]
    others = [n for n in COUNTERS if n not in (walk, read)]
    if (batches < 1 or counts[walk] != layers * batches or steps % k
            or not k * batches <= steps <= cfg.max_decode_length * batches
            or any(counts[n] for n in others)):
        raise RuntimeError(f"attention serving launches {counts} for {batches} batch(es)")
    return counts


def check_layer_kernels(dev, gpu: str) -> dict:
    """Kernels #3 (serving B=8; with ``cs`` at B=32) and #4 (B=32) against their
    plain versions, ``LSTMLayer``'s gradients against autograd through the plain
    forward; their bounds and the unidirectional cuDNN ``nn.LSTM``'s times."""
    lengths = [T_ENC, 1, 399, 250, 128, 7, 333, T_ENC]
    args, xs, lens = layer_inputs(dev, B, lengths, seed=20)
    with torch.no_grad():
        got = lstm.lstm_layer(*args)
        want = lstm.lstm_layer_fwd_plain(*args)[0]
        torch.cuda.synchronize()
        err = check(f"lstm_layer_fwd (serving) B={B} T={T_ENC} D={D_TR} H={H}", [got], [want],
                    KERNEL_ATOL)
        kernel = lambda: lstm.lstm_layer(*args)  # noqa: E731
        t = plain_kernel_ms(lambda: lstm.lstm_layer_fwd_plain(*args), kernel, 2, 20)
        extras = forward_extras("lstm_layer_fwd (serving)", kernel, 1, B, dev, t, T_ENC)
    lib_fwd, _ = cudnn_lstm(dev, xs, lens, seed=20, bidirectional=False)
    serving = dict(t, max_abs_err=err, library_ms=cuda_ms(lib_fwd, 10), **extras,
                   **lstm_work(lengths, H, with_cs=False, backward=False, dirs=1))

    rng = np.random.RandomState(21)
    lengths = [T_ENC, 1] + [int(x) for x in rng.randint(T_ENC // 2, T_ENC + 1, B_TRAIN - 2)]
    args, xs, lens = layer_inputs(dev, B_TRAIN, lengths, seed=21)
    gys = torch.from_numpy(rng.randn(B_TRAIN, T_ENC, H).astype(np.float32)).to(dev)
    fwd_k = lambda: lstm.lstm_layer_fwd(*args, with_cs=True)  # noqa: E731
    with torch.no_grad():
        got = fwd_k()
        want = lstm.lstm_layer_fwd_plain(*args)
        torch.cuda.synchronize()
        fwd_err = check(f"lstm_layer_fwd with cs B={B_TRAIN} T={T_ENC} H={H}", got, want,
                        KERNEL_ATOL)
        bwd_args = (*args[:3], *want, gys, args[3])
        got = lstm.lstm_layer_bwd(*bwd_args)
        want_dx = lstm.lstm_layer_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        bwd_err = check(f"lstm_layer_bwd B={B_TRAIN} T={T_ENC} H={H}", [got], [want_dx],
                        BWD_ATOL)
        tf = plain_kernel_ms(lambda: lstm.lstm_layer_fwd_plain(*args), fwd_k, 1, 10)
        fwd_extras = forward_extras("lstm_layer_fwd with cs", fwd_k, 1, B_TRAIN, dev, tf, T_ENC)
        tb = plain_kernel_ms(lambda: lstm.lstm_layer_bwd_plain(*bwd_args),
                             lambda: lstm.lstm_layer_bwd(*bwd_args), 1, 10)
        ctx = types.SimpleNamespace(saved_tensors=(*args[:3], *want), forget_bias=args[3])
        extras = backward_extras(
            "lstm_layer_bwd", lambda: lstm.lstm_layer_bwd(*bwd_args),
            lambda: lstm.LSTMLayer.backward(ctx, gys), 1, dev)
    # the autograd Function (#3 + #4 + the dWh contraction) against autograd
    # through the plain forward's time loop
    xproj, wh, mask, fb = args
    grads = []
    for fwd in (lambda x, w: lstm.LSTMLayer.apply(x, w, mask, fb),
                lambda x, w: lstm.lstm_layer_fwd_plain(x, w, mask, fb)[0]):
        leaves = [xproj.clone().requires_grad_(True), wh.clone().requires_grad_(True)]
        grads.append(torch.autograd.grad((fwd(*leaves) * gys).sum(), leaves))
    torch.cuda.synchronize()
    check("LSTMLayer dxproj vs autograd through the plain forward", grads[0][:1], grads[1][:1],
          BWD_ATOL)
    scale = float(grads[1][1].abs().max())
    check(f"LSTMLayer dWh vs autograd through the plain forward (max |dWh| {scale:.3e})",
          grads[0][1:], grads[1][1:], GRAD_RTOL * scale)
    del grads
    lib_fwd, lib_bwd = cudnn_lstm(dev, xs, lens, seed=21, bidirectional=False)
    out = {
        "lstm_layer_fwd": dict(tf, max_abs_err=fwd_err, library_ms=cuda_ms(lib_fwd, 10),
                               serving=serving, **fwd_extras,
                               **lstm_work(lengths, H, with_cs=True, backward=False, dirs=1)),
        "lstm_layer_bwd": dict(tb, max_abs_err=bwd_err, library_ms=cuda_ms(lib_bwd, 10),
                               **extras,
                               **lstm_work(lengths, H, with_cs=True, backward=True, dirs=1)),
    }
    for name, r, shape in (("lstm_layer_fwd serving", serving, f"B={B} T={T_ENC}"),
                           ("lstm_layer_fwd train", out["lstm_layer_fwd"],
                            f"B={B_TRAIN} T={T_ENC} with cs"),
                           ("lstm_layer_bwd train", out["lstm_layer_bwd"],
                            f"B={B_TRAIN} T={T_ENC}")):
        print(f"phase {name} {shape} H={H}: kernel {r['ms']:.3f} ms (runs "
              f"{r['ms_runs'][0]:.3f}, {r['ms_runs'][1]:.3f}; {r['ms'] * 1e3 / T_ENC:.2f} us per "
              f"step), plain {r['plain_ms']:.3f} ms "
              f"(runs {r['plain_ms_runs'][0]:.3f}, {r['plain_ms_runs'][1]:.3f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuDNN unidirectional nn.LSTM "
              f"{'backward' if 'bwd' in name else 'forward'} {r['library_ms']:.3f} ms"
              + (f", LSTMLayer.backward (kernel + dWh) {r['function_backward_ms']:.3f} ms"
                 if 'bwd' in name else "") + f"  [{gpu}]", flush=True)
    return out


def ls_transducer_task():
    """configs/ls_transducer.yml at full width, built in code (no yaml on the card)."""
    return experiment_from_dict(LS_TRANSDUCER).transducer_task(len(CHAR_UNITS))


def check_transducer_model(task, model_cpu, model_dev, dev, name: str = "ls_transducer") -> None:
    """f_proj, the teacher-forced nll and greedy ids on the card against the CPU."""
    batch = train_batch(2, 1.0, seed=22, max_labels=12)
    blank = task.model.blank_id
    outs = []
    for model, device in ((model_cpu, torch.device("cpu")), (model_dev, dev)):
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        with torch.inference_mode():
            feats, fl = device_pipeline(task, tb)
            f_proj, enc_len = model.encode(feats, fl)
            g_proj, _ = model.predict(pred_tokens(tb["labels"], blank))
            nll = rnnt_loss(f_proj, g_proj, model.out.w, model.out.b, tb["labels"], enc_len,
                            tb["label_len"], blank)
            ids, n = transducer_greedy_decode(model, f_proj, enc_len)
        outs.append([x.cpu() for x in (f_proj, nll, enc_len, ids, n)])
    (fc, lc, ec, ic, nc), (fg, lg, eg, ig, ng) = outs
    t_out = -(-(1 + (SR - 400) // 160) // 3)
    if fg.shape != (2, t_out, task.model.joint_dim) or not bool(torch.isfinite(fg).all()):
        raise RuntimeError(f"f_proj {tuple(fg.shape)} is misshapen or not finite")
    errs = {"f_proj": float((fc - fg).abs().max()), "nll": float((lc - lg).abs().max())}
    same = {"encoder lengths": torch.equal(ec, eg), "greedy ids": torch.equal(ic, ig),
            "greedy lengths": torch.equal(nc, ng)}
    print(f"{name} on the card vs the CPU plain path, 2 x 1 s: "
          + ", ".join(f"{k} max abs err {v:.3e}" for k, v in errs.items())
          + f" (tolerance {MODEL_ATOL:g}; nll {lg.tolist()}); "
          + ", ".join(f"{k} equal: {v}" for k, v in same.items())
          + f"; greedy lengths {ng.tolist()} of {ig.shape[1]} slots", flush=True)
    if not all(v <= MODEL_ATOL for v in errs.values()) or not all(same.values()):
        raise RuntimeError(f"{name} on the card disagrees with the CPU: {errs} {same}")


def time_transducer_phases(task, model, dev, gpu: str, name: str = "ls_transducer",
                           encoder: str = f"{TR_LAYERS} x LSTM-{H}") -> None:
    """Frontend, encoder and greedy decode on 8 x 12 s; a profile of the decode."""
    rng = np.random.RandomState(23)
    wav = torch.from_numpy((rng.randn(B, 12 * SR) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((B,), 12 * SR, dtype=torch.int64, device=dev)
    batch = {"inputs": wav, "input_len": lens}
    s = task.model.max_symbols_per_frame
    with torch.inference_mode():
        feats, fl = device_pipeline(task, batch)
        f_proj, enc_len = model.encode(feats, fl)
        if feats.shape != (B, T_ENC, D_TR) or f_proj.shape != (B, T_ENC, task.model.joint_dim):
            raise RuntimeError(f"unexpected shapes {tuple(feats.shape)} {tuple(f_proj.shape)}")
        decode = lambda: transducer_greedy_decode(model, f_proj, enc_len)  # noqa: E731
        ids, n = decode()  # warm-up; the emitted symbols
        times = {
            "frontend": host_ms(lambda: device_pipeline(task, batch), 5),
            f"encoder ({encoder} + enc_proj)": host_ms(
                lambda: model.encode(feats, fl), 3),
        }
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        times["greedy decode"] = (time.perf_counter() - t1) * 1e3
        steps = 1 + T_ENC * s  # the SOS step, then S prediction-net steps per frame
        for phase, ms in times.items():
            extra = ""
            if phase == "greedy decode":
                extra = (f", {T_ENC} frames x {s} symbol steps, {steps} prediction-net steps "
                         f"({ms / steps:.3f} ms per step), {int(n.sum())} symbols emitted")
            print(f"phase {name} {phase}: {ms:.3f} ms per batch of {B} x 12 s{extra}"
                  f"  [{gpu}]", flush=True)
        # the decode's steps are alike: a profile of its first PROFILE_FRAMES
        # frames gives its busy share with fewer events to read
        wall, busy, kernels = device_busy(lambda: transducer_greedy_decode(
            model, f_proj[:, :PROFILE_FRAMES], enc_len.clamp(max=PROFILE_FRAMES)))
    print(f"profile of the {name} greedy decode's first {PROFILE_FRAMES} frames: "
          f"{wall:.3f} ms wall (profiled), "
          f"{busy:.3f} ms of device kernel time ({100 * busy / wall:.1f} % busy); top kernels "
          "by device time:", flush=True)
    for key, t, k in kernels[:6]:
        print(f"  {t:9.3f} ms  {k:6d} launches  {key[:90]}", flush=True)


def serve_transducer_requests(task, model, gpu: str, name: str = "ls_transducer",
                              per_batch: dict | None = None) -> dict:
    """8 concurrent /recognize requests; returns the kernel launches they caused:
    ``per_batch`` for each batch (default: TR_LAYERS of #3) and nothing else."""
    responses, lat, counts, batches, health = post_requests(task, model, TR_REQUEST_SECONDS,
                                                            seed=24)
    cfg = task.model
    if health["blank_id"] != cfg.blank_id:
        raise RuntimeError(f"unexpected /healthz {health}")
    for seconds, r in zip(TR_REQUEST_SECONDS, responses):
        ids = r["ids"]
        frames = -(-(1 + (int(seconds * SR) - 400) // 160) // 3)
        if (r["num_ids"] != len(ids) or len(ids) > frames * cfg.max_symbols_per_frame
                or not all(isinstance(i, int) and 0 <= i < cfg.num_classes for i in ids)
                or r.get("text") is None or "truncated" in r):
            raise RuntimeError(f"malformed response for a {seconds} s request: {r}")
    print_latency(f"{name} request latency", responses, lat, batches, gpu)
    per_batch = {"lstm_layer_fwd": TR_LAYERS} if per_batch is None else per_batch
    want = dict(NONE_LAUNCHED, **{k: v * batches for k, v in per_batch.items()})
    print(f"{name} serving path launches: {counts}", flush=True)
    if batches < 1 or counts != want:
        raise RuntimeError(f"transducer serving launches {counts} for {batches} batch(es); "
                           f"expected {want}")
    return counts


# ---- beam decoding, joint rescoring, eval / decode CLIs and the RNN-LM ------------


def short_batch(n_rows: int, seed: int, max_labels: int) -> dict:
    """2 x 1 s (the second row 0.6 s) with labels: the card-vs-CPU inputs."""
    batch = train_batch(n_rows, 1.0, seed=seed, max_labels=max_labels)
    batch["input_len"][1:] = int(0.6 * SR)
    batch["inputs"][1:, int(0.6 * SR):] = 0.0
    return batch


def beams_agree(what: str, got, want, versus: str = "card vs CPU") -> None:
    """Prefix-beam outputs (prefixes, lengths, scores) of the card against the
    CPU's (or ``versus`` another reference): live slots (score above -1e29)
    hold equal prefixes and lengths and scores within MODEL_ATOL +
    BEAM_SCORE_RTOL x |score|."""
    got, want = [x.cpu() for x in got], [x.cpu() for x in want]
    live = want[2] > -1e29
    same = (torch.equal(got[2] > -1e29, live) and torch.equal(got[0][live], want[0][live])
            and torch.equal(got[1][live], want[1][live]))
    err = float((got[2][live] - want[2][live]).abs().max())
    ok = bool(((got[2][live] - want[2][live]).abs()
               <= MODEL_ATOL + BEAM_SCORE_RTOL * want[2][live].abs()).all())
    print(f"{what}, {versus}: live slots {int(live.sum())}, prefixes and lengths equal: "
          f"{same}, scores max abs err {err:.3e} (tolerance {MODEL_ATOL:g} + "
          f"{BEAM_SCORE_RTOL:g} x |score|), best lengths {got[1][:, 0].tolist()}", flush=True)
    if not (same and ok):
        raise RuntimeError(f"{what} on the card disagrees with the CPU")


def ctc_logits(task, model, batch: dict, dev):
    with torch.inference_mode():
        feats, fl = device_pipeline(task, {k: torch.from_numpy(batch[k]).to(dev)
                                           for k in ("inputs", "input_len")})
        out = model(feats, fl)
    return out.logits, out.logit_len


def check_ctc_beam(task, model, dev, name: str = "ls100_ctc", beam: int = CTC_BEAM) -> None:
    """The prefix beam (W = 20, K = 16) on the card against the CPU beam on the
    same (card) logits, 2 x 1 s; the card's frame loop runs with CUDA's sync
    debug mode set to raise, so it reads nothing back to the host."""
    logits, lens = ctc_logits(task, model, short_batch(2, 40, 6), dev)
    blank = task.model.blank_id
    want = ctc_prefix_beam_search(logits.cpu(), lens.cpu(), blank, beam_width=beam,
                                  top_k_classes=CTC_TOPK)
    state = ctc_prefix_beam.beam_init(2, beam, logits.shape[1], device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = ctc_prefix_beam.beam_advance(state, logits, lens, blank, CTC_TOPK)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    beams_agree(f"{name} prefix beam W={beam} K={CTC_TOPK} on 2 x 1 s (no host sync "
                "in the frame loop)", ctc_prefix_beam.beam_finalize(state), want)


def time_ctc_beam(task, model, dev, gpu: str, name: str = "ls100_ctc",
                  beam: int = CTC_BEAM) -> dict:
    """The prefix beam on the logits of 8 x 12 s: wall, device time, busy
    share, device launches per frame and the device memory above the logits."""
    rng = np.random.RandomState(41)
    batch = {"inputs": (rng.randn(B, 12 * SR) * 0.1).astype(np.float32),
             "input_len": np.full((B,), 12 * SR, np.int32)}
    logits, lens = ctc_logits(task, model, batch, dev)
    t_out = logits.shape[1]

    def decode():
        return ctc_prefix_beam_search(logits, lens, task.model.blank_id, beam_width=beam,
                                      top_k_classes=CTC_TOPK)

    wall = host_ms(decode, 3)
    wall_prof, busy, kernels = device_busy(decode)
    launches = sum(n for _, _, n in kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    prefixes, lengths, scores = decode()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    if not bool(torch.isfinite(scores[:, 0]).all()) or int(lengths[:, 0].min()) < 1:
        raise RuntimeError(f"beam decode gave scores {scores[:, 0]} lengths {lengths[:, 0]}")
    r = {"ms": wall, "device_ms": busy, "busy_share": busy / wall_prof,
         "launches_per_frame": launches / t_out, "peak_mib": peak}
    print(f"phase {name} prefix beam decode W={beam} K={CTC_TOPK}, {B} x 12 s "
          f"(T'={t_out}): {wall:.3f} ms per batch ({wall / t_out:.3f} ms per frame), "
          f"{busy:.3f} ms of device time in {launches} launches "
          f"({r['launches_per_frame']:.1f} per frame), {100 * r['busy_share']:.1f} % busy "
          f"(profiled wall {wall_prof:.3f} ms), {peak:.1f} MiB of device memory above the "
          f"logits; top kernels by device time:  [{gpu}]", flush=True)
    for key, t, n in kernels[:6]:
        print(f"  {t:9.3f} ms  {n:6d} launches  {key[:90]}", flush=True)
    return r


def serve_ctc_beam_requests(task, model, gpu: str) -> dict:
    """8 concurrent /recognize requests at beam 20; returns the launches they caused."""
    responses, lat, counts, batches, health = post_requests(
        task, model, REQUEST_SECONDS, seed=42, beam_width=CTC_BEAM)
    if health["beam_width"] != CTC_BEAM or health["decode"] != "ctc_prefix_beam":
        raise RuntimeError(f"unexpected /healthz {health}")
    for seconds, r in zip(REQUEST_SECONDS, responses):
        ids = r["ids"]
        if (r["num_ids"] != len(ids) or not all(0 <= i < task.model.num_classes for i in ids)
                or r.get("text") is None or "truncated" in r):
            raise RuntimeError(f"malformed response for a {seconds} s request: {r}")
    print_latency(f"ls100_ctc request latency, prefix beam {CTC_BEAM}", responses, lat,
                  batches, gpu)
    print(f"CTC beam serving path launches: {counts}", flush=True)
    if batches < 1 or counts != dict(NONE_LAUNCHED, lstm_bidi_fwd=LAYERS * batches):
        raise RuntimeError(f"CTC beam serving launches {counts} for {batches} batch(es)")
    return counts


def rescoring_inputs(dev, seed: int = 43):
    """#6 as joint rescoring calls it at beam 8: N = 64 rows (8 utterances x 8
    hypotheses, each utterance's CTC frames repeated), T = 300, C = 29, up to
    U = 120 labels, lengths 0..120, labels that include the blank id (the
    decoder's sos), -1 past each length."""
    rng = np.random.RandomState(seed)
    n = B_ATT * BEAM
    utt = rng.randn(B_ATT, ATT_T, C).astype(np.float32) * 3
    logits = np.repeat(utt, BEAM, axis=0)
    frames = np.asarray([ATT_T, 1] + list(rng.randint(100, ATT_T + 1, B_ATT - 2)), np.int32)
    logit_len = np.repeat(frames, BEAM)
    label_len = rng.randint(0, RESCORE_U + 1, n).astype(np.int32)
    label_len[:2] = (0, RESCORE_U)
    labels = rng.randint(0, C, (n, RESCORE_U)).astype(np.int32)  # C - 1 is the blank
    labels[np.arange(RESCORE_U)[None] >= label_len[:, None]] = -1
    as_t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return as_t(logits), as_t(logit_len), as_t(labels), as_t(label_len)


def check_rescoring_ctc(dev, gpu: str) -> dict:
    """#6 at the rescoring shape against its plain version: two calls equal bit
    for bit, device launches per call, time from graph replays (plain, kernel,
    kernel, plain) beside ``F.log_softmax`` + ``F.ctc_loss`` and the bound."""
    blank = C - 1
    args = rescoring_inputs(dev)
    logits, logit_len, labels, label_len = args
    shape = f"N={B_ATT * BEAM} T={ATT_T} C={C} U={RESCORE_U}"
    got, again = (ctc.ctc_loss_fwd_only(*args, blank) for _ in range(2))
    want = ctc.ctc_loss_fwd_only_plain(*args, blank)
    torch.cuda.synchronize()
    err = check(f"ctc_loss_fwd_only {shape} (rescoring)", [got], [want], 0.0, CTC_LOSS_RTOL)
    if not torch.equal(got, again):
        raise RuntimeError(f"ctc_loss_fwd_only {shape}: two calls on the same inputs differ")
    impossible = int((want > 1e20).sum())
    kernel = lambda: ctc.ctc_loss_fwd_only(*args, blank)  # noqa: E731
    launched = device_launches(kernel)  # before any graph capture, as check_ctc
    if sorted(v["per_call"] for v in launched.values()) != [1.0, 1.0]:
        raise RuntimeError(f"ctc_loss_fwd_only {shape}: expected 2 device launches per call "
                           f"(frames, chains), the profiler saw {launched}")

    def library():
        lp = F.log_softmax(logits, dim=-1).transpose(0, 1)
        return F.ctc_loss(lp, labels.clamp_min(0).long(), logit_len.long(), label_len.long(),
                          blank=blank, reduction="none")

    plain = lambda: ctc.ctc_loss_fwd_only_plain(*args, blank)  # noqa: E731
    plain_runs = [cuda_ms(plain, 2)]
    runs = [graph_ms(kernel, CTC_REPS) for _ in range(2)]
    plain_runs.append(cuda_ms(plain, 2))
    r = dict(max_abs_err=err, deterministic=True, ms=sum(runs) / 2, ms_runs=runs,
             plain_ms=sum(plain_runs) / 2, plain_ms_runs=plain_runs,
             library_ms=cuda_ms(library, 20), device_launches=launched,
             plan=ctc.ctc_plan(B_ATT * BEAM, ATT_T, 2 * RESCORE_U + 1, grad=False)._asdict(),
             impossible_rows=impossible,
             **ctc_work(logit_len, label_len, RESCORE_U, grad=False, b=B_ATT * BEAM, t=ATT_T))
    split = ", ".join(f"{k} {v['per_call']:g} x {v['us']:.2f} us"
                      for k, v in r["device_launches"].items())
    print(f"phase ctc_loss_fwd_only {shape} (joint rescoring at beam {BEAM}; {impossible} rows "
          f"without an alignment): kernel {r['ms']:.4f} ms (runs {runs[0]:.4f}, {runs[1]:.4f}; "
          f"graph replays), plain {r['plain_ms']:.3f} ms (runs {plain_runs[0]:.3f}, "
          f"{plain_runs[1]:.3f}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
          f"F.log_softmax+F.ctc_loss {r['library_ms']:.3f} ms; device launches per call: "
          f"{split}; plan {r['plan']['route']} K={r['plan']['lanes_per_thread']} "
          f"warps={r['plan']['chain_warps']}  [{gpu}]", flush=True)
    return r


def check_att_beam_eval(task, att_cpu, att_model, dev) -> None:
    """The beam eval step of ``bin/eval`` (beam 8, joint rescoring at the
    config's λ, length penalty 0.6) on 2 x 1 s, card against CPU: ids and
    lengths equal, the NLL within LOSS_RTOL."""
    cfg = task.model
    step = att_task.make_beam_eval_step(task, BEAM, LS960_JOINT["length_penalty"],
                                        joint_rescore_weight=cfg.ctc_loss_weight)
    batch = short_batch(2, 44, 6)
    outs = []
    for model, device in ((att_cpu, torch.device("cpu")), (att_model, dev)):
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        outs.append([x.cpu() for x in step(dict(model.state_dict()), tb)])
    (ic, lc, nc), (ig, lg, ng) = outs
    err = float(((nc - ng).abs() / nc.abs()).max())
    same = torch.equal(ic, ig) and torch.equal(lc, lg)
    print(f"ls960_joint beam eval step (beam {BEAM}, joint rescoring, length penalty "
          f"{LS960_JOINT['length_penalty']}) on 2 x 1 s, card vs CPU: ids and lengths equal: "
          f"{same}, lengths {lg.tolist()}, NLL {ng.tolist()} vs {nc.tolist()} (max rel err "
          f"{err:.2e}, tolerance {LOSS_RTOL:g})", flush=True)
    if not (same and err <= LOSS_RTOL):
        raise RuntimeError("the ls960_joint beam eval step on the card disagrees with the CPU")


def time_att_beam_eval(task, att_model, dev, gpu: str) -> dict:
    """One 8 x 12 s batch through the beam eval step (beam 8, rescoring):
    wall, busy share, and its launches (5 #1, one #7 per decoder step, one #6)."""
    cfg = task.model
    step = att_task.make_beam_eval_step(task, BEAM, LS960_JOINT["length_penalty"],
                                        joint_rescore_weight=cfg.ctc_loss_weight)
    batch = train_batch(B_ATT, 12.0, seed=45, max_labels=U)
    batch["input_len"][:] = 12 * SR
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = dict(att_model.state_dict())
    step(params, tb)
    torch.cuda.synchronize()
    reset_counts()
    ids, lengths, nll = step(params, tb)
    torch.cuda.synchronize()
    counts = read_counts()
    wall = host_ms(lambda: step(params, tb), 2)
    wall_prof, busy, kernels = device_busy(lambda: step(params, tb))
    steps = counts["location_attend"]
    print(f"phase ls960_joint beam eval step (beam {BEAM}, joint rescoring) {B_ATT} x 12 s: "
          f"{wall:.3f} ms per batch, {busy:.3f} ms of device time ({100 * busy / wall_prof:.1f}"
          f" % busy), {steps} decoder steps, launches {counts}, NLL mean "
          f"{float(nll.mean()):.3f}  [{gpu}]", flush=True)
    k = seq2seq.decode_unroll_factor(cfg.max_decode_length)
    want = dict(NONE_LAUNCHED, lstm_bidi_fwd=LAYERS, location_attend=steps, ctc_loss_fwd_only=1)
    if counts != want or steps % k or not k <= steps <= cfg.max_decode_length:
        raise RuntimeError(f"beam eval step launches {counts}; expected {want}")
    if not bool(torch.isfinite(nll).all()):
        raise RuntimeError(f"beam eval step NLL {nll}")
    return {"ms": wall, "device_ms": busy, "busy_share": busy / wall_prof, "launches": counts}


def run_cli(what: str, fn, argv: list, launched: tuple, gpu: str):
    """``fn(argv)`` (a CLI's ``main``) with the launch counts reset just before
    and read just after: each kernel in ``launched`` must run, and no other."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"phase {what}: {wall:.1f} s wall, launches {counts}  [{gpu}]", flush=True)
    if any(counts[k] < 1 for k in launched) or any(counts[k] for k in COUNTERS
                                                   if k not in launched):
        raise RuntimeError(f"{what} launched {counts}; expected {launched}")
    return out, counts


def run_clis(ctc_dir: Path, joint_dir: Path, lm_dir: Path, gpu: str) -> dict:
    """``bin/eval`` (ls100_ctc at its beam 20; ls960_joint at beam 8 with joint
    rescoring), ``bin/decode --nbest 2`` on each, ``bin/train_lm`` for one epoch
    on the ls960_joint toy corpus at the CLI's default width, and ``bin/eval
    --lm-dir`` at beam 8 on both model dirs. Returns the launch counts."""
    ctc_kernels = ("lstm_bidi_fwd", "ctc_loss_fwd_only")
    att_kernels = ("lstm_bidi_fwd", "location_attend", "ctc_loss_fwd_only")
    counts = {}

    def evaluate(name, model_dir, extra, kernels):
        res, c = run_cli(f"bin/eval {name} {' '.join(extra)}".strip(), eval_cli.main,
                         [str(model_dir), "--device", "cuda", *extra], kernels, gpu)
        if not all(np.isfinite(res[s]["error_rate"]) and np.isfinite(res[s]["loss"])
                   and res[s]["num_utts"] > 0 for s in ("dev", "test")):
            raise RuntimeError(f"bin/eval {name} gave {res}")
        return c

    def decode(name, model_dir, extra, kernels):
        lines, c = run_cli(f"bin/decode {name} {' '.join(extra)}", decode_cli.main,
                           [str(model_dir), "--device", "cuda", "--nbest", "2", *extra],
                           kernels, gpu)
        hyps = [s for s in lines if s.startswith("  HYP")]
        if len(hyps) != 2 * sum(s.startswith("[") for s in lines) or not hyps:
            raise RuntimeError(f"bin/decode {name} printed {lines[:6]}")
        return c

    counts["eval_ctc"] = evaluate("ls100_ctc", ctc_dir, [], ctc_kernels)
    counts["decode_ctc"] = decode("ls100_ctc", ctc_dir, ["--beam-width", str(CTC_BEAM)],
                                  ("lstm_bidi_fwd",))
    counts["eval_joint"] = evaluate("ls960_joint", joint_dir, [], att_kernels)
    counts["decode_joint"] = decode(
        "ls960_joint", joint_dir, ["--beam-width", str(BEAM), "--joint-rescore",
                                   "--length-penalty", str(LS960_JOINT["length_penalty"])],
        att_kernels)
    cfg_path = lm_dir.parent / "ls960_joint.yml"
    experiment_from_dict(LS960_JOINT).to_yaml(cfg_path)
    reset_counts()
    t0 = time.perf_counter()
    ppl = train_lm_cli.main([str(cfg_path), str(lm_dir), "--epochs", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    print(f"phase bin/train_lm ls960_joint toy corpus, 1 epoch, 256 units / embedding 128 / "
          f"1 layer: {time.perf_counter() - t0:.1f} s wall, dev perplexity {ppl:.3f}, "
          f"launches {read_counts()}  [{gpu}]", flush=True)
    if not np.isfinite(ppl) or any(read_counts().values()):
        raise RuntimeError(f"bin/train_lm gave perplexity {ppl} and launches {read_counts()}")
    lm_args = ["--beam-width", str(BEAM), "--lm-dir", str(lm_dir)]
    counts["eval_ctc_lm"] = evaluate("ls100_ctc", ctc_dir, lm_args, ctc_kernels)
    counts["eval_joint_lm"] = evaluate("ls960_joint", joint_dir, lm_args, att_kernels)
    return counts


def check_fusion(ctc_task_cfg, ctc_cpu, ctc_dev, att, att_cpu, att_dev, lm_dir: Path,
                 dev) -> None:
    """Shallow fusion with the LM ``bin/train_lm`` wrote, card against CPU on
    2 x 1 s: the CTC prefix beam (W = 20, carried LM state) on the same (card)
    logits, and the attention beam (beam 8, length penalty 0.6, then joint
    rescoring) on the same (card) encoder outputs."""
    lm_cpu, lm_dev = train_lm_cli.load_lm(lm_dir, "cpu"), train_lm_cli.load_lm(lm_dir, dev)
    lm_weight = 0.3
    logits, lens = ctc_logits(ctc_task_cfg, ctc_dev, short_batch(2, 46, 6), dev)
    outs = []
    for lm, device in ((lm_cpu, "cpu"), (lm_dev, dev)):
        fusion = make_fusion_lm(lm, ctc_task_cfg.model.vocab_with_blank)
        with torch.inference_mode():
            outs.append(ctc_prefix_beam_search(
                logits.to(device), lens.to(device), ctc_task_cfg.model.blank_id,
                beam_width=CTC_BEAM, top_k_classes=CTC_TOPK, fusion_lm=fusion,
                lm_weight=lm_weight))
    beams_agree(f"ls100_ctc prefix beam W={CTC_BEAM} with the RNN-LM fused at {lm_weight}",
                outs[1], [x.cpu() for x in outs[0]])
    batch = short_batch(2, 47, 6)
    cfg = att.model
    with torch.inference_mode():
        feats, fl = device_pipeline(att, {k: torch.from_numpy(batch[k]).to(dev)
                                          for k in ("inputs", "input_len")})
        enc = seq2seq.encode(att_dev, feats, fl)
        res = []
        for model, lm, device in ((att_cpu, lm_cpu, torch.device("cpu")),
                                  (att_dev, lm_dev, dev)):
            pre = seq2seq.EncodeOutput(*(None if x is None else x.to(device) for x in enc))
            out = attention_beam_search(model, feats.to(device), fl.to(device), beam_width=BEAM,
                                        length_penalty=LS960_JOINT["length_penalty"], lm=lm,
                                        lm_weight=lm_weight, precomputed=pre)
            out = joint_rescore(out, cfg.ctc_loss_weight, cfg.num_classes,
                                LS960_JOINT["length_penalty"])
            res.append([x.cpu() for x in (out.tokens, out.lengths, out.scores)])
    (tc, lc, sc), (tg, lg, sg) = res
    err = float((sc - sg).abs().max())
    same = torch.equal(tc, tg) and torch.equal(lc, lg)
    print(f"ls960_joint beam {BEAM} with the RNN-LM fused at {lm_weight}, then joint "
          f"rescoring, on 2 x 1 s, card vs CPU: tokens and lengths equal: {same}, scores max "
          f"abs err {err:.3e}, best lengths {lg[:, 0].tolist()}", flush=True)
    if not (same and bool(((sc - sg).abs() <= MODEL_ATOL + BEAM_SCORE_RTOL * sc.abs()).all())):
        raise RuntimeError("the fused attention beam on the card disagrees with the CPU")


# ---- conformer / transformer encoders, their MoE feed-forward and SpecAugment ------


def conformer_models(raw: dict, task_mod, dev):
    """(task, seeded weights on the CPU, CPU model, card model) of ``raw`` at full width."""
    task = experiment_from_dict(raw).task(len(CHAR_UNITS))
    params = task_mod.init_params(task, torch.Generator().manual_seed(0))
    cpu = task_mod.init_model(task)
    cpu.load_state_dict(params)
    cpu.eval()
    return task, params, cpu, copy.deepcopy(cpu).to(dev).eval()


def encoder_label(raw: dict) -> str:
    pos = raw.get("pos_encoding", "absolute")
    causal = f", left context {raw['left_context']}" if raw.get("left_context", -1) >= 0 else ""
    moe = f", MoE {raw['moe_num_experts']} experts top-{raw['moe_top_k']}" \
        if raw.get("moe_num_experts") else ""
    return (f"{raw['num_layers']} x {raw['encoder_type']}-{raw['num_units']}, "
            f"{raw['num_heads']} heads, {pos}{causal}{moe}")


def print_kinds(name: str, r: dict, gpu: str) -> None:
    print(f"{name} train step device time by kind ({r['device_ms']:.3f} ms of "
          f"{r['profile_wall_ms']:.3f} ms profiled): " + ", ".join(
              f"{k} {v['ms']:.3f} ms / {v['launches']} launches"
              for k, v in r["by_kind"].items()) + f"  [{gpu}]", flush=True)


def fit_with_spec_augment(dev, gpu: str, model_dir: Path) -> dict:
    """``fit`` on ls960_conformer_ctc_sa for one toy epoch; every train step's
    features go through SpecAugment with draws on the card (``dev``)."""
    calls = []
    plain = ctc_task.spec_augment

    def counted(feats, feat_len, generator, cfg):
        calls.append((feats.device.type, generator.device.type))
        return plain(feats, feat_len, generator, cfg)

    ctc_task.spec_augment = counted
    try:
        counts = train_one_epoch("ls960_conformer_ctc_sa", LS960_CONFORMER_CTC_SA, gpu,
                                 ("ctc_loss", "ctc_loss_fwd_only"), model_dir)
    finally:
        ctc_task.spec_augment = plain
    steps = json.loads((model_dir / "summary.json").read_text())["steps"]
    print(f"SpecAugment calls in the ls960_conformer_ctc_sa epoch: {len(calls)} for {steps} "
          f"train steps, features and draws on {sorted(set(calls))}", flush=True)
    if len(calls) != steps or set(calls) != {(dev.type, dev.type)}:
        raise RuntimeError(f"SpecAugment ran {len(calls)} times ({set(calls)}) in {steps} steps")
    return counts


def run_conformer(args, dev, gpu: str, work: Path, t0: float) -> tuple:
    """Phases 25-31: the six conformer / transformer configs. Returns (launch
    counts by path, the timed numbers)."""
    counts, numbers = {}, {}
    want_ctc_step = dict(NONE_LAUNCHED, ctc_loss=1)
    name = "ls960_conformer_ctc"
    task, params, cpu, model = conformer_models(LS960_CONFORMER_CTC, ctc_task, dev)
    check_model(task, cpu, model, dev, name)
    check_train_step(task, ctc_task, params, dev, seed=51)
    clock(f"{name} card == CPU", t0)
    time_phases(task, model, dev, gpu, name, encoder_label(LS960_CONFORMER_CTC))
    counts["conformer_serving"] = serve_requests(task, model, gpu, name, per_batch={})
    numbers[f"{name}_prefix_beam"] = time_ctc_beam(task, model, dev, gpu, name)
    del model
    r = time_train_steps(name, task, ctc_task, params, dev, gpu, args.profile_out,
                         want_ctc_step, 0)
    print_kinds(name, r, gpu)
    numbers[f"{name}_train_step"] = r
    counts["conformer_training"] = train_one_epoch(
        name, LS960_CONFORMER_CTC, gpu, ("ctc_loss", "ctc_loss_fwd_only"), work / name)
    res, counts["eval_conformer"] = run_cli(
        f"bin/eval {name}", eval_cli.main, [str(work / name), "--device", "cuda"],
        ("ctc_loss_fwd_only",), gpu)
    if not all(np.isfinite(res[s]["error_rate"]) and np.isfinite(res[s]["loss"])
               for s in ("dev", "test")):
        raise RuntimeError(f"bin/eval {name} gave {res}")
    clock(f"{name} served, trained and evaluated", t0)

    for name, raw in (("ls960_transformer_ctc", LS960_TRANSFORMER_CTC),
                      ("ls960_moe_conformer", LS960_MOE_CONFORMER)):
        task, params, cpu, model = conformer_models(raw, ctc_task, dev)
        check_model(task, cpu, model, dev, name)
        check_train_step(task, ctc_task, params, dev, seed=52)
        del model
        r = time_train_steps(name, task, ctc_task, params, dev, gpu, args.profile_out,
                             want_ctc_step, 0, steps=3)
        print_kinds(name, r, gpu)
        numbers[f"{name}_train_step"] = r
    clock("ls960_transformer_ctc and ls960_moe_conformer card == CPU and timed", t0)

    name = "ls_conformer_transducer"
    task, params, cpu, model = conformer_models(LS_CONFORMER_TRANSDUCER, transducer_task, dev)
    check_transducer_model(task, cpu, model, dev, name)
    check_train_step(task, transducer_task, params, dev, seed=53)
    time_transducer_phases(task, model, dev, gpu, name, encoder_label(LS_CONFORMER_TRANSDUCER))
    counts["conformer_transducer_serving"] = serve_transducer_requests(task, model, gpu, name,
                                                                       per_batch={})
    del model
    r = time_train_steps(name, task, transducer_task, params, dev, gpu, args.profile_out,
                         NONE_LAUNCHED, 0, steps=TR_TIMED_STEPS)
    print_kinds(name, r, gpu)
    numbers[f"{name}_train_step"] = r
    # 256 utterances instead of the config's 512, as for ls_transducer
    counts["conformer_transducer_training"] = train_one_epoch(
        name, LS_CONFORMER_TRANSDUCER | {"toy_num_utts": 256}, gpu, (), work / name)
    clock(f"{name} card == CPU, served and trained", t0)

    task, _, cpu, model = conformer_models(LS_STREAMING_CONFORMER, ctc_task, dev)
    check_model(task, cpu, model, dev, "ls_streaming_conformer (offline)")
    del model
    counts["conformer_sa_training"] = fit_with_spec_augment(dev, gpu,
                                                            work / "ls960_conformer_ctc_sa")
    name = "conformer_ctc_512x8"
    task = experiment_from_dict(CONFORMER_WIDE).task(len(CHAR_UNITS))
    r = time_train_steps(name, task, ctc_task,
                         ctc_task.init_params(task, torch.Generator().manual_seed(0)), dev, gpu,
                         args.profile_out, want_ctc_step, 0, steps=3)
    print_kinds(f"{name} ({encoder_label(CONFORMER_WIDE)}; not a config of the repo)", r, gpu)
    numbers[f"{name}_train_step"] = r
    clock("ls_streaming_conformer card == CPU; ls960_conformer_ctc_sa trained; 512 x 8 timed",
          t0)
    return counts, numbers


# ---- phases 32-36: the VGG, multitask, BPE and word configs ----------------------

# csj_joint: 40 mel + energy and deltas = 123 dims; VGG 41 -> 11 frequencies x 128 = 1408;
# 12 s: T = 1198 -> T' = 300; decoder steps up to max_decode_length 60
CSJ_T, CSJ_D, CSJ_H, CSJ_A, CSJ_HE, CSJ_U = 300, 1408, 320, 128, 640, 60
# timit_multitask_ctc: TIMIT's longest utterances are about 7.8 s (T <= 780 frames, no
# stacking); a 7.8 s TIMIT sentence holds about 80 phones
TIMIT_SECONDS, TIMIT_T, TIMIT_D, TIMIT_H, TIMIT_U = 7.8, 780, 123, 256, 80
TIMIT_REQUEST_SECONDS = (7.8, 7.2, 6.3, 5.4, 4.5, 3.6, 2.7, 1.5)
# ls960_joint_bpe at the vocabulary bpe_1000 gives on LibriSpeech: the 28 base
# symbols (a-z, the apostrophe, the word marker) + 1000 merges + <unk>
BPE_LIBRISPEECH_UNITS = 1029
BPE_T, BPE_U = 100, 40  # 12 s: 1198 frames -> 3/3 stacking 400 -> 2 x 2x pyramid 100
FAMILY_TRAIN_STEP = 30  # the attention configs' timed steps: inside their schedules
FAMILIES = ("csj_joint", "timit_multitask_ctc", "ls960_joint_bpe", "ls_word_ctc")


def raw_config(name: str) -> dict:
    """``configs/<name>.yml`` as a dict."""
    import yaml

    return yaml.safe_load((Path(__file__).resolve().parent / "configs" / f"{name}.yml")
                          .read_text())


def family_task(raw: dict, num_units: int | None = None, **overrides) -> tuple:
    """(task, units) of a config at full width; ``num_units`` replaces the
    corpus's unit count."""
    exp = experiment_from_dict(dict(raw, **overrides))
    units = corpus_tokenizer(exp).units
    return exp.task(num_units or len(units)), units


def family_models(raw: dict, task_mod, dev, num_units: int | None = None) -> tuple:
    """(task, units, seeded weights on the CPU, CPU model, card model)."""
    task, units = family_task(raw, num_units)
    cpu = task_mod.init_model(task, torch.Generator().manual_seed(0)).eval()
    params = {k: v.detach().clone() for k, v in cpu.state_dict().items()}
    return task, units, params, cpu, copy.deepcopy(cpu).to(dev).eval()


def check_ctc_classes(dev, gpu: str, c: int, t: int, u: int, what: str) -> dict:
    """Kernels #5 and #6 against their plain versions at B=32, ``t`` frames and
    ``c`` classes, up to ``u`` labels: two calls equal bit for bit, times from
    graph replays (plain, kernel, kernel, plain) beside ``F.log_softmax`` +
    ``F.ctc_loss`` and the bound."""
    blank = c - 1
    args = ctc_inputs(dev, seed=60 + c, u=u, c=c, t=t)
    logits, logit_len, labels, label_len = args
    shape = f"B={B_TRAIN} T={t} C={c} U={u}"
    got, again = (ctc.ctc_loss_fwd_bwd(*args, blank) for _ in range(2))
    want = ctc.ctc_loss_plain(*args, blank)
    exact = ctc.ctc_loss_plain(logits.double(), *args[1:], blank)
    fwd, fwd_again = (ctc.ctc_loss_fwd_only(*args, blank) for _ in range(2))
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(fwd, fwd_again)):
        raise RuntimeError(f"ctc_loss {shape}: two calls on the same inputs differ")
    # the losses (about 1e3) carry float32 rounding into every posterior; where
    # the kernel sums a row in another order than the plain version (a
    # log-softmax over C = 1030), both are held to the float64 plain version:
    # the kernel no further from it than the float32 plain version, plus the
    # tolerance
    far = lambda x, y: float((x.double() - y).abs().max())  # noqa: E731
    rel = lambda x, y: float(((x.double() - y) / y).abs().max())  # noqa: E731
    errs = {"ctc_loss": max(far(got[0], want[0]), far(got[1], want[1])),
            "ctc_loss_fwd_only": far(fwd, want[0])}
    loss_ok = all(rel(x, exact[0]) <= rel(want[0], exact[0]) + CTC_LOSS_RTOL
                  for x in (got[0], fwd))
    grad_ok = far(got[1], exact[1]) <= far(want[1], exact[1]) + CTC_GRAD_ATOL
    print(f"ctc_loss {shape}: against the float64 plain version, loss max rel err kernel "
          f"{rel(got[0], exact[0]):.2e} / loss-only {rel(fwd, exact[0]):.2e} / float32 plain "
          f"{rel(want[0], exact[0]):.2e} (tolerance: the plain's + {CTC_LOSS_RTOL:g}); grad max "
          f"abs err kernel {far(got[1], exact[1]):.3e} / float32 plain "
          f"{far(want[1], exact[1]):.3e} (tolerance: the plain's + {CTC_GRAD_ATOL:g}); kernel "
          f"vs float32 plain {errs['ctc_loss']:.3e}, loss-only {errs['ctc_loss_fwd_only']:.3e}",
          flush=True)
    if not (loss_ok and grad_ok):
        raise RuntimeError(f"ctc_loss {shape} disagrees with its plain version")
    x = logits.clone().requires_grad_(True)
    ones = torch.ones(B_TRAIN, device=dev)

    def library(backward: bool):
        with torch.set_grad_enabled(backward):
            lp = F.log_softmax(x, dim=-1).transpose(0, 1)
            nll = F.ctc_loss(lp, labels.long(), logit_len.long(), label_len.long(), blank=blank,
                             reduction="none")
            if backward:
                torch.autograd.grad(nll, x, ones)
        return nll

    out = {}
    for name, kernel, plain, grad in (
            ("ctc_loss", ctc.ctc_loss_fwd_bwd, ctc.ctc_loss_plain, True),
            ("ctc_loss_fwd_only", ctc.ctc_loss_fwd_only, ctc.ctc_loss_fwd_only_plain, False)):
        p = [cuda_ms(lambda: plain(*args, blank), 2)]
        k = [graph_ms(lambda: kernel(*args, blank), CTC_REPS) for _ in range(2)]
        p.append(cuda_ms(lambda: plain(*args, blank), 2))
        r = out[name] = dict(ms=sum(k) / 2, ms_runs=k, plain_ms=sum(p) / 2, plain_ms_runs=p,
                             max_abs_err=errs[name], deterministic=True,
                             library_ms=cuda_ms(lambda: library(grad), 20), shape=shape,
                             plan=ctc.ctc_plan(B_TRAIN, t, 2 * u + 1, grad)._asdict(),
                             **ctc_work(logit_len, label_len, u, grad, t=t, c=c))
        print(f"phase {name} {what} {shape}: kernel {r['ms']:.4f} ms (runs {k[0]:.4f}, "
              f"{k[1]:.4f}; graph replays), plain {r['plain_ms']:.3f} ms (runs {p[0]:.3f}, "
              f"{p[1]:.3f}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"F.log_softmax+F.ctc_loss {r['library_ms']:.3f} ms, max abs err "
              f"{r['max_abs_err']:.3e}; plan {r['plan']['route']} "
              f"K={r['plan']['lanes_per_thread']} warps={r['plan']['chain_warps']}  [{gpu}]",
              flush=True)
    return out


def check_location_scorer(dev, gpu: str) -> dict:
    """Kernel #7 for the pure location scorer (no keys) at csj_joint's decoder
    shapes (T'=300, A=128, He=640, C=10, W=101): the beam's grouped call (N=32:
    8 utterances x beam 4) and the greedy call (N=8), against the plain
    version, timed from graph replays beside the bound."""
    out = {}
    for name, group, seed in (("grouped", 4, 70), ("n8", 1, 71)):
        rng = np.random.RandomState(seed)
        lengths = [CSJ_T, 1, 0] + [int(x) for x in rng.randint(1, CSJ_T + 1, B_ATT - 3)]
        args, b = attend_inputs(dev, B_ATT, lengths, seed=seed, group=group, t=CSJ_T, a=CSJ_A,
                                he=CSJ_HE)
        args[0] = None  # location scorer: b alone stands in the keys' place
        kw = dict(b=b, group=group)
        shape = (f"N={B_ATT * group} (G={group}) T={CSJ_T} A={CSJ_A} He={CSJ_HE} C={ATT_C} "
                 f"W={ATT_W}, no keys")
        got = attention.location_attend(*args, 1.0, **kw)
        want = attention.location_attend_plain(*args, 1.0, **kw)
        again = attention.location_attend(*args, 1.0, **kw)
        torch.cuda.synchronize()
        err = max(check(f"location_attend {name} {shape}: align", got[1:], want[1:],
                        ATT_ALIGN_ATOL),
                  check(f"location_attend {name} {shape}: ctx", got[:1], want[:1], ATT_CTX_ATOL))
        if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
            raise RuntimeError(f"location_attend {name} {shape}: two calls differ")
        plain = lambda: attention.location_attend_plain(*args, 1.0, **kw)  # noqa: E731
        kernel = lambda: attention.location_attend(*args, 1.0, **kw)  # noqa: E731
        p = [graph_ms(plain, 50)]
        k = [graph_ms(kernel, 50) for _ in range(2)]
        p.append(graph_ms(plain, 50))
        r = out[name] = dict(ms=sum(k) / 2, ms_runs=k, plain_ms=sum(p) / 2, plain_ms_runs=p,
                             max_abs_err=err, library_ms=None, deterministic=True, shape=shape,
                             **attend_work(lengths, group, t=CSJ_T, a=CSJ_A, he=CSJ_HE,
                                           keys=False))
        print(f"phase location_attend csj_joint {name} {shape}: kernel {r['ms'] * 1e3:.2f} us "
              f"(runs {k[0] * 1e3:.2f}, {k[1] * 1e3:.2f}; graph replays), plain "
              f"{r['plain_ms'] * 1e3:.2f} us (runs {p[0] * 1e3:.2f}, {p[1] * 1e3:.2f}), bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), no single library call, max abs "
              f"err {err:.3e}, two calls bitwise equal  [{gpu}]", flush=True)
    return out


def time_att_serving(task, model, dev, gpu: str, name: str, beam: int) -> dict:
    """Frontend, encoder, greedy and beam decode of an attention config on 8 x
    12 s, with the beam decode's device time and busy share."""
    rng = np.random.RandomState(72)
    wav = torch.from_numpy((rng.randn(B_ATT, 12 * SR) * 0.1).astype(np.float32)).to(dev)
    batch = {"inputs": wav, "input_len": torch.full((B_ATT,), 12 * SR, device=dev)}
    with torch.inference_mode():
        feats, fl = device_pipeline(task, batch)
        enc = seq2seq.encode(model, feats, fl)
        decodes = {
            "greedy decode": lambda: seq2seq.greedy_decode(model, feats, fl, precomputed=enc),
            f"beam-{beam} decode": lambda: attention_beam_search(
                model, feats, fl, beam_width=beam, precomputed=enc),
        }
        steps = {k: fn().steps for k, fn in decodes.items()}
        times = {"frontend": host_ms(lambda: device_pipeline(task, batch), 3),
                 f"encoder (T={feats.shape[1]} -> T'={enc.outputs.shape[1]})":
                     host_ms(lambda: seq2seq.encode(model, feats, fl), 3),
                 **{k: host_ms(fn, 2) for k, fn in decodes.items()}}
        wall, busy, _ = device_busy(decodes[f"beam-{beam} decode"])
    for phase, ms in times.items():
        extra = f", {steps[phase]} steps" if phase in steps else ""
        print(f"phase {name} {phase}: {ms:.3f} ms per batch of {B_ATT} x 12 s{extra}  [{gpu}]",
              flush=True)
    print(f"profile of one {name} beam-{beam} decode: {wall:.3f} ms wall (profiled), "
          f"{busy:.3f} ms of device time ({100 * busy / wall:.1f} % busy)  [{gpu}]", flush=True)
    return dict(times, beam_device_ms=busy, beam_busy_share=busy / wall)


def family_clis(name: str, model_dir: Path, beam: int, kernels: tuple, gpu: str,
                decode_args: list) -> dict:
    """``bin/eval`` at the config's beam and ``bin/decode`` with ``decode_args``
    on the model dir ``fit`` wrote; each kernel in ``kernels`` runs (only #1
    and, for attention models, #7 when decoding)."""
    res, eval_counts = run_cli(f"bin/eval {name} (beam {beam})", eval_cli.main,
                               [str(model_dir), "--device", "cuda"], kernels, gpu)
    if not all(np.isfinite(res[s]["error_rate"]) and np.isfinite(res[s]["loss"])
               and res[s]["num_utts"] > 0 for s in ("dev", "test")):
        raise RuntimeError(f"bin/eval {name} gave {res}")
    decoding = tuple(k for k in kernels if k != "ctc_loss_fwd_only")
    if "--joint-rescore" in decode_args:
        decoding += ("ctc_loss_fwd_only",)
    lines, decode_counts = run_cli(f"bin/decode {name} {' '.join(decode_args)}",
                                   decode_cli.main, [str(model_dir), "--device", "cuda",
                                                     *decode_args], decoding, gpu)
    if not any(s.startswith("  HYP") for s in lines):
        raise RuntimeError(f"bin/decode {name} printed {lines[:6]}")
    return {f"eval_{name}": eval_counts, f"decode_{name}": decode_counts}


def run_families(args, dev, gpu: str, work: Path, t0: float) -> tuple:
    """Phases 32-36: csj_joint, timit_multitask_ctc, ls960_joint_bpe and
    ls_word_ctc at full width. Returns (launch counts by path, kernel results
    at the new shapes, the timed numbers)."""
    counts, kernels, numbers = {}, {}, {}
    fwd_bwd = ("lstm_bidi_fwd", "lstm_bidi_bwd")
    att_walk = dict(NONE_LAUNCHED, ctc_loss=1)

    # 32. the kernels at the new shapes
    kernels["csj_train"] = check_training_lstm(dev, gpu, t=CSJ_T, d=CSJ_D, seed=61,
                                               what="csj_joint layer 0", h=CSJ_H)
    kernels["timit_train"] = check_training_lstm(dev, gpu, t=TIMIT_T, d=TIMIT_D, seed=62,
                                                 what="timit_multitask_ctc layer 0", h=TIMIT_H)
    kernels["c62"] = check_ctc_classes(dev, gpu, 62, TIMIT_T, TIMIT_U, "timit phones")
    kernels["c87"] = check_ctc_classes(dev, gpu, 87, CSJ_T, CSJ_U, "csj kana")
    kernels["c1030"] = check_ctc_classes(dev, gpu, BPE_LIBRISPEECH_UNITS + 1, BPE_T, BPE_U,
                                         "LibriSpeech bpe_1000")
    kernels["location_a128"] = check_location_scorer(dev, gpu)
    clock("kernels #1, #2 at H=320 / 256, #5, #6 at C=62 / 87 / 1030, #7 without keys checked",
          t0)

    # 33. csj_joint: VGG + 4 x BLSTM-320, location attention A=128, kana, beam 4
    name, raw = "csj_joint", raw_config("csj_joint")
    beam = raw["beam_width"]
    task, units, params, cpu, model = family_models(raw, att_task, dev)
    check_att_model(task, cpu, model, dev, name, beam=beam, t_enc=-(-(1 + (SR - 400) // 160)
                                                                    // 4))
    check_train_step(family_task(raw, dropout=1.0, scheduled_sampling_prob=0.0)[0],
                     att_task, params, dev, seed=63, max_labels=6)
    numbers[f"{name}_serving"] = time_att_serving(task, model, dev, gpu, name, beam)
    counts["csj_serving"] = serve_att_requests(task, model, gpu, name, beam=beam,
                                               layers=raw["num_layers"], units=units,
                                               label_type=raw["label_type"])
    del model
    layers = raw["num_layers"]
    numbers[f"{name}_train_step"] = time_train_steps(
        name, task, att_task, params, dev, gpu, args.profile_out,
        dict(att_walk, lstm_bidi_fwd=layers, lstm_bidi_bwd=layers), layers,
        shape=f"T=1198 -> VGG -> T'={CSJ_T}", global_step=FAMILY_TRAIN_STEP)
    counts["csj_training"] = train_one_epoch(name, raw, gpu, fwd_bwd + ("ctc_loss",
                                                                        "location_attend"),
                                             work / name)
    att_kernels = ("lstm_bidi_fwd", "location_attend", "ctc_loss_fwd_only")
    counts.update(family_clis(name, work / name, beam, att_kernels, gpu,
                              ["--beam-width", str(beam), "--joint-rescore", "--nbest", "2"]))
    clock(f"{name} card == CPU, served, trained, evaluated", t0)

    # 34. timit_multitask_ctc: 3 x BLSTM-256, the sub head after layer 2, greedy
    name, raw = "timit_multitask_ctc", raw_config("timit_multitask_ctc")
    layers = raw["num_layers"]
    task, units, params, cpu, model = family_models(raw, ctc_task, dev)
    check_model(task, cpu, model, dev, name)
    check_train_step(task, ctc_task, params, dev, seed=64)
    time_phases(task, model, dev, gpu, name, f"{layers} x BLSTM-{TIMIT_H}, sub head after "
                f"layer {raw['num_layers_sub']}", seconds=TIMIT_SECONDS)
    counts["timit_serving"] = serve_requests(
        task, model, gpu, name, per_batch={"lstm_bidi_fwd": layers},
        seconds_list=TIMIT_REQUEST_SECONDS, units=units, label_type=raw["label_type"])
    del model
    numbers[f"{name}_train_step"] = time_train_steps(
        name, task, ctc_task, params, dev, gpu, args.profile_out,
        dict(NONE_LAUNCHED, lstm_bidi_fwd=layers, lstm_bidi_bwd=layers, ctc_loss=2), layers,
        shape=f"T'={TIMIT_T}, main and sub CTC", seconds=TIMIT_SECONDS)
    counts["timit_training"] = train_one_epoch(name, raw, gpu, fwd_bwd + (
        "ctc_loss", "ctc_loss_fwd_only"), work / name)
    counts.update(family_clis(name, work / name, 1, ("lstm_bidi_fwd", "ctc_loss_fwd_only"),
                              gpu, []))
    clock(f"{name} card == CPU, served, trained, evaluated", t0)

    # 35. ls960_joint_bpe: 5 x pyramidal BLSTM-512 (2 levels), hybrid attention, BPE
    name, raw = "ls960_joint_bpe", raw_config("ls960_joint_bpe")
    beam, layers = raw["beam_width"], raw["num_layers"]
    half = lambda x: -(-x // 2)  # noqa: E731
    t_enc = half(half(-(-(1 + (SR - 400) // 160) // 3)))
    want = dict(att_walk, lstm_bidi_fwd=layers, lstm_bidi_bwd=layers)
    task, units, params, cpu, model = family_models(raw, att_task, dev)
    check_att_model(task, cpu, model, dev, name, beam=beam, t_enc=t_enc)
    check_train_step(family_task(raw, dropout=1.0, scheduled_sampling_prob=0.0)[0],
                     att_task, params, dev, seed=65, max_labels=2)
    numbers[f"{name}_serving"] = time_att_serving(task, model, dev, gpu, name, beam)
    counts["bpe_serving"] = serve_att_requests(task, model, gpu, name, beam=beam, layers=layers,
                                               units=units, label_type=raw["label_type"])
    del model
    numbers[f"{name}_train_step"] = time_train_steps(
        name, task, att_task, params, dev, gpu, args.profile_out, want, layers,
        shape=f"T=1198 -> 400 -> T'={BPE_T}, {len(units)} units", global_step=FAMILY_TRAIN_STEP)
    counts["bpe_training"] = train_one_epoch(name, raw, gpu, fwd_bwd + ("ctc_loss",
                                                                        "location_attend"),
                                             work / name)
    counts.update(family_clis(name, work / name, beam, att_kernels, gpu, [
        "--beam-width", str(beam), "--joint-rescore", "--nbest", "2", "--length-penalty",
        str(raw["length_penalty"])]))
    # the vocabulary bpe_1000 learns on LibriSpeech
    task, _, params, cpu, model = family_models(raw, att_task, dev, BPE_LIBRISPEECH_UNITS)
    # random weights make the 1031-way decoder softmax nearly uniform: near-ties
    # among the beam's candidates resolve differently on the card and the CPU
    # (seen in a run: other tokens, best scores 0.12 apart), so this beam is
    # reported, not held; the toy vocabulary's beam above is held
    check_att_model(task, cpu, model, dev, f"{name} at {BPE_LIBRISPEECH_UNITS} units",
                    beam=beam, t_enc=t_enc, hold_beam=False)
    del model
    numbers[f"{name}_{BPE_LIBRISPEECH_UNITS}_train_step"] = time_train_steps(
        f"{name}_{BPE_LIBRISPEECH_UNITS}", task, att_task, params, dev, gpu, args.profile_out,
        want, layers, shape=f"T'={BPE_T}, {BPE_LIBRISPEECH_UNITS} units",
        global_step=FAMILY_TRAIN_STEP, steps=3)
    clock(f"{name} card == CPU, served, trained, evaluated; {BPE_LIBRISPEECH_UNITS} units", t0)

    # 36. ls_word_ctc: 5 x BLSTM-512 on the hard corpus's 51 words, the prefix beam at 8
    name, raw = "ls_word_ctc", raw_config("ls_word_ctc")
    beam, layers = raw["beam_width"], raw["num_layers"]
    task, units, params, cpu, model = family_models(raw, ctc_task, dev)
    check_model(task, cpu, model, dev, name)
    check_train_step(task, ctc_task, params, dev, seed=66)
    check_ctc_beam(task, model, dev, name, beam=beam)
    time_phases(task, model, dev, gpu, name, f"{layers} x BLSTM-{raw['num_units']}")
    numbers[f"{name}_prefix_beam"] = time_ctc_beam(task, model, dev, gpu, name, beam=beam)
    counts["word_serving"] = serve_requests(
        task, model, gpu, name, per_batch={"lstm_bidi_fwd": layers}, units=units,
        label_type=raw["label_type"], beam_width=beam)
    del model
    numbers[f"{name}_train_step"] = time_train_steps(
        name, task, ctc_task, params, dev, gpu, args.profile_out,
        dict(NONE_LAUNCHED, lstm_bidi_fwd=layers, lstm_bidi_bwd=layers, ctc_loss=1), layers)
    counts["word_training"] = train_one_epoch(name, raw, gpu, fwd_bwd + (
        "ctc_loss", "ctc_loss_fwd_only"), work / name)
    counts.update(family_clis(name, work / name, beam, ("lstm_bidi_fwd", "ctc_loss_fwd_only"),
                              gpu, ["--beam-width", str(beam), "--nbest", "2"]))
    clock(f"{name} card == CPU, served, trained, evaluated", t0)
    return counts, kernels, numbers


# ---- streaming recognition and the transducer beam (phases 37-43) ----------------

STREAM_CHUNK = SR // 10  # 100 ms
# ragged streams: four end on a chunk boundary (the -1 flush of the stacked
# configs), four mid-chunk (a partial final chunk)
STREAM_SECONDS = (12.0, 11.55, 10.0, 8.53, 6.5, 4.47, 2.0, 1.02)
# config -> (beam width of its beam stream, 1 for none; LM fusion in that beam)
STREAM_CONFIGS = {"ls_streaming_ctc": (8, True), "ls_transducer": (4, True),
                  "ls_streaming_conformer": (1, False), "ls_conformer_transducer": (1, False)}
STREAM_TIMED_STEPS = 20
STREAM_LM_SECONDS = 4.0  # the fused beam streams: the first 4 s of each row
LM_WEIGHT = 0.3
# kernel #3 with a carried state at the chunk step's shapes: 100 ms is 10
# frames of 40 mel (ls_streaming_ctc) or at most 5 windows of 3 x 40
# (ls_transducer, 3/3 stacking: (3 - 1 + 10) // 3 + 1)
CARRY_SHAPES = {"ls_streaming_ctc": (10, 40), "ls_transducer": (5, 120)}


def carry_work(lengths, t: int, d: int) -> dict:
    """#3 with a carried state: xproj, wh, mask, h0, c0 read; ys, hT, cT
    written; float32 operations of the valid steps."""
    b = len(lengths)
    moved = (b * t * 4 * H + H * 4 * H + b * t + b * t * H + 4 * b * H) * F32
    return bound(moved, float(sum(lengths)) * (2 * H * 4 * H + 30 * H))


def check_carry_kernel(dev, gpu: str) -> dict:
    """Phase 43: kernel #3 resuming from a random carried (h0, c0) at both
    streaming chunk shapes, against its plain version, with lengths 0..T:
    rows at 0 (paused streams) must give back h0 and c0 bit for bit."""
    out = {}
    for name, (t, d) in CARRY_SHAPES.items():
        lengths = [t, 0, t, t - 1, 3, t, 1, 0]
        args, xs, _ = layer_inputs(dev, B, lengths, seed=60 + t, t=t, d=d)
        g = torch.Generator().manual_seed(61 + t)
        state = tuple((torch.randn(B, H, generator=g) * 0.5).to(dev) for _ in range(2))

        def kernel():
            ys, (h_t, c_t) = lstm.lstm_layer(*args, initial_state=state)
            return ys, h_t, c_t

        plain = lambda: lstm.lstm_layer_fwd_plain(*args, initial_state=state)  # noqa: E731
        torch.manual_seed(62)
        net = torch.nn.LSTM(d, H, batch_first=True).to(dev)
        cudnn = lambda: net(xs, (state[0][None], state[1][None]))  # noqa: E731
        with torch.no_grad():
            ys, h_t, c_t = kernel()
            want_ys, _, (want_h, want_c) = plain()
            torch.cuda.synchronize()
            shape = f"B={B} T={t} D={d} H={H}"
            err = check(f"lstm_layer_fwd_carry ({name} chunk) {shape}", [ys, h_t, c_t],
                        [want_ys, want_h, want_c], KERNEL_ATOL)
            paused = torch.tensor(lengths, device=dev) == 0
            if not (torch.equal(h_t[paused], state[0][paused])
                    and torch.equal(c_t[paused], state[1][paused]) and not ys[paused].any()):
                raise RuntimeError("lstm_layer_fwd_carry: a row with no valid step did not "
                                   "give back its (h0, c0) bit for bit")
            launches = device_launches(kernel)
            r = plain_kernel_ms(plain, kernel, 5, 50)
            library = cuda_ms(cudnn, 50)
            graph = graph_ms(kernel, 50)
            library_graph = graph_ms(cudnn, 50)
            extras = forward_extras(f"lstm_layer_fwd_carry ({name} chunk)", kernel, 1, B, dev,
                                    {"ms": graph}, t)
        out[name] = dict(r, ms=graph, eager_ms=r["ms"], max_abs_err=err, library_ms=library,
                         library_graph_ms=library_graph, device_launches=launches, shape=shape,
                         **extras, **carry_work(lengths, t, d))
        print(f"phase lstm_layer_fwd_carry ({name} chunk) {shape}, lengths {lengths}: kernel "
              f"{graph * 1e3:.2f} us from graph replays ({graph * 1e3 / t:.2f} us per step; "
              f"eager CUDA events {r['ms'] * 1e3:.2f} us, runs "
              f"{r['ms_runs'][0] * 1e3:.2f}, {r['ms_runs'][1] * 1e3:.2f}), plain "
              f"{r['plain_ms']:.3f} ms, bound {out[name]['bound_ms'] * 1e3:.3f} us "
              f"({out[name]['bound_by']}), cuDNN unidirectional nn.LSTM with (h0, c0), all "
              f"T steps (packing refuses length-0 rows): {library * 1e3:.2f} us eager, "
              f"{library_graph * 1e3:.2f} us from graph replays; device launches per call "
              f"{ {k: (v['per_call'], round(v['us'], 2)) for k, v in launches.items()} }"
              f"  [{gpu}]", flush=True)
        walks = [v["per_call"] for k, v in launches.items() if "fwd_walk" in k]
        if walks != [1.0]:
            raise RuntimeError(f"lstm_layer_fwd_carry: device launches {launches}; expected "
                               "one fwd_walk per call")
    return out


def stream_rows(fns, wav: np.ndarray, lens, order=None, check_paused: bool = False):
    """Drive ``fns`` (``build_streaming_fn``'s) over ``wav`` [B, N] in 100 ms
    chunks: each row's chunks in turn, then the -1 flush of a row that ends
    on a chunk boundary. ``order`` lists the rows fed at each step (the
    others paused; default all rows, chunk count + 1 steps). With
    ``check_paused`` a paused row's whole state must come back bit for bit.
    Returns (final state, each row's tokens, steps run)."""
    init_fn, step_fn = fns[:2]
    b, c = wav.shape[0], STREAM_CHUNK
    n_chunks = -(-int(max(lens)) // c)
    state, rows, nxt = init_fn(b), [[] for _ in range(b)], [0] * b
    steps = order or [list(range(b))] * (n_chunks + 1)
    for fed in steps:
        piece, cl = np.zeros((b, c), np.float32), np.zeros((b,), np.int32)
        for r in fed:
            k = nxt[r]
            if k < n_chunks:
                piece[r] = wav[r, k * c: (k + 1) * c]
                cl[r] = min(max(lens[r] - k * c, 0), c)
            elif k == n_chunks and lens[r] % c == 0:
                cl[r] = -1
            nxt[r] += 1
        before = state
        state, tok, n = step_fn(state, piece, cl)
        if check_paused:
            paused = torch.tensor([r not in fed for r in range(b)])
            same = []
            streaming.tree_map(lambda x, y: same.append(torch.equal(
                x[paused.to(x.device)], y[paused.to(x.device)])), state, before)
            if not all(same):
                raise RuntimeError("a paused stream's state changed")
        tok, n = tok.cpu().numpy(), n.cpu().numpy()
        for r in range(b):
            rows[r].extend(tok[r, : n[r]].tolist())
    return state, rows, len(steps)


def stream_audio(seconds, seed: int) -> tuple:
    rng = np.random.RandomState(seed)
    lens = [int(round(s * SR)) for s in seconds]
    wav = (rng.randn(len(lens), max(lens)) * 0.1).astype(np.float32)
    for r, n in enumerate(lens):
        wav[r, n:] = 0.0
    return wav, lens


def offline_decode(task, model, wav, lens, dev, beam: int = 0, max_len: int | None = None,
                   lm=None):
    """The port's offline decode of the same audio on ``dev``: greedy ids per
    row, or with ``beam`` the beam's (tokens, lengths, scores)."""
    is_ctc = isinstance(task, ctc_task.CTCTaskConfig)
    with torch.inference_mode():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(dev),
                                           "input_len": torch.tensor(lens, device=dev)})
        fusion = None if lm is None else make_fusion_lm(lm, task.model.vocab_with_blank)
        lm_weight = LM_WEIGHT if lm is not None else 0.0
        if is_ctc:
            out = model(feats, fl)
            if beam:
                return ctc_prefix_beam_search(out.logits, out.logit_len, task.model.blank_id,
                                              beam_width=beam, max_prefix_len=max_len,
                                              fusion_lm=fusion, lm_weight=lm_weight)
            ids, n = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
        else:
            f_proj, enc_len = model.encode(feats, fl)
            if beam:
                return tuple(transducer_beam_search(model, f_proj, enc_len, beam_width=beam,
                                                    max_len=max_len, fusion_lm=fusion,
                                                    lm_weight=lm_weight))
            ids, n = transducer_greedy_decode(model, f_proj, enc_len)
    return [ids[i, : n[i]].tolist() for i in range(len(lens))]


def stream_models(name: str, dev, **overrides):
    """(raw config, task, units, CPU model, card model) of ``configs/<name>.yml``
    with ``overrides``."""
    raw = dict(raw_config(name), **overrides)
    task, units = family_task(raw)
    mod = transducer_task if raw["model_type"] == "transducer" else ctc_task
    cpu = mod.init_model(task, torch.Generator().manual_seed(0)).eval()
    return raw, task, units, cpu, copy.deepcopy(cpu).to(dev).eval()


def time_stream_step(fns, wav, lens, dev, gpu: str, what: str, want_walks: int,
                     counter: str = "lstm_layer_fwd") -> dict:
    """ms per chunk step at B = 8 with every row live (host clock, ending in a
    synchronize), one step's profile (device time, busy share, device
    launches, ``fwd_walk`` launches) and its walk launches on ``counter``
    (``lstm_layer.launches``, or the bf16-product walk's); the plain LSTM
    step must not run."""
    init_fn, step_fn = fns[:2]
    state, c = init_fn(B), STREAM_CHUNK
    full = np.full((B,), c, np.int32)
    chunks = [wav[:, k * c: (k + 1) * c] for k in range(STREAM_TIMED_STEPS + 5)]
    for k in range(5):  # past the start-up frames
        state, _, _ = step_fn(state, chunks[k], full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(5, 5 + STREAM_TIMED_STEPS):
        state, _, n = step_fn(state, chunks[k], full)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / STREAM_TIMED_STEPS

    def refuse(*args, **kw):
        raise RuntimeError("the plain LSTM step ran on the streaming path")

    plain, lstm.lstm_layer_fwd_plain = lstm.lstm_layer_fwd_plain, refuse
    try:
        reset_counts()
        step_fn(state, chunks[0], full)
        counts = read_counts()
        for _ in range(3):  # a profile that lost walk launches is read again
            wall, busy, kernels = device_busy(lambda: step_fn(state, chunks[0], full))
            walks = sum(k[2] for k in kernels if "fwd_walk" in k[0])
            if walks >= want_walks:
                break
    finally:
        lstm.lstm_layer_fwd_plain = plain
    launches = sum(k[2] for k in kernels)
    print(f"phase {what} chunk step, B={B} x 100 ms: {ms:.3f} ms per step (host clock, "
          f"{STREAM_TIMED_STEPS} steps); one step profiled: {wall:.3f} ms wall, {busy:.3f} ms "
          f"of device time ({100 * busy / wall:.1f} % busy), {launches} device launches, "
          f"{walks} fwd_walk (#3) launches, {counter} launches {counts[counter]}; "
          f"top kernels:  [{gpu}]", flush=True)
    for key, t, k in kernels[:5]:
        print(f"  {t:9.3f} ms  {k:6d} launches  {key[:90]}", flush=True)
    if walks != want_walks or counts != dict(NONE_LAUNCHED, **{counter: want_walks}):
        raise RuntimeError(f"{what}: {walks} fwd_walk device launches and counts {counts} per "
                           f"step; expected {want_walks}")
    return {"step_ms": ms, "profile_wall_ms": wall, "device_ms": busy,
            "busy": busy / wall, "device_launches": launches, "fwd_walk_launches": walks}


def transducer_beams_agree(what: str, got, want, versus: str = "card vs CPU") -> None:
    """Transducer beams (tokens, lengths, scores): tokens and lengths equal,
    scores within MODEL_ATOL + BEAM_SCORE_RTOL x |score|."""
    got, want = [x.cpu() for x in got], [x.cpu() for x in want]
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = float((got[2] - want[2]).abs().max())
    print(f"{what}, {versus}: tokens and lengths equal: {same}, scores max abs err {err:.3e}, best "
          f"lengths {got[1][:, 0].tolist()}", flush=True)
    if not (same and bool(((got[2] - want[2]).abs()
                           <= MODEL_ATOL + BEAM_SCORE_RTOL * want[2].abs()).all())):
        raise RuntimeError(f"{what} disagree")


def run_stream_config(name: str, dev, gpu: str, lm_cpu, lm_dev) -> dict:
    """Phases 37-40, one per streaming config, at full width (8 x 12 s, 100 ms
    chunks): greedy and its beam stream against the port's offline decode on
    the card, the fused beam, card against CPU on 2 x 1 s, a paused and
    resumed session, and the chunk step timed and profiled."""
    raw, task, units, cpu, model = stream_models(name, dev)
    beam, fused = STREAM_CONFIGS[name]
    is_ctc = isinstance(task, ctc_task.CTCTaskConfig)
    is_lstm = raw["encoder_type"] == "lstm"
    walks = raw["num_layers"] if is_lstm else 0
    wav, lens = stream_audio(STREAM_SECONDS, seed=63)
    t0 = time.perf_counter()
    greedy = streaming.build_streaming_fn(task, model, STREAM_CHUNK)
    reset_counts()
    _, rows, steps = stream_rows(greedy, wav, lens)
    counts = read_counts()
    if counts != dict(NONE_LAUNCHED, lstm_layer_fwd=walks * steps):
        raise RuntimeError(f"{name} stream launches {counts} over {steps} steps")
    want = offline_decode(task, model, wav, lens, dev)
    print(f"phase {name} greedy stream, {B} x {max(STREAM_SECONDS):g} s in 100 ms chunks "
          f"({steps} steps, {time.perf_counter() - t0:.1f} s): tokens equal the offline "
          f"decode: {rows == want}; tokens per row {[len(r) for r in rows]}; launches "
          f"{counts}  [{gpu}]", flush=True)
    if rows != want or not any(rows):
        raise RuntimeError(f"{name}: the chunked greedy tokens differ from the offline decode")
    numbers = {"greedy": time_stream_step(greedy, wav, lens, dev, gpu, f"{name} greedy", walks)}

    # card against CPU on 2 x 1 s, greedy (and the beam below)
    short, short_lens = stream_audio((1.0, 0.63), seed=64)
    got = stream_rows(greedy, short, short_lens)[1]
    cpu_rows = stream_rows(streaming.build_streaming_fn(task, cpu, STREAM_CHUNK), short,
                           short_lens)[1]
    print(f"{name} greedy stream on 2 x 1 s, card vs CPU: tokens equal {got == cpu_rows}",
          flush=True)
    if got != cpu_rows:
        raise RuntimeError(f"{name}: the card's stream disagrees with the CPU's")
    numbers["tokens_per_row"] = [len(r) for r in rows]

    if beam > 1:
        t_out = frames_out(task, max(lens)) * (1 if is_ctc else task.model.max_symbols_per_frame)
        kw = dict(beam_width=beam, max_prefix_len=t_out)
        fns = streaming.build_streaming_fn(task, model, STREAM_CHUNK, **kw)
        t0 = time.perf_counter()
        state, beam_rows, _ = stream_rows(fns, wav, lens)
        final = fns[2](state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = offline_decode(task, model, wav, lens, dev, beam, t_out)
        agree = beams_agree if is_ctc else transducer_beams_agree
        agree(f"{name} beam W={beam} stream finalized, {B} x 12 s ({wall:.1f} s)", final,
              want, "vs the offline beam on the card")
        if beam_rows != rows:
            raise RuntimeError(f"{name}: the beam stream's live greedy partials differ")
        numbers["beam"] = time_stream_step(fns, wav, lens, dev, gpu, f"{name} beam W={beam}",
                                           walks)
        # card vs CPU on 2 x 1 s, and a paused and resumed session on the card
        fns_s = streaming.build_streaming_fn(task, model, STREAM_CHUNK, beam_width=beam,
                                             max_prefix_len=200)
        cpu_fns = streaming.build_streaming_fn(task, cpu, STREAM_CHUNK, beam_width=beam,
                                               max_prefix_len=200)
        st_card, rows_card, n_steps = stream_rows(fns_s, short, short_lens)
        st_cpu, rows_cpu, _ = stream_rows(cpu_fns, short, short_lens)
        agree(f"{name} beam W={beam} stream on 2 x 1 s", fns_s[2](st_card),
              cpu_fns[2](st_cpu))
        if rows_card != rows_cpu:
            raise RuntimeError(f"{name}: the card's beam stream partials disagree with the CPU")
        order = [[0, 1], [0], [1], [], [0, 1], [1], [0]] + [[0, 1]] * n_steps
        st_paused, rows_paused, _ = stream_rows(fns_s, short, short_lens, order,
                                                check_paused=True)
        same = rows_paused == rows_card and all(
            torch.equal(x, y) for x, y in zip(fns_s[2](st_paused), fns_s[2](st_card)))
        print(f"{name} paused and resumed session (row 1 paused 3 steps, row 0 2, one step "
              f"with every row paused) vs straight: tokens and the finalized beam equal bit for "
              f"bit: {same}; every paused row's state kept bit for bit", flush=True)
        if not same:
            raise RuntimeError(f"{name}: a paused and resumed session differs")
        if fused:
            lm_seconds = [min(s, STREAM_LM_SECONDS) for s in STREAM_SECONDS]
            lm_wav, lm_lens = stream_audio(lm_seconds, seed=65)
            t_lm = frames_out(task, max(lm_lens)) * (1 if is_ctc else
                                                     task.model.max_symbols_per_frame)
            fns_lm = streaming.build_streaming_fn(task, model, STREAM_CHUNK, beam_width=beam,
                                                  max_prefix_len=t_lm, lm=lm_dev,
                                                  lm_weight=LM_WEIGHT)
            st_lm = stream_rows(fns_lm, lm_wav, lm_lens)[0]
            agree(f"{name} beam W={beam} with the RNN-LM fused at {LM_WEIGHT}, "
                  f"{B} x {STREAM_LM_SECONDS:g} s", fns_lm[2](st_lm),
                  offline_decode(task, model, lm_wav, lm_lens, dev, beam, t_lm, lm_dev),
                  "stream vs the offline fused beam on the card")
            cpu_lm = streaming.build_streaming_fn(task, cpu, STREAM_CHUNK, beam_width=beam,
                                                  max_prefix_len=200, lm=lm_cpu,
                                                  lm_weight=LM_WEIGHT)
            fns_lm_s = streaming.build_streaming_fn(task, model, STREAM_CHUNK, beam_width=beam,
                                                    max_prefix_len=200, lm=lm_dev,
                                                    lm_weight=LM_WEIGHT)
            agree(f"{name} fused beam stream on 2 x 1 s",
                  fns_lm_s[2](stream_rows(fns_lm_s, short, short_lens)[0]),
                  cpu_lm[2](stream_rows(cpu_lm, short, short_lens)[0]))
    else:
        order = [[0, 1], [0], [1], [], [0, 1], [1], [0]] + [[0, 1]] * 12
        rows_paused = stream_rows(greedy, short, short_lens, order, check_paused=True)[1]
        print(f"{name} paused and resumed session vs straight: tokens equal "
              f"{rows_paused == got}; every paused row's state kept bit for bit", flush=True)
        if rows_paused != got:
            raise RuntimeError(f"{name}: a paused and resumed session differs")
    return numbers


def serve_streams(dev, gpu: str) -> tuple:
    """Phase 41: ``bin/serve --stream`` (``make_stream_server``) on
    ls_streaming_ctc, greedy, 8 slots: 8 concurrent sessions, each posting 12
    s of audio in 100 ms posts at real time, then ending; a ninth session
    while all 8 are open gets 503. The launch counts are reset just before
    the sessions and read just after."""
    from tensorflow_end2end_speech_recognition_tpu_torch.bin.serve import make_stream_server

    _, task, units, _, model = stream_models("ls_streaming_ctc", dev)
    server = make_stream_server(task, model, B, chunk_ms=100.0, max_wait_ms=2.0, units=units,
                                label_type="character")
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    wav, lens = stream_audio([12.0] * B, seed=66)
    audio_lat, end_lat, ids, errors = [], [], [None] * B, []

    def post(path, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", path, body, {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
        conn.close()
        return (*out, (time.perf_counter() - t0) * 1e3)

    def session(i, sid):
        try:
            got, start = [], time.perf_counter()
            for k in range(lens[i] // STREAM_CHUNK):
                # live audio: post k leaves at k x 100 ms
                time.sleep(max(0.0, start + 0.1 * k - time.perf_counter()))
                status, body, ms = post(f"/stream/audio?session={sid}",
                                        wav[i, k * STREAM_CHUNK: (k + 1) * STREAM_CHUNK]
                                        .tobytes())
                if status != 200:
                    raise RuntimeError(f"/stream/audio returned {status}: {body}")
                got += body["ids"]
                audio_lat.append(ms)
            status, body, ms = post(f"/stream/end?session={sid}")
            if status != 200:
                raise RuntimeError(f"/stream/end returned {status}: {body}")
            end_lat.append(ms)
            ids[i] = got + body["ids"]
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread below
            errors.append(e)

    try:
        reset_counts()
        server.batcher.steps_run = 0
        sids = [post("/stream/start")[1]["session"] for _ in range(B)]
        ninth = post("/stream/start")
        threads = [threading.Thread(target=session, args=(i, sid)) for i, sid in enumerate(sids)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts, steps = read_counts(), server.batcher.steps_run
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"a streaming session failed: {errors}")
    audio_lat.sort()
    end_lat.sort()
    want = offline_decode(task, model, wav, lens, dev)
    print(f"phase bin/serve --stream ls_streaming_ctc: {B} concurrent sessions of 12 s in "
          f"100 ms posts at real time ({wall:.1f} s wall, {steps} steps): /stream/audio p50 "
          f"{audio_lat[len(audio_lat) // 2]:.1f} ms, max {audio_lat[-1]:.1f} ms "
          f"({len(audio_lat)} posts); /stream/end p50 {end_lat[len(end_lat) // 2]:.1f} ms, max "
          f"{end_lat[-1]:.1f} ms; a ninth session: {ninth[0]} {ninth[1]}; tokens equal the "
          f"offline decode: {ids == want}; launches {counts}  [{gpu}]", flush=True)
    if ninth[0] != 503 or ids != want or counts != dict(NONE_LAUNCHED,
                                                       lstm_layer_fwd=4 * steps):
        raise RuntimeError(f"bin/serve --stream: ninth session {ninth}, tokens equal "
                           f"{ids == want}, launches {counts} over {steps} steps")
    return counts, {"audio_p50_ms": audio_lat[len(audio_lat) // 2],
                    "audio_max_ms": audio_lat[-1], "end_p50_ms": end_lat[len(end_lat) // 2],
                    "end_max_ms": end_lat[-1], "steps": steps, "ninth_status": ninth[0]}


def time_transducer_beam(dev, gpu: str, model_dir: Path) -> tuple:
    """Phase 42: the offline transducer beam at W = 4 on 8 x 12 s (ls_transducer):
    wall, and a profile of its first PROFILE_FRAMES frames; ``bin/eval`` and
    ``bin/decode`` at ``--beam-width 4`` on the model dir ``fit`` wrote."""
    _, task, _, _, model = stream_models("ls_transducer", dev)
    wav, lens = stream_audio([12.0] * B, seed=67)
    with torch.inference_mode():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(dev),
                                           "input_len": torch.tensor(lens, device=dev)})
        f_proj, enc_len = model.encode(feats, fl)
        search = lambda f, n: transducer_beam_search(model, f, n, beam_width=4)  # noqa: E731
        search(f_proj[:, :5], enc_len.clamp(max=5))  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = search(f_proj, enc_len)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        p_wall, busy, kernels = device_busy(lambda: search(f_proj[:, :PROFILE_FRAMES],
                                                           enc_len.clamp(max=PROFILE_FRAMES)))
    launches = sum(k[2] for k in kernels)
    print(f"phase ls_transducer offline beam W=4, {B} x 12 s (T'={f_proj.shape[1]}): "
          f"{wall:.1f} ms wall ({wall / f_proj.shape[1]:.3f} ms per frame), best lengths "
          f"{res.lengths[:, 0].tolist()}; its first {PROFILE_FRAMES} frames profiled: "
          f"{p_wall:.3f} ms wall, {busy:.3f} ms of device time ({100 * busy / p_wall:.1f} % "
          f"busy), {launches} device launches ({launches / PROFILE_FRAMES:.0f} per frame)  "
          f"[{gpu}]", flush=True)
    counts = {}
    for what, fn, argv in (
            ("bin/eval ls_transducer --beam-width 4", eval_cli.main,
             [str(model_dir), "--device", "cuda", "--beam-width", "4"]),
            ("bin/decode ls_transducer --beam-width 4 --nbest 2", decode_cli.main,
             [str(model_dir), "--device", "cuda", "--beam-width", "4", "--nbest", "2"])):
        out, counts[what.split()[0]] = run_cli(what, fn, argv, ("lstm_layer_fwd",), gpu)
        if what.startswith("bin/eval") and not all(
                np.isfinite(out[s]["error_rate"]) for s in ("dev", "test")):
            raise RuntimeError(f"{what} gave {out}")
        if what.startswith("bin/decode") and not any(s.startswith("  HYP2") for s in out):
            raise RuntimeError(f"{what} printed {out[:6]}")
    return {"wall_ms": wall, "frames": int(f_proj.shape[1]), "profile_frames": PROFILE_FRAMES,
            "profile_wall_ms": p_wall, "device_ms": busy, "busy": busy / p_wall,
            "device_launches": launches}, counts


def run_streaming(dev, gpu: str, work: Path, t0: float) -> tuple:
    """Phases 37-43. Returns (launch counts by path, kernel #3 with a carried
    state at both chunk shapes, the streaming numbers)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.models.lm import LMConfig, RNNLM

    # an RNN-LM over the 28 characters + sos / eos, the bin/train_lm default width
    lm_cpu = RNNLM(LMConfig(vocab=len(CHAR_UNITS) + 2),
                   torch.Generator().manual_seed(68)).eval()
    lm_dev = copy.deepcopy(lm_cpu).to(dev).eval()
    numbers = {}
    for name in STREAM_CONFIGS:
        numbers[name] = run_stream_config(name, dev, gpu, lm_cpu, lm_dev)
        clock(f"{name} streamed", t0)
    counts = {}
    counts["stream_serving"], numbers["serve_stream"] = serve_streams(dev, gpu)
    clock("bin/serve --stream", t0)
    numbers["transducer_beam"], cli = time_transducer_beam(dev, gpu, work / "ls_transducer")
    counts.update({f"transducer_beam_{k}": v for k, v in cli.items()})
    clock("the offline transducer beam, bin/eval and bin/decode at beam 4", t0)
    carry = check_carry_kernel(dev, gpu)
    clock("kernel #3 with a carried state checked", t0)
    return counts, carry, numbers


# ---- phases 44-48: compute_dtype bfloat16 ------------------------------------------

# bench.py's headline task (the JAX package's LS-960-shape BLSTM-CTC step): 5 x
# BLSTM-512, 40 mel + deltas without energy, 3/3 stacking, 28 classes, U = 40, Adam
# with clip 5.0, B = 128 x 12 s
B_HEAD, HEAD_SECONDS, HEAD_STEPS, HEAD_CLASSES = 128, 12.0, 10, 28
BF16 = "bfloat16"
BF16_STREAM = 2  # bytes of a bf16 stream element
# the bf16 kernels against their plain versions: both round the same float32
# walk's values, summed in other orders, so a value near a rounding boundary may
# land one way on each: two bf16 ulps; dWh sums T * B bf16 products in float32
BF16_ULPS = dict(atol=1e-5, rtol=8e-3)
BF16_DWH_RTOL = 1e-3  # of the largest entry
# card vs CPU at bf16 on 2 x 1 s: every layer's outputs are rounded to bf16, and
# a value whose float32 sum lands near a rounding boundary rounds one way on
# each device (a changed summation order on the CPU alone moves ls100_ctc's
# logits of about 1.6 by 7.7e-3, its loss by 2.2e-5 relative and its gradients
# by 1.1 % of their largest entry)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 2e-2  # of each gradient tensor's largest entry
BF16_LOGIT_ATOL = 5e-2  # logits, transducer f_proj; and the top-2 gap of a tie


def check_bf16(name: str, got, want) -> float:
    """``check`` of bf16 outputs against bf16 plain outputs, in float32, within
    two bf16 ulps; every output must be bf16."""
    if not all(g.dtype == torch.bfloat16 for g in got):
        raise RuntimeError(f"{name}: outputs {[g.dtype for g in got]} are not bf16")
    return check(name, [g.float() for g in got], [w.float() for w in want],
                 BF16_ULPS["atol"], BF16_ULPS["rtol"])


def events_once(fn) -> tuple:
    """(``fn()``, its device ms from CUDA events): one run, for a plain version
    too slow to repeat at the headline's batch."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cudnn_bf16_ms(dev, xs, lengths, seed: int, bidirectional: bool) -> tuple:
    """cuDNN ``nn.LSTM`` forward and backward ms with bf16 weights and inputs,
    or (None, None) and the reason where torch does not take it."""
    try:
        fwd, bwd = cudnn_lstm(dev, xs.detach().bfloat16(), lengths, seed, bidirectional, H,
                              dtype=torch.bfloat16)
        return cuda_ms(fwd, 5), cuda_ms(bwd, 5), None
    except RuntimeError as e:
        return None, None, str(e).splitlines()[0][:200]


def check_bf16_walks(dev, gpu: str, b: int, lengths, dirs: int, seed: int) -> dict:
    """Phase 44 at one shape: the bf16 forward (with ``cs``) and backward walks
    of ``dirs`` directions against their plain versions, ``dWh`` of the
    autograd Function against the plain chain, times beside the float32
    kernels at the same shape and cuDNN in bf16, device launches per call."""
    if dirs == 2:
        args32, xs, lens = lstm_inputs(dev, b, lengths, seed=seed, t=T_ENC, h=H)
        streams = 2
    else:
        args32, xs, lens = layer_inputs(dev, b, lengths, seed=seed, t=T_ENC)
        streams = 1
    xp32, whs, mask, fb = args32[:streams], args32[streams:2 * streams], args32[-2], args32[-1]
    xp = [x.bfloat16() for x in xp32]
    rng = np.random.RandomState(seed)
    gys = [torch.from_numpy(rng.randn(b, T_ENC, H).astype(np.float32)).to(dev).bfloat16()
           for _ in range(streams)]
    fname, bname = ("lstm_bidi_fwd", "lstm_bidi_bwd") if dirs == 2 else ("lstm_layer_fwd",
                                                                           "lstm_layer_bwd")
    fwd_k = getattr(lstm, fname)
    bwd_k = getattr(lstm, bname)
    fwd_p = getattr(lstm, f"{fname}_plain")
    bwd_p = getattr(lstm, f"{bname}_plain")
    shape = f"B={b} T={T_ENC} H={H}"
    out = {}
    with torch.no_grad():
        got = fwd_k(*xp, *whs, mask, fb, with_cs=True)
        want, plain_f = events_once(lambda: fwd_p(*xp, *whs, mask, fb))
        want = want[:2 * streams]
        fwd_err = check_bf16(f"{fname}_bf16 with cs {shape}", got, want)
        bwd_args = (*xp, *whs, mask, *want, *gys, fb)
        got_dx = bwd_k(*bwd_args)
        got_dx = got_dx if isinstance(got_dx, tuple) else (got_dx,)
        want_dx, plain_b = events_once(lambda: bwd_p(*bwd_args))
        want_dx = want_dx if isinstance(want_dx, tuple) else (want_dx,)
        bwd_err = check_bf16(f"{bname}_bf16 {shape}", got_dx, want_dx)
        # dWh: the Function's backward (kernel + the bf16 contraction) against the
        # plain reverse walk's dxproj through the same contraction
        fn = lstm.LSTMBidi if dirs == 2 else lstm.LSTMLayer
        ctx = types.SimpleNamespace(saved_tensors=(*xp, *whs, mask, *want), forget_bias=fb)
        grads = fn.backward(ctx, *gys)
        ys = want[:streams]
        for i in range(streams):
            w = lstm._dwh(ys[i], want_dx[i])
            scale = float(w.abs().max())
            check(f"{fn.__name__}.backward dWh[{i}] {shape} (max |dWh| {scale:.3e})",
                  [grads[streams + i] if dirs == 2 else grads[1]], [w], BF16_DWH_RTOL * scale)
        fwd_call = lambda: fwd_k(*xp, *whs, mask, fb, with_cs=True)  # noqa: E731
        bwd_call = lambda: bwd_k(*bwd_args)  # noqa: E731
        tf = [cuda_ms(fwd_call, 10) for _ in range(2)]
        tb = [cuda_ms(bwd_call, 10) for _ in range(2)]
        # the float32 kernels at the same shape, in turns with the bf16 ones
        want32 = fwd_k(*xp32, *whs, mask, fb, with_cs=True)
        bwd32 = (*xp32, *whs, mask, *want32, *(g.float() for g in gys), fb)
        fwd32 = lambda: fwd_k(*xp32, *whs, mask, fb, with_cs=True)  # noqa: E731
        f32 = cuda_ms(fwd32, 10)
        b32 = cuda_ms(lambda: bwd_k(*bwd32), 10)
        launches_f = device_launches(fwd_call, reps=3)
        launches_b = device_launches(bwd_call, reps=3)
        # the forward's own step trace, both stream types (a traced call, timed apart)
        traces = {"step_trace_us": lstm.fwd_step_phases(lstm.fwd_trace(fname, fwd_call)),
                  "float32_step_trace_us": lstm.fwd_step_phases(lstm.fwd_trace(fname, fwd32))}
    lib_f, lib_b, lib_err = cudnn_bf16_ms(dev, xs, lens, seed, dirs == 2)
    if lib_err:
        print(f"cuDNN nn.LSTM does not take bf16 here: {lib_err}", flush=True)
    lib32_f = cuda_ms(cudnn_lstm(dev, xs, lens, seed, dirs == 2)[0], 5)
    for name, err, runs, plain, f32_ms, lib, launches, bwd in (
            (f"{fname}_bf16", fwd_err, tf, plain_f, f32, lib_f, launches_f, False),
            (f"{bname}_bf16", bwd_err, tb, plain_b, b32, lib_b, launches_b, True)):
        r = dict(ms=sum(runs) / 2, ms_runs=runs, plain_ms=plain, max_abs_err=err,
                 float32_ms=f32_ms, library_ms=lib, library_note=lib_err,
                 us_per_step=sum(runs) / 2 * 1e3 / T_ENC,
                 device_launches={k: v["per_call"] for k, v in launches.items()},
                 **lstm_work(lengths, H, with_cs=True, backward=bwd, t=T_ENC, dirs=dirs,
                             elem=BF16_STREAM))
        if not bwd:
            r.update(traces, library_float32_ms=lib32_f)
        out[name] = r
        print(f"phase {name} {shape}{' with cs' if not bwd else ''}: kernel {r['ms']:.3f} ms "
              f"(runs {runs[0]:.3f}, {runs[1]:.3f}; {r['us_per_step']:.2f} us per step), "
              f"float32 kernel {f32_ms:.3f} ms, plain {plain:.3f} ms (one run), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuDNN nn.LSTM bf16 "
              f"{'backward' if bwd else 'forward'} "
              + (f"{lib:.3f} ms" if lib is not None else "not taken")
              + ("" if bwd else f", cuDNN nn.LSTM float32 forward {lib32_f:.3f} ms; a traced "
                 "call's step phases (us, block 0), bf16 "
                 + ", ".join(f"{k} {x:.2f}" for k, x in traces["step_trace_us"].items())
                 + ", float32 "
                 + ", ".join(f"{k} {x:.2f}" for k, x in traces["float32_step_trace_us"].items()))
              + f", device launches per call {r['device_launches']}  [{gpu}]", flush=True)
    return out


def check_forward_walks(dev, gpu: str, b: int, lengths, dirs: int, seed: int) -> dict:
    """Phase 44 at a further shape: #1 or #3 with ``cs`` in float32 and bf16
    streams against their plain versions (KERNEL_ATOL; two bf16 ulps), two
    calls equal bit for bit, one launch per call with the clusters the plan
    takes at B, the kernel's time and its own step trace."""
    if dirs == 2:
        args32, _, _ = lstm_inputs(dev, b, lengths, seed=seed, t=T_ENC, h=H)
        streams, kernel, plain = 2, lstm.lstm_bidi_fwd, lstm.lstm_bidi_fwd_plain
        counted = lstm.lstm_bidi
    else:
        args32, _, _ = layer_inputs(dev, b, lengths, seed=seed, t=T_ENC)
        streams, kernel, plain = 1, lstm.lstm_layer_fwd, lstm.lstm_layer_fwd_plain
        counted = lstm.lstm_layer
    xp32, whs, mask, fb = args32[:streams], args32[streams:2 * streams], args32[-2], args32[-1]
    plan = lstm.fwd_plan_for(dev, H, dirs, b)
    path = (f"tensor cores, clusters of {plan.cluster}, Wh {'split' if plan.split else 'whole'}"
            if plan.cluster else f"FFMA, {plan.rows} rows a chunk")
    shape = f"B={b} T={T_ENC} H={H} with cs, lengths {min(lengths)}..{max(lengths)}"
    out = {}
    with torch.no_grad():
        for bf16 in (False, True):
            xp = [x.bfloat16() for x in xp32] if bf16 else xp32
            call = lambda: kernel(*xp, *whs, mask, fb, with_cs=True)  # noqa: E731
            name = kernel.__name__ + ("_bf16" if bf16 else "")
            count = "launches_bf16" if bf16 else "launches"
            before = getattr(counted, count)
            got, again = call(), call()
            torch.cuda.synchronize()
            if getattr(counted, count) != before + 2:
                raise RuntimeError(f"{name}: {getattr(counted, count) - before} launches in 2 "
                                   "calls")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"{name} {shape}: two calls on the same inputs differ")
            want = plain(*xp, *whs, mask, fb)
            err = (check_bf16(f"{name} {shape}", got, want) if bf16
                   else check(f"{name} {shape}", got, want, KERNEL_ATOL))
            runs = [cuda_ms(call, 10) for _ in range(2)]
            trace = lstm.fwd_step_phases(lstm.fwd_trace(kernel.__name__, call))
            r = dict(ms=sum(runs) / 2, ms_runs=runs, max_abs_err=err,
                     us_per_step=sum(runs) / 2 * 1e3 / T_ENC, deterministic=True,
                     path=path, step_trace_us=trace,
                     **lstm_work(lengths, H, with_cs=True, backward=False, t=T_ENC, dirs=dirs,
                                 elem=BF16_STREAM if bf16 else F32))
            out[name] = r
            print(f"phase {name} {shape} ({path}): kernel {r['ms']:.3f} ms (runs "
                  f"{runs[0]:.3f}, {runs[1]:.3f}; {r['us_per_step']:.2f} us per step), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}; FFMA "
                  f"{r['bound_ffma_ms']:.4f}), max abs err {err:.3e}, two "
                  "calls bitwise equal, one launch per call; a traced call's step phases (us, "
                  "block 0): " + ", ".join(f"{k} {x:.2f}" for k, x in trace.items())
                  + f"  [{gpu}]", flush=True)
    return out


def check_backward_walks(dev, gpu: str, b: int, lengths, dirs: int, seed: int) -> dict:
    """Phase 44 at a further shape: #2 or #4 in float32 and bf16 streams
    against their plain versions (BWD_ATOL; two bf16 ulps) from the plain
    forward's streams, two calls equal bit for bit, one launch per call,
    and the kernel's time."""
    if dirs == 2:
        args32, _, _ = lstm_inputs(dev, b, lengths, seed=seed, t=T_ENC, h=H)
        streams, kernel, plain = 2, lstm.lstm_bidi_bwd, lstm.lstm_bidi_bwd_plain
    else:
        args32, _, _ = layer_inputs(dev, b, lengths, seed=seed, t=T_ENC)
        streams, kernel, plain = 1, lstm.lstm_layer_bwd, lstm.lstm_layer_bwd_plain
    xp32, whs, mask, fb = args32[:streams], args32[streams:2 * streams], args32[-2], args32[-1]
    rng = np.random.RandomState(seed)
    gys32 = [torch.from_numpy(rng.randn(b, T_ENC, H).astype(np.float32)).to(dev)
             for _ in range(streams)]
    fwd_p = lstm.lstm_bidi_fwd_plain if dirs == 2 else lstm.lstm_layer_fwd_plain
    shape = f"B={b} T={T_ENC} H={H}, lengths {min(lengths)}..{max(lengths)}"
    out = {}
    with torch.no_grad():
        for bf16 in (False, True):
            cast = (lambda v: v.bfloat16()) if bf16 else (lambda v: v)  # noqa: E731
            xp, gys = [cast(x) for x in xp32], [cast(g) for g in gys32]
            fwd = fwd_p(*xp, *whs, mask, fb)
            args = (*xp, *whs, mask, *fwd[:2 * streams], *gys, fb)
            name = kernel.__name__ + ("_bf16" if bf16 else "")
            count = "launches_bf16" if bf16 else "launches"
            before = getattr(kernel, count)
            got, again = kernel(*args), kernel(*args)
            torch.cuda.synchronize()
            if getattr(kernel, count) != before + 2:
                raise RuntimeError(f"{name}: {getattr(kernel, count) - before} launches in 2 calls")
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"{name} {shape}: two calls on the same inputs differ")
            want = plain(*args)
            want = want if isinstance(want, tuple) else (want,)
            err = (check_bf16(f"{name} {shape}", got, want) if bf16
                   else check(f"{name} {shape}", got, want, BWD_ATOL))
            runs = [cuda_ms(lambda: kernel(*args), 10) for _ in range(2)]
            trace = lstm.bwd_step_phases(lstm.bwd_trace(kernel.__name__, lambda: kernel(*args)))
            r = dict(ms=sum(runs) / 2, ms_runs=runs, max_abs_err=err,
                     us_per_step=sum(runs) / 2 * 1e3 / T_ENC, deterministic=True,
                     step_trace_us=trace,
                     **lstm_work(lengths, H, with_cs=True, backward=True, t=T_ENC, dirs=dirs,
                                 elem=BF16_STREAM if bf16 else F32))
            out[name] = r
            print(f"phase {name} {shape}: kernel {r['ms']:.3f} ms (runs {runs[0]:.3f}, "
                  f"{runs[1]:.3f}; {r['us_per_step']:.2f} us per step), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}; FFMA {r['bound_ffma_ms']:.4f}), "
                  f"max abs err {err:.3e}, two calls bitwise equal, one launch per call; a "
                  "traced call's step phases (us, block 0; block barriers at the marks): "
                  + ", ".join(f"{k} {x:.2f}" for k, x in trace.items()) + f"  [{gpu}]",
                  flush=True)
    return out


def check_bf16_kernels(dev, gpu: str) -> dict:
    """Phase 44: #1-#4 in bf16 at the headline's shape (B=128, every row 12 s;
    the forward beside cuDNN's bf16 and float32 forward) and at B=32 with
    ragged lengths (1 and T among them); then #1-#4 in both stream types at
    B=128 with ragged lengths and at B=100, not a multiple of the 16-row
    tiles, and #1 and #3 at the serving batch B=8 (the FFMA product)."""
    rng = np.random.RandomState(44)
    ragged = [T_ENC, 1] + [int(x) for x in rng.randint(T_ENC // 2, T_ENC + 1, B_TRAIN - 2)]
    out = {}
    for dirs, seed in ((2, 44), (1, 45)):
        for b, lengths in ((B_HEAD, [T_ENC] * B_HEAD), (B_TRAIN, ragged)):
            for name, r in check_bf16_walks(dev, gpu, b, lengths, dirs, seed).items():
                out.setdefault(name, {})[f"b{b}"] = r
    for b in (B_HEAD, 100, B):
        lengths = [T_ENC, 1] + [int(x) for x in rng.randint(1, T_ENC + 1, b - 2)]
        for dirs, seed in ((2, 46), (1, 47)):
            # under the bf16 entry of the kernel, the float32 walk's beside it;
            # the backward's at B = 128 and 100, the forward's at B = 8 too
            walks = check_forward_walks(dev, gpu, b, lengths, dirs, seed + 10)
            if b != B:
                walks.update(check_backward_walks(dev, gpu, b, lengths, dirs, seed))
            for name, r in walks.items():
                bf16 = name.endswith("_bf16")
                out[name if bf16 else f"{name}_bf16"][
                    f"{'' if bf16 else 'float32_'}b{b}_ragged"] = r
    return out


def headline_task(compute_dtype: str):
    """bench.py's task in the port: 5 x BLSTM-512, 120 dims, 3/3 stacking, 28
    classes, ``compute_dtype`` float32 or bfloat16."""
    return ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(encoder_type="blstm", num_units=H,
                                              num_layers=LAYERS,
                                              compute_dtype=compute_dtype),
                        num_classes=HEAD_CLASSES),
        frontend=FrontendConfig(use_energy=False), num_stack=3, num_skip=3)


def headline_batch(seed: int = 0) -> dict:
    """bench.py's batch: B=128 x 12 s of 0.1 x normal noise, 40 labels each."""
    rng = np.random.RandomState(seed)
    n = int(HEAD_SECONDS * SR)
    return {"inputs": (rng.randn(B_HEAD, n) * 0.1).astype(np.float32),
            "input_len": np.full((B_HEAD,), n, np.int32),
            "labels": rng.randint(0, HEAD_CLASSES, (B_HEAD, U)).astype(np.int32),
            "label_len": np.full((B_HEAD,), U, np.int32),
            "weight": np.ones((B_HEAD,), np.float32)}


def check_bf16_step(task, task_mod, params_cpu, dev, name: str, seed: int = 46,
                    max_labels: int = 12) -> dict:
    """One bf16 train step's loss terms and gradients, card against CPU on 2 x 1
    s (dropout off): each term within BF16_LOSS_RTOL, each gradient within
    BF16_GRAD_RTOL of its largest entry. The CPU takes the card's max-pool
    decisions (``pool_decisions``: a VGG encoder's)."""
    batch = train_batch(2, 1.0, seed=seed, max_labels=max_labels)
    res, decisions, flips = [], [], []
    for replay, device in ((False, dev), (True, torch.device("cpu"))):
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        leaves = {k: v.to(device).clone().requires_grad_(True) for k, v in params_cpu.items()}
        with pool_decisions(decisions, replay, flips):
            loss, terms = task_mod.forward_loss(leaves, task, tb, True)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        res.append(({k: float(v.detach()) for k, v in terms.items()}, [g.cpu() for g in grads]))
    pools = task.model.encoder.has_vgg or task.model.encoder.is_cnn
    if decisions or (flips and not pools):
        raise RuntimeError(f"max-pool decisions left over: {len(decisions)}, flips {flips}")
    if flips:
        print(f"max-pools and ReLUs replayed on the CPU: {len(flips)} calls, {sum(flips)} "
              "windows or units whose CPU decision differs from the card's", flush=True)
    (tg, gg), (tc, gc) = res
    loss_err = max(abs(tc[k] - tg[k]) / abs(tc[k]) for k in tc)
    errs = {n: float((a - b).abs().max()) / max(float(a.abs().max()), 1e-12)
            for n, a, b in zip(params_cpu, gc, gg) if not zero_gradient(task, n)}
    worst = max(errs, key=errs.get)
    print(f"{name} bf16 train step on the card vs the CPU, 2 x 1 s: "
          + ", ".join(f"{k} {tg[k]:.4f} vs {tc[k]:.4f}" for k in tc)
          + f" (max rel err {loss_err:.2e}, tolerance {BF16_LOSS_RTOL:g}); grads max err / "
          f"max |g| {errs[worst]:.2e} ({worst}; tolerance {BF16_GRAD_RTOL:g}) over "
          f"{len(errs)} tensors", flush=True)
    if not (loss_err <= BF16_LOSS_RTOL and errs[worst] <= BF16_GRAD_RTOL):
        raise RuntimeError(f"the {name} bf16 train step on the card disagrees with the CPU")
    if not all(g.dtype == torch.float32 for g in gg):
        raise RuntimeError(f"{name}: bf16 gradients of the float32 master weights")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs[worst]}


def ids_with_ties(what: str, logits_card, logits_cpu, lengths) -> dict:
    """Card logits within BF16_LOGIT_ATOL of the CPU's on the valid frames, and
    the frames' argmax equal except where the CPU's top two logits lie within
    that tolerance (a near-tie that bf16 rounding may flip)."""
    valid = (torch.arange(logits_cpu.shape[1])[None] < lengths.cpu()[:, None])
    a, b = logits_card.float().cpu()[valid], logits_cpu.float()[valid]
    err = float((a - b).abs().max())
    top2 = b.topk(2, dim=-1).values
    flipped = a.argmax(-1) != b.argmax(-1)
    ties = (top2[:, 0] - top2[:, 1]) <= BF16_LOGIT_ATOL
    print(f"{what} card vs CPU at bf16: max abs err {err:.3e} (tolerance "
          f"{BF16_LOGIT_ATOL:g}) over {int(valid.sum())} frames; argmax differs on "
          f"{int(flipped.sum())} frames, {int((flipped & ~ties).sum())} of them not near-ties",
          flush=True)
    if not err <= BF16_LOGIT_ATOL or bool((flipped & ~ties).any()):
        raise RuntimeError(f"{what} at bf16 on the card disagrees with the CPU")
    return {"max_abs_err": err, "flipped_frames": int(flipped.sum())}


def run_headline(args, dev, gpu: str, t0: float) -> dict:
    """Phase 45: bench.py's step in the port, float32 and bf16, on one card."""
    out = {}
    batch = headline_batch()
    want = {"float32": dict(NONE_LAUNCHED, lstm_bidi_fwd=LAYERS, lstm_bidi_bwd=LAYERS,
                            ctc_loss=1),
            BF16: dict(NONE_LAUNCHED, lstm_bidi_fwd_bf16=LAYERS, lstm_bidi_bwd_bf16=LAYERS,
                       ctc_loss=1)}
    for dtype in ("float32", BF16):
        task = headline_task(dtype)
        params = ctc_task.init_params(task, torch.Generator().manual_seed(0))
        if dtype == BF16:
            out["card_vs_cpu"] = check_bf16_step(task, ctc_task, params, dev, "headline")
        r = time_train_steps(f"headline {dtype}", task, ctc_task, params, dev, gpu,
                             args.profile_out, want[dtype], LAYERS, steps=HEAD_STEPS,
                             batch={k: v.copy() for k, v in batch.items()})
        print_kinds(f"headline {dtype}", r, gpu)
        out[dtype] = r
        clock(f"headline step ({dtype}) timed", t0)
    print(f"phase headline (bench.py's task, B={B_HEAD} x 12 s, U={U}, Adam, clip 5.0): "
          f"float32 {out['float32']['ms']:.3f} ms per step "
          f"({out['float32']['utts_per_sec']:.1f} utt/s, {out['float32']['peak_gib']:.3f} GiB, "
          f"{100 * out['float32']['busy_share']:.1f} % busy); bf16 {out[BF16]['ms']:.3f} ms "
          f"({out[BF16]['utts_per_sec']:.1f} utt/s, {out[BF16]['peak_gib']:.3f} GiB, "
          f"{100 * out[BF16]['busy_share']:.1f} % busy)  [{gpu}]", flush=True)
    return out


def serve_bf16(dev, gpu: str, params_cpu: dict) -> tuple:
    """Phase 46: ls100_ctc at bf16, ``build_inference_fn`` on the card against
    the CPU on the 8 request lengths (one batch padded to 12 s), then 8
    requests through ``bin/serve.make_server``."""
    task = experiment_from_dict(LS100_CTC | {"compute_dtype": BF16}).ctc_task(len(CHAR_UNITS))
    cpu = ctc_task.init_model(task)
    cpu.load_state_dict(params_cpu)
    model = copy.deepcopy(cpu).to(dev).eval()
    cpu.eval()
    rng = np.random.RandomState(3)
    n = int(max(REQUEST_SECONDS) * SR)
    wav = np.zeros((len(REQUEST_SECONDS), n), np.float32)
    lens = np.asarray([int(s * SR) for s in REQUEST_SECONDS], np.int32)
    for i, m in enumerate(lens):
        wav[i, :m] = rng.randn(m) * 0.1
    outs = []
    for m, device in ((model, dev), (cpu, torch.device("cpu"))):
        with torch.inference_mode():
            feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(device),
                                               "input_len": torch.from_numpy(lens).to(device)})
            logits = m(feats, fl)
            ids, n_ids = build_inference_fn(task, m)(wav, lens)
        outs.append((logits.logits.cpu(), logits.logit_len.cpu(), ids.cpu(), n_ids.cpu()))
    (lg, ng, ig, cg), (lc, nc, ic, cc) = outs
    if not torch.equal(ng, nc):
        raise RuntimeError("ls100_ctc bf16: logit lengths differ between the card and the CPU")
    r = ids_with_ties("ls100_ctc logits (8 requests' lengths)", lg, lc, nc)
    same = torch.equal(ig, ic) and torch.equal(cg, cc)
    print(f"ls100_ctc bf16 greedy ids card == CPU: {same}", flush=True)
    if not same and r["flipped_frames"] == 0:
        raise RuntimeError("ls100_ctc bf16: ids differ with no flipped frame")
    counts = serve_requests(task, model, gpu, "ls100_ctc bf16",
                            per_batch={"lstm_bidi_fwd_bf16": LAYERS})
    return counts, dict(r, ids_equal=same)


def run_transducer_bf16(args, dev, gpu: str, t0: float) -> tuple:
    """Phase 47: ls_transducer at bf16: f_proj card vs CPU, one train step card
    vs CPU, timed train steps at B=32 x 12 s (4 #3 and 4 #4, bf16), and the
    greedy decode of 8 x 12 s (4 #3 bf16)."""
    raw = LS_TRANSDUCER | {"compute_dtype": BF16}
    task, params, cpu, model = conformer_models(raw, transducer_task, dev)
    batch = train_batch(2, 1.0, seed=47, max_labels=12)
    fps = []
    for m, device in ((model, dev), (cpu, torch.device("cpu"))):
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        with torch.inference_mode():
            fps.append(m.encode(*device_pipeline(task, tb)))
    (fg, eg), (fc, ec) = fps
    err = float((fg.cpu() - fc).abs().max())
    print(f"ls_transducer bf16 f_proj card vs CPU, 2 x 1 s: max abs err {err:.3e} (tolerance "
          f"{BF16_LOGIT_ATOL:g}), dtype {fg.dtype}", flush=True)
    if not err <= BF16_LOGIT_ATOL or fg.dtype != torch.float32 or not torch.equal(eg.cpu(), ec):
        raise RuntimeError("ls_transducer bf16 f_proj on the card disagrees with the CPU")
    step_check = check_bf16_step(task, transducer_task, params, dev, "ls_transducer", seed=48)
    r = time_train_steps("ls_transducer bf16", task, transducer_task, params, dev, gpu,
                         args.profile_out, dict(NONE_LAUNCHED, lstm_layer_fwd_bf16=TR_LAYERS,
                                                lstm_layer_bwd_bf16=TR_LAYERS), TR_LAYERS,
                         steps=TR_TIMED_STEPS)
    clock("ls_transducer bf16 train steps timed", t0)
    rng = np.random.RandomState(23)
    wav = torch.from_numpy((rng.randn(B, 12 * SR) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((B,), 12 * SR, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        feats, fl = device_pipeline(task, {"inputs": wav, "input_len": lens})
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f_proj, enc_len = model.encode(feats, fl)
        ids, n = transducer_greedy_decode(model, f_proj, enc_len)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        counts = read_counts()
    print(f"phase ls_transducer bf16 encoder + greedy decode, 8 x 12 s: {ms:.3f} ms, "
          f"{int(n.sum())} symbols, launches {counts}  [{gpu}]", flush=True)
    if counts != dict(NONE_LAUNCHED, lstm_layer_fwd_bf16=TR_LAYERS):
        raise RuntimeError(f"the ls_transducer bf16 decode launched {counts}")
    return r, {"card_vs_cpu": dict(step_check, f_proj_max_abs_err=err), "decode_ms": ms,
               "train_step": {k: r[k] for k in ("ms", "utts_per_sec", "peak_gib",
                                                 "busy_share", "launches")}}


def run_conformer_bf16(args, dev, gpu: str, float32: dict) -> dict:
    """Phase 48: the conformer CTC model at d=512 x 8 (``ls960_conformer_ctc.yml``'s
    scale for LibriSpeech-960, with its recommended ``compute_dtype: bfloat16``)
    card vs CPU in bf16, and its step timed in bf16 beside phase 31's float32
    step (``float32``)."""
    task, params, cpu, model = conformer_models(CONFORMER_WIDE | {"compute_dtype": BF16},
                                                ctc_task, dev)
    rng = np.random.RandomState(1)
    wav = (rng.randn(2, SR) * 0.1).astype(np.float32)
    lens = np.asarray([SR, 9600], np.int32)
    logits = []
    for m, device in ((model, dev), (cpu, torch.device("cpu"))):
        with torch.inference_mode():
            o = m(*device_pipeline(task, {"inputs": torch.from_numpy(wav).to(device),
                                          "input_len": torch.from_numpy(lens).to(device)}))
        logits.append((o.logits.cpu(), o.logit_len.cpu()))
    out = {"logits": ids_with_ties("conformer 512 x 8 logits, 2 x 1 s", logits[0][0],
                                   logits[1][0], logits[1][1]),
           "card_vs_cpu": check_bf16_step(task, ctc_task, params, dev, "conformer 512 x 8",
                                          seed=49)}
    del model
    r = time_train_steps("conformer_ctc_512x8 bf16", task, ctc_task, params, dev, gpu,
                         args.profile_out, dict(NONE_LAUNCHED, ctc_loss=1), 0, steps=3)
    print_kinds("conformer_ctc_512x8 bf16", r, gpu)
    keys = ("ms", "utts_per_sec", "peak_gib", "busy_share", "device_ms", "by_kind")
    out[BF16] = {k: r[k] for k in keys}
    out["float32"] = {k: float32[k] for k in keys}
    print(f"phase conformer_ctc_512x8 train step B={B_TRAIN} x 12 s: float32 (phase 31) "
          f"{float32['ms']:.3f} ms, bf16 {r['ms']:.3f} ms  [{gpu}]", flush=True)
    return out


def run_bf16(args, dev, gpu: str, t0: float, params_ls100: dict, conformer32: dict) -> tuple:
    """Phases 44-48. Returns (launch counts by path, the bf16 kernels' numbers,
    the other numbers)."""
    kernels = check_bf16_kernels(dev, gpu)
    clock("kernels #1-#4 in bf16 checked", t0)
    headline = run_headline(args, dev, gpu, t0)
    counts = {"bf16_headline": headline[BF16]["launches"],
              "float32_headline": headline["float32"]["launches"]}
    counts["bf16_serving"], serving = serve_bf16(dev, gpu, params_ls100)
    clock("ls100_ctc served at bf16", t0)
    tr_step, transducer = run_transducer_bf16(args, dev, gpu, t0)
    counts["bf16_transducer_training"] = tr_step["launches"]
    conformer = run_conformer_bf16(args, dev, gpu, conformer32)
    clock("the conformer at 512 x 8 in bf16 checked and timed", t0)
    numbers = {"headline": {k: {x: v[x] for x in ("ms", "utts_per_sec", "peak_gib",
                                                   "busy_share", "device_ms", "launches")}
                            if k in ("float32", BF16) else v for k, v in headline.items()},
               "ls100_ctc_serving": serving, "ls_transducer": transducer,
               "conformer_512x8": conformer}
    return counts, kernels, numbers


# ---- phases 49-52: the attention families at compute_dtype bfloat16 ----------------

# phase 49's calls of #7 on bf16 rows: rows per utterance, A, He, keys, seed
ATT_BF16_CASES = {
    "grouped": (BEAM, ATT_A, ATT_HE, True, 11),  # ls960_joint's beam-8 read
    "n8": (1, ATT_A, ATT_HE, True, 10),  # its greedy read
    "csj_grouped": (4, CSJ_A, CSJ_HE, False, 70),  # csj_joint's beam-4 read, no keys
}
BF16_ELEM = 2  # bytes of a bf16 encoder value


def check_attention_kernel_bf16(dev, gpu: str) -> dict:
    """Phase 49: #7 on bf16 encoder rows (``location_attend_bf16``) against
    its plain version on the same rows, at the float32 tolerances (both widen
    the rows exactly and sum in float32): ls960_joint's beam call (N=64,
    G=8) and greedy call (N=8), and csj_joint's beam call without keys
    (N=32, G=4, A=128, He=640), lengths that include 1, T and 0. Each: the
    launch counted on ``launches_bf16`` alone, float32 outputs, two calls
    bitwise equal and equal to the float32 kernel's on the same values
    widened (the same sums in the same order), two device launches per call
    (energies, context), the time from graph replays (plain, kernel, kernel,
    plain) beside that float32 kernel's and the bound."""
    out = {}
    for name, (group, a, he, keys, seed) in ATT_BF16_CASES.items():
        rng = np.random.RandomState(seed)
        lengths = [ATT_T, 1, 0] + [int(x) for x in rng.randint(1, ATT_T + 1, B_ATT - 3)]
        args, b = attend_inputs(dev, B_ATT, lengths, seed=seed, group=group, a=a, he=he)
        if not keys:
            args[0] = None  # a pure location scorer: b alone stands in the keys' place
        args[1] = args[1].bfloat16()
        wide = [*args[:1], args[1].float(), *args[2:]]  # the same values in float32
        kw = dict(b=b, group=group)
        shape = (f"N={B_ATT * group} (G={group}) T={ATT_T} A={a} He={he} C={ATT_C} W={ATT_W}"
                 + ("" if keys else ", no keys") + ", bf16 rows")
        reset_counts()
        got = attention.location_attend(*args, 1.0, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != dict(NONE_LAUNCHED, location_attend_bf16=1):
            raise RuntimeError(f"location_attend on bf16 rows launched {counts}")
        want = attention.location_attend_plain(*args, 1.0, **kw)
        if not all(x.dtype == torch.float32 for x in (*got, *want)):
            raise RuntimeError(f"location_attend on bf16 rows: outputs {[x.dtype for x in got]}")
        err = max(check(f"location_attend_bf16 {name} {shape}: align", got[1:], want[1:],
                        ATT_ALIGN_ATOL),
                  check(f"location_attend_bf16 {name} {shape}: ctx", got[:1], want[:1],
                        ATT_CTX_ATOL))
        for row, length in enumerate(x for x in lengths for _ in range(group)):
            if length == 0 and not torch.allclose(got[1][row], torch.full((ATT_T,), 1.0 / ATT_T,
                                                                           device=dev)):
                raise RuntimeError(f"location_attend_bf16 {name}: the length-0 row {row} is "
                                   "not 1/T")
        again = attention.location_attend(*args, 1.0, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
            raise RuntimeError(f"location_attend_bf16 {name}: two calls differ")
        # the float32 kernel on the same values runs the same sums in the same order
        same = attention.location_attend(*wide, 1.0, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(same[0], got[0]) and torch.equal(same[1], got[1])):
            raise RuntimeError(f"location_attend_bf16 {name}: the float32 kernel on the rows "
                               "widened gives other bits")
        kernel = lambda: attention.location_attend(*args, 1.0, **kw)  # noqa: E731
        plain = lambda: attention.location_attend_plain(*args, 1.0, **kw)  # noqa: E731
        float32 = lambda: attention.location_attend(*wide, 1.0, **kw)  # noqa: E731
        launches = device_launches(kernel)
        per_call = {k: v["per_call"] for k, v in launches.items()}
        if sorted(per_call.values()) != [1.0, 1.0]:
            raise RuntimeError(f"location_attend_bf16 {name}: device launches per call "
                               f"{per_call}; expected the energies and the context once each")
        p = [graph_ms(plain, 50)]
        k = [graph_ms(kernel, 50) for _ in range(2)]
        f32 = graph_ms(float32, 50)
        p.append(graph_ms(plain, 50))
        r = out[name] = dict(ms=sum(k) / 2, ms_runs=k, plain_ms=sum(p) / 2, plain_ms_runs=p,
                             float32_ms=f32, max_abs_err=err, library_ms=None,
                             deterministic=True, shape=shape, device_launches=launches,
                             **attend_work(lengths, group, a=a, he=he, keys=keys,
                                           enc_elem=BF16_ELEM))
        print(f"phase location_attend_bf16 {name} {shape}: kernel {r['ms'] * 1e3:.2f} us (runs "
              f"{k[0] * 1e3:.2f}, {k[1] * 1e3:.2f}; graph replays), float32 kernel on the rows "
              f"widened {f32 * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us (runs "
              f"{p[0] * 1e3:.2f}, {p[1] * 1e3:.2f}), bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}), no single library call, max abs err {err:.3e}, two calls "
              "bitwise equal and equal to the float32 kernel's, device launches per call "
              + ", ".join(f"{key} {v['per_call']:g} ({v['us']:.2f} us)"
                          for key, v in launches.items()) + f"  [{gpu}]", flush=True)
    return out


def greedy_flips(what: str, ids_card, ids_cpu, logits_card, logits_cpu) -> dict:
    """Greedy ids card against CPU at bf16: equal, except that a row may take
    another token where the CPU's top two logits lie within BF16_LOGIT_ATOL
    (a near-tie that a bf16 rounding flips; the row decodes apart after it).
    The logits of each row's steps up to its first difference within
    BF16_LOGIT_ATOL."""
    err, flips = 0.0, []
    for row in range(ids_cpu.shape[0]):
        diff = (ids_card[row] != ids_cpu[row]).nonzero()
        stop = int(diff[0]) if len(diff) else ids_cpu.shape[1] - 1
        err = max(err, float((logits_card[row, :stop + 1] - logits_cpu[row, :stop + 1])
                             .abs().max()))
        if len(diff):
            top2 = logits_cpu[row, stop].topk(2).values
            flips.append({"row": row, "step": stop, "top2_gap": float(top2[0] - top2[1])})
    print(f"{what} greedy card vs CPU at bf16: logits max abs err {err:.3e} up to each row's "
          f"first differing id (tolerance {BF16_LOGIT_ATOL:g}); ids equal: {not flips}"
          + (f"; rows that decode apart (the CPU's top-2 gap at the first difference): "
             f"{flips}" if flips else ""), flush=True)
    if not err <= BF16_LOGIT_ATOL or any(f["top2_gap"] > BF16_LOGIT_ATOL for f in flips):
        raise RuntimeError(f"{what} greedy at bf16 on the card disagrees with the CPU")
    return {"logits_max_abs_err": err, "ids_equal": not flips, "flips": flips}


def beam_ties(what: str, card, cpu) -> dict:
    """The best hypothesis after rescoring, card against CPU at bf16: equal, or
    a near-tie: the two hypotheses' scores within BF16_LOGIT_ATOL times (1 +
    the longer one's length) (a score sums that many log-probs, each within
    the logits' tolerance): the CPU's scores of both where its beam holds
    the card's best, else each device's own best score. Each difference is
    printed."""
    rows = []
    for row in range(cpu.tokens.shape[0]):
        if (torch.equal(card.tokens[row, 0], cpu.tokens[row, 0])
                and int(card.lengths[row, 0]) == int(cpu.lengths[row, 0])):
            continue
        held = [j for j in range(cpu.tokens.shape[1])
                if torch.equal(cpu.tokens[row, j], card.tokens[row, 0])]
        gap = float(cpu.scores[row, 0] - (cpu.scores[row, held[0]] if held
                                          else card.scores[row, 0]))
        longest = max(int(card.lengths[row, 0]), int(cpu.lengths[row, 0]))
        rows.append({"row": row, "score_gap": gap, "in_cpu_beam": bool(held),
                     "tolerance": BF16_LOGIT_ATOL * (1 + longest),
                     "card_len": int(card.lengths[row, 0]), "cpu_len": int(cpu.lengths[row, 0])})
    err = float((card.scores[:, 0] - cpu.scores[:, 0]).abs().max())
    print(f"{what} beam card vs CPU at bf16: best tokens equal: {not rows}; best scores max abs "
          f"err {err:.3e}" + (f"; near-ties: {rows}" if rows else ""), flush=True)
    if any(abs(r["score_gap"]) > r["tolerance"] for r in rows):
        raise RuntimeError(f"{what} beam at bf16: the card's best hypothesis is no near-tie of "
                           f"the CPU's: {rows}")
    return {"tokens_equal": not rows, "best_score_max_abs_err": err, "ties": rows}


def check_att_model_bf16(task, model_cpu, model_dev, dev, name: str, beam: int,
                         length_penalty: float) -> dict:
    """An attention config at bf16, card against CPU on 2 x 1 s: bf16 encoder
    rows on both, the CTC logits (joint models; ``ids_with_ties``), the
    greedy decode (``greedy_flips``) and, with ``beam``, the beam re-ranked
    by joint rescoring at the config's CTC weight (``beam_ties``)."""
    rng = np.random.RandomState(13)
    wav = (rng.randn(2, SR) * 0.1).astype(np.float32)
    lens = np.asarray([SR, 9600], np.int32)
    wav[1, 9600:] = 0.0
    cfg = task.model
    outs = []
    for model, device in ((model_cpu, torch.device("cpu")), (model_dev, dev)):
        with torch.inference_mode():
            feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(device),
                                               "input_len": torch.from_numpy(lens).to(device)})
            enc = seq2seq.encode(model, feats, fl)
            greedy = seq2seq.greedy_decode(model, feats, fl, precomputed=enc)
            res = None
            if beam:
                res = attention_beam_search(model, feats, fl, beam_width=beam,
                                            length_penalty=length_penalty, precomputed=enc)
                if cfg.is_joint:
                    res = joint_rescore(res, cfg.ctc_loss_weight, cfg.num_classes,
                                        length_penalty)
                res = res._replace(**{f: getattr(res, f).cpu()
                                      for f in ("tokens", "lengths", "scores")})
        outs.append((enc.outputs.dtype, enc.lengths.cpu(),
                     None if enc.ctc_logits is None else enc.ctc_logits.cpu(),
                     greedy.predicted_ids.cpu(), greedy.logits.cpu(), res))
    (dc, nc, cc, ic, gc, rc), (dg, ng, cg, ig, gg, rg) = outs
    if (dc, dg) != (torch.bfloat16, torch.bfloat16) or not torch.equal(nc, ng):
        raise RuntimeError(f"{name} at bf16: encoder rows {dc} / {dg}, lengths {nc} / {ng}")
    if not all(bool(torch.isfinite(x).all()) for x in (gg, *([cg] if cg is not None else []))):
        raise RuntimeError(f"{name} at bf16: outputs on the card are not finite")
    out = {"greedy": greedy_flips(name, ig, ic, gg, gc)}
    if cc is not None:
        out["ctc_logits"] = ids_with_ties(f"{name} CTC logits, 2 x 1 s", cg, cc, nc)
    if beam:
        out[f"beam{beam}"] = beam_ties(f"{name} beam-{beam}" + (" rescored" if cfg.is_joint
                                                               else ""), rg, rc)
    return out


def run_attention_bf16(args, dev, gpu: str, t0: float, joint32: dict) -> tuple:
    """Phases 49-52; ``joint32``: phase 17's float32 ls960_joint step, from the
    same run. Returns (launch counts by path, #7's bf16 numbers, the other
    numbers)."""
    kernel = check_attention_kernel_bf16(dev, gpu)
    clock("kernel #7 on bf16 rows checked", t0)
    counts, numbers = {}, {}
    # 50. ls960_joint at bf16, full width
    task = ls960_joint_task(compute_dtype=BF16)
    params = att_task.init_params(task, torch.Generator().manual_seed(0))
    cpu = att_task.init_model(task).eval()
    cpu.load_state_dict(params)
    model = copy.deepcopy(cpu).to(dev).eval()
    r = {"card_vs_cpu": check_att_model_bf16(task, cpu, model, dev, "ls960_joint", BEAM,
                                             LS960_JOINT["length_penalty"])}
    r["train_step_card_vs_cpu"] = check_bf16_step(
        ls960_joint_task(compute_dtype=BF16, dropout=1.0, scheduled_sampling_prob=0.0),
        att_task, params, dev, "ls960_joint", seed=27, max_labels=6)
    clock("ls960_joint bf16 card == CPU", t0)
    counts["bf16_att_serving"] = serve_att_requests(
        task, model, gpu, "ls960_joint bf16", walk="lstm_bidi_fwd_bf16",
        read="location_attend_bf16")
    del model
    step = time_train_steps(
        "ls960_joint bf16", task, att_task, params, dev, gpu, args.profile_out,
        dict(NONE_LAUNCHED, lstm_bidi_fwd_bf16=LAYERS, lstm_bidi_bwd_bf16=LAYERS, ctc_loss=1),
        LAYERS, shape=f"T={T_PYR} -> T'={ATT_T}", global_step=ATT_TRAIN_STEP)
    print_kinds("ls960_joint bf16", step, gpu)
    counts["bf16_att_training"] = step["launches"]
    keys = ("ms", "utts_per_sec", "peak_gib", "busy_share", "device_ms", "by_kind", "launches")
    r[BF16] = {k: step[k] for k in keys}
    r["float32"] = {k: joint32[k] for k in keys}
    print(f"phase ls960_joint train step B={B_TRAIN} x 12 s: float32 (phase 17) "
          f"{joint32['ms']:.3f} ms ({joint32['device_ms']:.3f} ms of device time, "
          f"{joint32['peak_gib']:.3f} GiB), bf16 {step['ms']:.3f} ms ({step['device_ms']:.3f} "
          f"ms of device time, {step['peak_gib']:.3f} GiB)  [{gpu}]", flush=True)
    numbers["ls960_joint"] = r
    clock("ls960_joint served and trained at bf16", t0)
    # 51. csj_joint, 52. timit_attention and ls960_joint_bpe: card == CPU and one step
    for name, seed, max_labels, beam in (("csj_joint", 63, 6, True),
                                         ("timit_attention", 64, 6, False),
                                         ("ls960_joint_bpe", 65, 2, False)):
        raw = raw_config(name) | {"compute_dtype": BF16}
        task, _, params, cpu, model = family_models(raw, att_task, dev)
        numbers[name] = {
            "card_vs_cpu": check_att_model_bf16(task, cpu, model, dev, name,
                                                raw["beam_width"] if beam else 0,
                                                raw.get("length_penalty", 0.0)),
            "train_step_card_vs_cpu": check_bf16_step(
                family_task(raw, dropout=1.0, scheduled_sampling_prob=0.0)[0], att_task,
                params, dev, name, seed=seed, max_labels=max_labels)}
        del model
        clock(f"{name} bf16 card == CPU", t0)
    return counts, kernel, numbers


# on-disk corpora and gradient accumulation (phases 53-55): the hard toy corpus
# written as wavs, 2 to 12 s, split as LibriSpeech's are named
DATA_ROOT_SPLITS = {"train": 64, "dev_clean": 16, "dev_other": 16, "test_clean": 16}
PREPARE_MODES = {  # name -> (bin/prepare options beyond ls100_ctc's frontend, splits)
    "utterance": ([], tuple(DATA_ROOT_SPLITS)),
    "none": (["--cmvn", "none"], tuple(DATA_ROOT_SPLITS)),
    "speaker": (["--cmvn", "speaker"], ("train",)),
    "mfcc": (["--feature", "mfcc"], ("train",)),
}
PREPARE_ATOL = 1e-4  # normalized features, card vs CPU; raw log-mel also rtol 1e-5
ACCUM = 4
ACCUM_LOSS_RTOL = 1e-5  # A = 4 against A = 1: the same terms summed in another order


def write_wav_corpus(root: Path) -> dict:
    """The hard toy corpus's utterances of 2 to 12 s (character labels, 16
    speakers) as 16-bit PCM wavs at 16 kHz; ``{split: 4-column scp}``."""
    corpus = HardCorpus(label_type="character", num_utts=150, min_units=6, max_units=24,
                        seed=17, max_utt_seconds=12.0)
    utts = [u for u in corpus.utterances if 2 * SR <= len(u.wav) <= 12 * SR]
    (root / "wav").mkdir(parents=True)
    scps, lo = {}, 0
    for split, n in DATA_ROOT_SPLITS.items():
        lines = []
        for u in utts[lo : lo + n]:
            path = root / "wav" / f"{u.name}.wav"
            with wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes((np.clip(u.wav * 0.5, -1, 1) * 32767).astype(np.int16).tobytes())
            lines.append(f"{u.name}\t{path}\t{u.speaker}\t{u.text}")
        if len(lines) != n:
            raise RuntimeError(f"the hard corpus gave {len(lines)} {split} utterances of 2-12 s")
        scps[split] = root / f"{split}.scp"
        scps[split].write_text("\n".join(lines) + "\n")
        lo += n
    speakers = {line.split("\t")[2] for scp in scps.values() for line in
                scp.read_text().splitlines()}
    if len(speakers) < 4:
        raise RuntimeError(f"the wav corpus has {len(speakers)} speakers; want at least 4")
    return scps


def prepare_corpora(work: Path, gpu: str) -> tuple:
    """``bin/prepare`` on the card in each mode (ls100_ctc's frontend: 40 mel,
    no energy, deltas), each split against the same CLI on the CPU; returns
    ({mode: card data root}, numbers)."""
    scps = write_wav_corpus(work / "wavs")
    roots, numbers = {}, {}
    for mode, (extra, splits) in PREPARE_MODES.items():
        roots[mode] = work / f"data_{mode}"
        n = wall = cpu_wall = err = 0.0
        bad = []
        for split in splits:
            argv = [split, "--wav-scp", str(scps[split]), "--input-size", "40", "--no-energy",
                    "--batch", "16", *extra]
            reset_counts()
            t0 = time.perf_counter()
            prepare_cli.main([str(roots[mode]), *argv, "--device", "cuda"])
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            if any(read_counts().values()):
                raise RuntimeError(f"bin/prepare launched {read_counts()}")
            t0 = time.perf_counter()
            prepare_cli.main([str(work / f"cpu_{mode}"), *argv, "--device", "cpu"])
            cpu_wall += time.perf_counter() - t0
            for f in sorted((roots[mode] / split / "feats").glob("*.npy")):
                got, want = np.load(f), np.load(work / f"cpu_{mode}" / split / "feats" / f.name)
                if got.shape != want.shape or got.dtype != np.float32:
                    raise RuntimeError(f"{f.name}: card {got.shape} {got.dtype}, CPU {want.shape}")
                diff = np.abs(got - want)
                err = max(err, float(diff.max()))
                # raw log-mel (--cmvn none) reaches about 25: a relative term too
                if not np.all(diff <= PREPARE_ATOL + (1e-5 * np.abs(want) if mode == "none"
                                                      else 0.0)):
                    bad.append(f"{split}/{f.name}")
                n += 1
            if ((roots[mode] / split / "transcripts.tsv").read_bytes()
                    != (work / f"cpu_{mode}" / split / "transcripts.tsv").read_bytes()):
                raise RuntimeError(f"{mode} {split}: transcripts differ between card and CPU")
        dim = np.load(next((roots[mode] / "train" / "feats").glob("*.npy"))).shape[1]
        numbers[mode] = {"utterances": int(n), "dim": int(dim), "card_s": wall,
                         "utts_per_sec": n / wall, "cpu_s": cpu_wall, "max_abs_err": err}
        print(f"phase bin/prepare --cmvn {mode if mode != 'mfcc' else 'utterance --feature mfcc'}"
              f" ({', '.join(splits)}): {int(n)} utterances of 2-12 s, {dim} dims, {wall:.3f} s "
              f"on the card ({n / wall:.1f} utterances/s, wav reads and .npy writes included), "
              f"{cpu_wall:.3f} s on the CPU; card vs CPU .npy max abs err {err:.2e} (tolerance "
              f"{PREPARE_ATOL:g}{' + 1e-5 x |x|' if mode == 'none' else ''})  [{gpu}]",
              flush=True)
        if bad:
            raise RuntimeError(f"bin/prepare {mode} on the card disagrees with the CPU: {bad}")
    return roots, numbers


def fit_data_root(name: str, raw: dict, gpu: str, model_dir: Path) -> dict:
    """``fit`` for one epoch of a prepared corpus at ``grad_accum_steps``: each
    step exactly ACCUM x (5 #1, 5 #2, 1 #5), one #6 (and 5 #1) per dev batch."""
    counts = train_one_epoch(name, raw, gpu, ("lstm_bidi_fwd", "lstm_bidi_bwd", "ctc_loss",
                                              "ctc_loss_fwd_only"), model_dir)
    steps = json.loads((model_dir / "summary.json").read_text())["steps"]
    dev_batches = -(-DATA_ROOT_SPLITS["dev_clean"] // raw["batch_size"])
    want = dict(NONE_LAUNCHED, lstm_bidi_fwd=(steps * ACCUM + dev_batches) * LAYERS,
                lstm_bidi_bwd=steps * ACCUM * LAYERS, ctc_loss=steps * ACCUM,
                ctc_loss_fwd_only=dev_batches)
    print(f"{name}: {steps} steps of {ACCUM} microbatches, {dev_batches} dev batch: launches "
          f"{counts}", flush=True)
    if counts != want:
        raise RuntimeError(f"{name} launched {counts}; expected {want}")
    return counts


def check_accumulation(task, params_cpu, dev, gpu: str) -> dict:
    """One SGD step at B=32 x 12 s with dropout off over ACCUM microbatches
    against the one-batch step, on the card: the loss, and each weight's
    update within GRAD_RTOL of the tensor's largest update."""
    batch = train_batch(B_TRAIN, 12.0, seed=8, max_labels=U)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = {k: v.to(dev) for k, v in params_cpu.items()}
    opt = build_optimizer("sgd", 5.0)
    out = {}
    for accum in (1, ACCUM):
        new, _, aux = ctc_task.make_train_step(task, opt, grad_accum=accum)(
            params, opt.init(params), tb, 0.1)
        out[accum] = ({k: (new[k] - params[k]).cpu() for k in params}, float(aux["loss"]),
                      bool(aux["nonfinite"]))
    (d1, l1, f1), (d4, l4, f4) = out[1], out[ACCUM]
    loss_err = abs(l4 - l1) / abs(l1)
    errs = {k: float((d4[k] - d1[k]).abs().max()) / max(float(d1[k].abs().max()), 1e-12)
            for k in d1}
    worst = max(errs, key=errs.get)
    print(f"accumulation on the card, B={B_TRAIN} x 12 s, SGD lr 0.1, dropout off: loss "
          f"{l4:.6f} over {ACCUM} microbatches vs {l1:.6f} in one (rel err {loss_err:.2e}, "
          f"tolerance {ACCUM_LOSS_RTOL:g}); updates max err / max |update| {errs[worst]:.2e} "
          f"({worst}; tolerance {GRAD_RTOL:g}) over {len(errs)} tensors  [{gpu}]", flush=True)
    if f1 or f4 or not loss_err <= ACCUM_LOSS_RTOL or not errs[worst] <= GRAD_RTOL:
        raise RuntimeError("the accumulated step disagrees with the one-batch step")
    return {"loss_rel_err": loss_err, "update_rel_err": errs[worst]}


def run_data_root(args, dev, gpu: str, work: Path, t0: float, params_cpu: dict) -> tuple:
    """Phases 53-55; returns (launch counts by path, numbers)."""
    roots, prepared = prepare_corpora(work, gpu)
    clock("corpora prepared on the card and held against the CPU", t0)
    counts = {}
    raw = dict(LS100_CTC, data_root=str(roots["utterance"]), grad_accum_steps=ACCUM)
    model_dir = work / "ls100_ctc_data_root"
    counts["data_root_training"] = fit_data_root("ls100_ctc data_root", raw, gpu, model_dir)
    res, counts["data_root_eval"] = run_cli(
        "bin/eval ls100_ctc data_root", eval_cli.main, [str(model_dir), "--device", "cuda"],
        ("lstm_bidi_fwd", "ctc_loss_fwd_only"), gpu)
    want_sets = [s for s in DATA_ROOT_SPLITS if s != "train"]
    if list(res) != want_sets or not all(
            res[s]["num_utts"] == DATA_ROOT_SPLITS[s] and np.isfinite(res[s]["loss"])
            and np.isfinite(res[s]["error_rate"]) for s in want_sets):
        raise RuntimeError(f"bin/eval on the data_root model scored {res}")
    counts["speaker_cmvn_training"] = fit_data_root(
        "ls100_ctc data_root cmvn speaker",
        dict(raw, data_root=str(roots["none"]), cmvn="speaker"), gpu,
        work / "ls100_ctc_speaker_cmvn")
    clock("ls100_ctc trained from data_root with accumulation and scored", t0)
    task = experiment_from_dict(dict(LS100_CTC, dropout=1.0)).ctc_task(len(CHAR_UNITS))
    accum = check_accumulation(task, params_cpu, dev, gpu)
    timed = {}
    task = ls100_ctc_task()
    for a in (1, ACCUM):
        timed[a] = time_train_steps(
            f"ls100_ctc_accum{a}", task, ctc_task, params_cpu, dev, gpu, args.profile_out,
            dict(NONE_LAUNCHED, lstm_bidi_fwd=a * LAYERS, lstm_bidi_bwd=a * LAYERS, ctc_loss=a),
            a * LAYERS, grad_accum=a)
    print(f"phase accumulation at B={B_TRAIN} x 12 s: {ACCUM} microbatches "
          f"{timed[ACCUM]['ms']:.3f} ms per step, peak {timed[ACCUM]['peak_gib']:.3f} GiB; one "
          f"batch {timed[1]['ms']:.3f} ms, peak {timed[1]['peak_gib']:.3f} GiB  [{gpu}]",
          flush=True)
    if not timed[ACCUM]["peak_gib"] < timed[1]["peak_gib"]:
        raise RuntimeError("the accumulated step's peak memory is not below the one-batch step's")
    clock("accumulation checked and timed", t0)
    keep = ("ms", "utts_per_sec", "peak_gib", "launches", "busy_share", "device_ms")
    return counts, {"prepare": prepared, "eval": res, "accumulation": dict(
        accum, **{f"a{a}": {k: r[k] for k in keep} for a, r in timed.items()})}


# ---- phases 61-67: the scan-path encoders, cnn_zhang, GRU streaming, the tools -------

# ls100_ctc at full width with another encoder: 5 x BGRU-512; 5 x BLSTM-512 with
# peephole, cell clip 50 and a 256-wide projection; cnn_zhang (fc_units (1024,))
ZOO = {"ls100_ctc_bgru": (f"{LAYERS} x BGRU-{H}", {"encoder_type": "bgru"}),
       "ls100_ctc_blstm_options": (f"{LAYERS} x BLSTM-{H} (peephole, clip 50, proj 256)",
                                   {"use_peephole": True, "clip_activation": 50.0,
                                    "num_proj": 256}),
       "ls100_ctc_cnn_zhang": ("cnn_zhang 128-128-256-256, fc 1024",
                               {"encoder_type": "cnn_zhang"})}
# configs/ls_streaming_ctc.yml (4 x LSTM-512, causal) with a GRU, and with the options
ZOO_STREAMS = {"ls_streaming_ctc_gru": {"encoder_type": "gru"},
               "ls_streaming_ctc_options": {"use_peephole": True, "clip_activation": 50.0,
                                            "num_proj": 256}}
ZOO_TIMED_STEPS = 1  # a scan-path step takes seconds: one Python loop over T per layer
ZOO_STREAM_SECONDS = (4.0, 3.5, 3.0, 2.5, 2.0, 1.5, 1.0, 0.6)
NATIVE_UTTS, NATIVE_PAIRS = 32, 128


def zoo_task(overrides: dict):
    return experiment_from_dict(dict(LS100_CTC, **overrides)).ctc_task(len(CHAR_UNITS))


def serve_zoo(name: str, label: str, task, model, dev, gpu: str) -> tuple:
    """Phase 62: encoder ms on 8 x 12 s, one batch's device launches and busy
    share, and 8 concurrent requests (no kernel but none of #1-#4: the serving
    path launches nothing counted)."""
    rng = np.random.RandomState(71)
    n = 12 * SR
    wav = (rng.randn(B, n) * 0.1).astype(np.float32)
    lens = np.full((B,), n, np.int32)
    infer = build_inference_fn(task, model)
    with torch.inference_mode():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(dev),
                                           "input_len": torch.from_numpy(lens).to(dev)})
        enc_ms = host_ms(lambda: model.encoder(feats, fl), 1)  # a warm call, then one timed
    wall, busy, kernels = device_busy(lambda: infer(wav, lens))
    launches = sum(k[2] for k in kernels)
    print(f"phase {name} serving, {label}: encoder {enc_ms:.3f} ms per batch of "
          f"{B} x 12 s (T'={frames_out(task, n)}); one batch profiled: {wall:.3f} ms wall, "
          f"{busy:.3f} ms of device time ({100 * busy / wall:.1f} % busy), {launches} device "
          f"launches  [{gpu}]", flush=True)
    counts = serve_requests(task, model, gpu, name, per_batch={})
    return counts, {"encoder_ms": enc_ms, "batch_wall_ms": wall, "batch_device_ms": busy,
                    "batch_busy": busy / wall, "batch_device_launches": launches}


def stream_zoo(name: str, overrides: dict, dev, gpu: str) -> tuple:
    """Phase 64: ls_streaming_ctc with ``overrides`` at full width, streamed on
    8 x up to 4 s in 100 ms chunks: no kernel launched (no #3: these layers
    take the scan path), greedy tokens equal the offline decode on the card and
    the CPU's stream on 2 x 1 s, the chunk step timed and profiled."""
    raw, task, _, cpu, model = stream_models("ls_streaming_ctc", dev, **overrides)
    wav, lens = stream_audio(ZOO_STREAM_SECONDS, seed=72)
    fns = streaming.build_streaming_fn(task, model, STREAM_CHUNK)
    reset_counts()
    t0 = time.perf_counter()
    _, rows, steps = stream_rows(fns, wav, lens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = offline_decode(task, model, wav, lens, dev)
    short, short_lens = stream_audio((1.0, 0.63), seed=73)
    got = stream_rows(fns, short, short_lens)[1]
    cpu_rows = stream_rows(streaming.build_streaming_fn(task, cpu, STREAM_CHUNK), short,
                           short_lens)[1]
    print(f"phase {name} greedy stream ({raw['num_layers']} x {raw['encoder_type']}-"
          f"{raw['num_units']}{'' if task.model.encoder.spec().on_kernels else ' scan path'}), "
          f"{B} x {max(ZOO_STREAM_SECONDS):g} s in 100 ms chunks ({steps} steps, {wall:.1f} s): "
          f"tokens equal the offline decode: {rows == want}; card vs CPU on 2 x 1 s: "
          f"{got == cpu_rows}; launches {counts}  [{gpu}]", flush=True)
    if rows != want or not any(rows) or got != cpu_rows:
        raise RuntimeError(f"{name}: the stream disagrees with the offline decode or the CPU")
    if counts != NONE_LAUNCHED:
        raise RuntimeError(f"{name}: the scan-path stream launched {counts}")
    wav_t, lens_t = stream_audio(STREAM_SECONDS, seed=74)
    return counts, time_stream_step(fns, wav_t, lens_t, dev, gpu, name, 0)


def fit_zoo(name: str, overrides: dict, dev, gpu: str, model_dir: Path) -> tuple:
    """Phase 65: ``fit`` for one toy epoch with ``profile_steps=(1, 2)``: the
    trace must hold the card's kernels; then ``bin/eval`` (beam 20) and
    ``bin/export --selfcheck`` on the model dir, the artifact's ids equal to
    in-process serving on the card."""
    raw = dict(LS100_CTC, **overrides, toy_num_utts=96, num_epoch=1)
    exp = experiment_from_dict(raw)
    lines = []
    reset_counts()
    t0 = time.perf_counter()
    summary = fit(exp, model_dir, log_every=1, print_fn=lines.append, profile_steps=(1, 2),
                  device=dev.type)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    trace = model_dir / "trace" / "train_steps_1-2.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    plotted = [s for s in lines if s.startswith("plotting failed")]
    print(f"phase fit {name} 1 epoch with profile_steps (1, 2): {wall:.1f} s wall, "
          f"{summary['steps']} steps, dev error {summary['dev_error_rate']:.4f}, launches "
          f"{counts}; trace {trace.stat().st_size / 2**20:.2f} MiB with {len(events)} events, "
          f"{len(kernels)} CUDA kernel events ({len({e['name'] for e in kernels})} kernels); "
          f"{plotted[0] if plotted else 'curves plotted'}  [{gpu}]", flush=True)
    if f"profiler trace written to {trace}" not in lines or (dev.type == "cuda" and not kernels):
        raise RuntimeError(f"{name}: fit wrote no trace of the card's kernels")
    if summary["nonfinite_steps"] or not np.isfinite(summary["dev_loss"]):
        raise RuntimeError(f"{name}: fit gave {summary}")
    # one #5 per step, #6 in the dev eval, nothing else
    want = dict(NONE_LAUNCHED, ctc_loss=summary["steps"],
                ctc_loss_fwd_only=max(counts["ctc_loss_fwd_only"], 1))
    if counts != want:
        raise RuntimeError(f"{name}: the training path launched {counts}; expected {want}")
    res, eval_counts = run_cli(f"bin/eval {name} (beam 20)", eval_cli.main,
                               [str(model_dir), "--device", dev.type], ("ctc_loss_fwd_only",),
                               gpu)
    if not all(res[s]["num_utts"] > 0 and np.isfinite(res[s]["loss"]) for s in ("dev", "test")):
        raise RuntimeError(f"bin/eval {name} gave {res}")
    art = model_dir.parent / f"{name}.art"
    export_cli.main([str(model_dir), str(art), "--seconds", "12", "--device", dev.type,
                     "--selfcheck"])
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    task, mod = build_task(exp, corpus_tokenizer(exp))
    model = eval_cli.restore_model(model_dir, task, mod, None, dev)[1]
    wav, lens = stream_audio(REQUEST_SECONDS, seed=75)
    want = build_inference_fn(task, model)(wav, np.asarray(lens, np.int32))
    got = load_exported(art, dev.type)(wav, np.asarray(lens, np.int32))
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"{name} artifact vs in-process serving on 8 requests: ids equal {same}", flush=True)
    if not same:
        raise RuntimeError(f"{name}: the artifact's ids differ from in-process serving")
    return {f"fit_{name}": counts, f"eval_{name}": eval_counts}, {
        "fit_wall_s": wall, "trace_events": len(events), "trace_kernel_events": len(kernels)}


def check_native(gpu: str) -> dict:
    """Phase 66: the C++ host runtime built with the host compiler (a failed
    build or ABI check raises here: no quiet fallback), ``batch_assemble`` and
    ``levenshtein_batch`` bit-equal to their numpy / Python fallbacks and timed
    beside them."""
    from tensorflow_end2end_speech_recognition_tpu_torch.data import native
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.edit_distance import (
        levenshtein_batch as levenshtein_py,
    )

    t0 = time.perf_counter()
    lib = native.build()
    native.load_library()
    build_s = time.perf_counter() - t0
    if not native.have_native():
        raise RuntimeError("the C++ host runtime built but does not load")
    rng = np.random.RandomState(76)
    utts = [rng.randn(int(n), 3 * 40).astype(np.float32)
            for n in rng.randint(300, 1200, NATIVE_UTTS)]
    refs = [list(rng.randint(0, 28, rng.randint(0, 120))) for _ in range(NATIVE_PAIRS)]
    hyps = [list(rng.randint(0, 28, rng.randint(0, 120))) for _ in range(NATIVE_PAIRS)]
    t0 = time.perf_counter()
    batch, lens = native.batch_assemble(utts, 1200)
    edits = native.levenshtein_batch(refs, hyps)
    t1 = time.perf_counter()
    plain = np.zeros_like(batch)
    for i, u in enumerate(utts):
        plain[i, : len(u)] = u
    t2 = time.perf_counter()
    edits_py = levenshtein_py(refs, hyps)
    t3 = time.perf_counter()
    same = batch.tobytes() == plain.tobytes() and np.array_equal(edits, edits_py)
    print(f"phase native host runtime: built in {build_s:.2f} s -> {lib.name}; "
          f"batch_assemble of {NATIVE_UTTS} x up to 1200 x 120 and levenshtein_batch of "
          f"{NATIVE_PAIRS} pairs up to 120 tokens: {1e3 * (t1 - t0):.2f} ms (numpy pad "
          f"{1e3 * (t2 - t1):.2f} ms, Python edit distance {1e3 * (t3 - t2):.1f} ms); bits "
          f"equal: {same}", flush=True)
    if not same:
        raise RuntimeError("the C++ host runtime disagrees with its numpy / Python paths")
    return {"build_s": build_s, "native_ms": 1e3 * (t1 - t0), "numpy_pad_ms": 1e3 * (t2 - t1),
            "python_edit_ms": 1e3 * (t3 - t2)}


def run_encoder_zoo(args, dev, gpu: str, work: Path, t0: float) -> tuple:
    """Phases 61-67; returns (launch counts by path, numbers)."""
    counts, numbers = {}, {}
    for name, (label, overrides) in ZOO.items():
        task = zoo_task(overrides)
        params_cpu = ctc_task.init_params(task, torch.Generator().manual_seed(0))
        model_cpu = ctc_task.init_model(task)
        model_cpu.load_state_dict(params_cpu)
        model_cpu.eval()
        model = copy.deepcopy(model_cpu).to(dev).eval()
        # phase 61: card vs CPU on 2 x 1 s, the model and one train step
        check_model(task, model_cpu, model, dev, name)
        check_train_step(task, ctc_task, params_cpu, dev, seed=70)
        # phase 62: serving
        counts[f"{name}_serving"], serve = serve_zoo(name, label, task, model, dev, gpu)
        del model
        # phase 63: Adam steps at B=32 x 12 s: no walk (#1-#4), one #5 per step
        r = time_train_steps(name, task, ctc_task, params_cpu, dev, gpu, args.profile_out,
                             dict(NONE_LAUNCHED, ctc_loss=1), 0, steps=ZOO_TIMED_STEPS)
        counts[f"{name}_training"] = r["launches"]
        numbers[name] = {"encoder": label, "serving": serve,
                         "train_step": {k: v for k, v in r.items() if k != "device_launches"}}
        numbers[name]["train_step"]["device_launches"] = sum(
            v["launches"] for v in r["by_kind"].values())
        clock(f"{name} checked, served and trained", t0)
    for name, overrides in ZOO_STREAMS.items():
        counts[name], numbers[name] = stream_zoo(name, overrides, dev, gpu)
    clock("GRU and option-cell streams run", t0)
    fit_counts, numbers["fit_cnn_zhang"] = fit_zoo(
        "ls100_ctc_cnn_zhang", ZOO["ls100_ctc_cnn_zhang"][1], dev, gpu,
        work / "ls100_ctc_cnn_zhang")
    counts.update(fit_counts)
    numbers["native"] = check_native(gpu)
    print("phase plot: not run on the card (no matplotlib there); tests/test_torch_tools.py "
          "draws the PNGs on the CPU", flush=True)
    clock("fit with profile_steps, bin/eval, bin/export and the native runtime run", t0)
    return counts, numbers


# ---- phases 68-70: data parallelism and ZeRO-3 across ranks ----------------------

DP_WORLD = 2  # two ranks on the one card over gloo: NCCL refuses two ranks on one GPU
DP_RTOL = 1e-5  # DP vs one process: loss, each gradient and weight leaf, of its largest entry
FSDP_RTOL = 1e-6  # gathered ZeRO-3 weights vs DP's after 2 steps, of each leaf's largest entry
DP_SEEDS = (68, 69)  # the two global batches of B = 32 x 12 s
DP_WANT = dict(NONE_LAUNCHED, lstm_bidi_fwd=LAYERS, lstm_bidi_bwd=LAYERS, ctc_loss=1)
DP_FIT_LAUNCHED = ("lstm_bidi_fwd", "lstm_bidi_bwd", "ctc_loss", "ctc_loss_fwd_only")
COLLECTIVE_REPS = 3


def sync(dev) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


# DP against one process on the same rows: the loss within DP_RTOL; each
# gradient leaf within DP_GRAD_RTOL of its largest entry. Two ranks' 16-row
# products (cuBLAS picks its kernels by shape) sum in other orders than one
# 32-row product, and the difference is carried back through 400 recurrent
# steps and 5 layers, as between the card and the CPU: up to 1.1e-4 of a
# leaf's largest entry on an NVIDIA H100 80GB HBM3, 700 W, so the 1e-5 of
# DP_RTOL cannot hold for gradients; DP_GRAD_RTOL is about 3 x that reading.
# Adam's first step moves each weight by lr x g / (|g| + eps), which turns a
# gradient entry near 0 into +-lr whichever way rounding tips it (a
# zero-initialised bias entry moved by 1.28 of its leaf's largest entry on
# the same card), and an entry within a few hundred eps of 0 by a share of lr
# that follows its rounding. So the weights after the step are held to the
# step's own gradient instead: each rank's weights within DP_RTOL of their
# leaf's largest entry of the initial weights less Adam's first update from
# the moments the rank holds (``adam_first_weights``), and the moments'
# gradient to the one-process one as above. Every leaf is held to its own
# largest entry, ls960_joint's attention-decoder leaves too, whose gradients
# are under 1e-3 of the encoder's largest entry at these seeded weights
DP_GRAD_RTOL = 3e-4
FIT_RTOL = 1e-4  # phase 70's fit: dev and train losses of world 2 vs world 1
DP_LR = 1e-3


def leaf_errs(got: dict, want: dict) -> dict:
    """``{name: max |got - want| / the leaf's largest entry}`` over matching
    dicts of tensors (a leaf that is zero in ``want``: of the largest entry
    of all)."""
    top = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k].to(w.device) - w).abs().max()) / (float(w.abs().max()) or top)
            for k, w in want.items()}


def adam_first_weights(params: dict, state: dict) -> dict:
    """The weights after Adam's first step at ``DP_LR`` from ``params`` with
    the moments in ``state`` (``train/optimizer``'s formula: bias-corrected
    mu / (sqrt(bias-corrected nu) + eps))."""
    from tensorflow_end2end_speech_recognition_tpu_torch.train import optimizer as optim

    count = state["count"].to(torch.float32)
    c1, c2 = 1 - optim.ADAM_B1 ** count, 1 - optim.ADAM_B2 ** count
    return {k: p - DP_LR * ((state["mu"][k] / c1) / (torch.sqrt(state["nu"][k] / c2)
                                                      + optim.ADAM_EPS))
            for k, p in params.items()}


def weights_off(got: dict, want: dict) -> int:
    """How many weights differ by more than DP_RTOL of their leaf's largest entry."""
    return sum(int(((got[k] - w).abs() > DP_RTOL * float(w.abs().max())).sum())
               for k, w in want.items())


def worst(errs: dict) -> tuple:
    k = max(errs, key=errs.get)
    return k, errs[k]


def dp_task(name: str, task_mod, dev, seed: int = 0):
    """(task with dropout off, its seeded weights on ``dev``): phase 68's
    ls100_ctc or phase 70's ls960_joint."""
    if name == "ls100_ctc":
        task = experiment_from_dict(dict(LS100_CTC, dropout=1.0)).ctc_task(len(CHAR_UNITS))
    else:
        task = ls960_joint_task(dropout=1.0)
    params = task_mod.init_params(task, torch.Generator().manual_seed(seed))
    return task, {k: v.to(dev) for k, v in params.items()}


def one_process_step(task, task_mod, params: dict, batch: dict, dev) -> dict:
    """One Adam step of the one-process train step on the whole global batch:
    its loss, the clipped gradient (Adam's first moment / (1 - b1)) and the
    weights after it, on the card."""
    opt = build_optimizer("adam", 5.0)
    step = task_mod.make_train_step(task, opt)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    new, state, aux = step(params, opt.init(params), tb, DP_LR)
    return {"loss": float(aux["loss"]), "grad": {k: v / (1 - 0.9) for k, v in state["mu"].items()},
            "params": new, "state": state, "nonfinite": bool(aux["nonfinite"])}


def timed_step(step, params, state, rows: dict, mesh, want: dict | None) -> tuple:
    """One train step on this rank's rows between barriers: (params, state,
    aux, ms, launch counts); raise unless exactly ``want`` launched."""
    sync(mesh.device)
    torch.distributed.barrier()
    reset_counts()
    t = time.perf_counter()
    params, state, aux = step(params, state, rows, DP_LR)
    sync(mesh.device)
    ms = (time.perf_counter() - t) * 1e3
    counts = read_counts()
    if want is not None and counts != want:
        raise RuntimeError(f"rank {mesh.rank}: one step launched {counts}; expected {want}")
    if bool(aux["nonfinite"]):
        raise RuntimeError(f"rank {mesh.rank}: the step's loss is not finite")
    return params, state, aux, ms, counts


def same_on_ranks(mesh, tree: dict) -> bool:
    """Whether every rank holds rank 0's tensors bit for bit."""
    flat = torch.cat([v.detach().reshape(-1).to(torch.float32) for v in tree.values()])
    mine = flat.clone()
    torch.distributed.broadcast(flat, 0)
    same = torch.tensor([float(torch.equal(flat, mine))], device=flat.device)
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    return bool(same.item() == 1.0)


def collective_ms(fn, dev) -> float:
    """Mean wall ms of ``fn`` (a collective) between barriers, synchronized."""
    fn()
    times = []
    for _ in range(COLLECTIVE_REPS):
        sync(dev)
        torch.distributed.barrier()
        t = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
    return sum(times) / len(times)


def held_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(held_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def dp_against_one_process(name: str, task_mod, mesh, fsdp: bool = False,
                           steps: int = 1) -> dict:
    """``steps`` DP (or, ``fsdp``, ZeRO-3) Adam steps of ``name`` at full width
    on this rank's rows of the global batches ``DP_SEEDS``; rank 0 holds the
    first against the one-process step on the whole batch (loss, every
    gradient leaf, every weight leaf within ``DP_RTOL`` of its largest entry).
    Every step launches exactly ``DP_WANT``. Returns the numbers and, for the
    caller, the weights held (``"params"``)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
        fsdp_partition_specs, setup_data_parallel, setup_fsdp, shard_batch)
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.fsdp import (
        gather_params, reduce_scatter_grads)
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.mesh import all_reduce_flat

    dev = mesh.device
    task, params = dp_task(name, task_mod, dev)
    batches = [train_batch(B_TRAIN, 12.0, seed=s, max_labels=U) for s in DP_SEEDS[:steps]]
    ref = None
    if mesh.rank == 0 and not fsdp:
        ref = one_process_step(task, task_mod, params, batches[0], dev)
    opt = build_optimizer("adam", 5.0)
    specs = fsdp_partition_specs(params, mesh.size) if fsdp else None
    setup = setup_fsdp if fsdp else setup_data_parallel
    held, state, _ = setup(mesh, params, opt.init(params))
    step = task_mod.make_train_step(task, opt, mesh=mesh, specs=specs)
    out = {"rank": mesh.rank, "rows": B_TRAIN // mesh.size, "ms": [], "launches": [],
           "resident_bytes": held_bytes(held) + held_bytes(state),
           "whole_bytes": 3 * held_bytes(params)}
    for i, batch in enumerate(batches):
        held, state, aux, ms, counts = timed_step(step, held, state, shard_batch(mesh, batch),
                                                  mesh, DP_WANT)
        out["ms"].append(ms)
        out["launches"].append(counts)
        if i == 0:
            out["loss"] = float(aux["loss"])
            if ref is not None:
                grad = {k: v / (1 - 0.9) for k, v in state["mu"].items()}
                g_errs = leaf_errs(grad, ref["grad"])
                w_errs = leaf_errs(held, ref["params"])
                own = worst(leaf_errs(held, adam_first_weights(params, state)))
                off = weights_off(held, ref["params"])
                loss_err = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
                top = lambda e: dict(sorted(e.items(), key=lambda kv: -kv[1])[:4])  # noqa: E731
                out.update(one_process_loss=ref["loss"], loss_rel_err=loss_err,
                           grad_rel_err=top(g_errs), weight_rel_err=top(w_errs),
                           weights_off=off, weights_vs_own_step=own,
                           weights_total=sum(v.numel() for v in held.values()))
                if ref["nonfinite"] or not (loss_err <= DP_RTOL
                                            and max(g_errs.values()) <= DP_GRAD_RTOL
                                            and own[1] <= DP_RTOL):
                    raise RuntimeError(f"{name} DP step disagrees with one process: loss "
                                       f"{loss_err:.3e} (tolerance {DP_RTOL:g}), gradients "
                                       f"{top(g_errs)} (tolerance {DP_GRAD_RTOL:g}), "
                                       f"weights against the "
                                       f"rank's own Adam step {own} (tolerance {DP_RTOL:g})")
                ref = None
    if not fsdp:
        out["replicas_bit_identical"] = same_on_ranks(mesh, held)
        if not out["replicas_bit_identical"]:
            raise RuntimeError(f"{name}: DP weights differ between the ranks")
    # the step's collectives, timed alone on buffers of their sizes
    whole = [k for k in held if specs is None or specs[k] is None]
    flat = [torch.zeros_like(held[k]) for k in whole] + [torch.zeros(1 + len(aux), device=dev)]
    out["all_reduce_bytes"] = sum(held_bytes(v) for v in flat)
    out["all_reduce_ms"] = collective_ms(lambda: all_reduce_flat(mesh, flat), dev)
    if fsdp:
        grads = {k: torch.zeros(v.shape, device=dev) for k, v in params.items()}
        out["all_gather_bytes"] = sum(held_bytes(params[k]) for k in held if k not in whole)
        out["all_gather_ms"] = collective_ms(lambda: gather_params(mesh, held, specs), dev)
        out["reduce_scatter_ms"] = collective_ms(
            lambda: reduce_scatter_grads(mesh, grads, specs), dev)
        out["sharded_leaves"] = len(held) - len(whole)
        out["leaves"] = len(held)
        out["params"] = gather_params(mesh, held, specs)
    else:
        out["params"] = held
    return out


def dp_fit(mesh, model_dir: Path) -> dict:
    """Phase 70's ``fit``: one toy epoch of ls100_ctc with ``num_devices``
    the world's size, dropout off; this rank's launch counts (#6 in its dev
    eval) and the summary."""
    exp = experiment_from_dict(dict(LS100_CTC, num_devices=mesh.size, dropout=1.0,
                                    num_epoch=1))
    reset_counts()
    t = time.perf_counter()
    summary = fit(exp, model_dir, log_every=1, print_fn=lambda *a: None, device=mesh.device)
    sync(mesh.device)
    counts = read_counts()
    launched = DP_FIT_LAUNCHED
    if any(counts[k] < 1 for k in launched) or any(counts[k] for k in COUNTERS
                                                   if k not in launched):
        raise RuntimeError(f"rank {mesh.rank}: fit launched {counts}; expected {launched}")
    return {"summary": summary, "launches": counts, "wall_s": time.perf_counter() - t}


def dp_rank(rank: int, world: int, backend: str, store: str, out: str, jobs: tuple,
            device: str, overrides: dict) -> None:
    """One rank of phases 68-70 (a spawned process): the group over
    ``backend`` from a ``FileStore``, this rank's card (``cuda:0`` for every
    rank over gloo, ``cuda:rank`` over nccl; ``device`` "cpu" for a
    rehearsal), then ``jobs``; rank r writes ``<out>/rank<r>.pt``.
    ``overrides`` replaces module constants in the rank (a rehearsal on the
    CPU narrows the configs there)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import make_mesh

    globals().update(overrides)
    set_full_fp32()
    if device == "cuda":
        build.load_library()
        device = f"cuda:{rank if backend == 'nccl' else 0}"
    torch.distributed.init_process_group(backend, store=torch.distributed.FileStore(store, world),
                                         rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, device=device)
        res = {}
        if "ls100_ctc" in jobs:
            res["dp"] = dp_against_one_process("ls100_ctc", ctc_task, mesh, steps=2)
        if "fsdp" in jobs:
            res["fsdp"] = dp_against_one_process("ls100_ctc", ctc_task, mesh, fsdp=True, steps=2)
            errs = leaf_errs(res["fsdp"].pop("params"), res["dp"]["params"])
            res["fsdp"]["vs_dp_leaf"], res["fsdp"]["vs_dp_rel_err"] = worst(errs)
            if not res["fsdp"]["vs_dp_rel_err"] <= FSDP_RTOL:
                raise RuntimeError("ZeRO-3 weights after 2 steps differ from DP's: "
                                   f"{res['fsdp']['vs_dp_leaf']} "
                                   f"{res['fsdp']['vs_dp_rel_err']:.3e}")
        res.get("dp", {}).pop("params", None)
        if "ls960_joint" in jobs:
            res["joint"] = dp_against_one_process("ls960_joint", att_task, mesh, steps=2)
            res["joint"].pop("params")
        if "fit" in jobs:
            res["fit"] = dp_fit(mesh, Path(out) / "dp_fit")
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(world: int, backend: str, work: Path, jobs: tuple, device: str = "cuda",
                overrides: dict | None = None, entry=None, tag: str = "dp") -> list:
    """Run ``entry`` (default ``dp_rank``) in ``world`` spawned processes, out
    of ``<work>/<tag>_<backend>_<world>``; every rank's results."""
    import torch.multiprocessing as mp

    out = work / f"{tag}_{backend}_{world}"
    out.mkdir(parents=True, exist_ok=True)
    mp.start_processes(entry or dp_rank, args=(world, backend, str(out / "store"), str(out),
                                               jobs, device, overrides or {}),
                       nprocs=world, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def world_one_nccl(dev, gpu: str, work: Path) -> dict:
    """Phase 68's world of 1 over nccl, in this process: the DP step built
    with the mesh equals the one-process step bit for bit (loss, weights,
    Adam state) and launches exactly ``DP_WANT``."""
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import make_mesh

    torch.distributed.init_process_group(
        "nccl", store=torch.distributed.FileStore(str(work / "nccl_store"), 1), rank=0,
        world_size=1)
    try:
        mesh = make_mesh(1, device=dev)
        task, params = dp_task("ls100_ctc", ctc_task, dev)
        batch = train_batch(B_TRAIN, 12.0, seed=DP_SEEDS[0], max_labels=U)
        ref = one_process_step(task, ctc_task, params, batch, dev)
        opt = build_optimizer("adam", 5.0)
        step = ctc_task.make_train_step(task, opt, mesh=mesh)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        new, state, aux, ms, counts = timed_step(step, params, opt.init(params), tb, mesh,
                                                 DP_WANT)
        equal = (float(aux["loss"]) == ref["loss"]
                 and all(torch.equal(new[k], ref["params"][k]) for k in new)
                 and all(torch.equal(state[m][k], ref["state"][m][k])
                         for m in ("mu", "nu") for k in new))
    finally:
        torch.distributed.destroy_process_group()
    print(f"phase 68 ls100_ctc DP world 1 over nccl: step {ms:.3f} ms, loss {ref['loss']:.4f}, "
          f"bit-equal to the one-process step (loss, weights, Adam state): {equal}, launches "
          f"{launched(counts)}  [{gpu}]", flush=True)
    if not equal:
        raise RuntimeError("the world-1 nccl step differs from the one-process step")
    return {"ms": ms, "bit_equal": equal, "launches": counts}


def launched(counts: dict) -> dict:
    """The kernels that launched, with their counts."""
    return {k: n for k, n in counts.items() if n}


def print_dp(what: str, r: dict, gpu: str, shared: bool = True) -> None:
    """One rank's phase line; ``shared``: the ranks share one card."""
    ms = ", ".join(f"{x:.3f}" for x in r["ms"])
    line = (f"phase {what} rank {r['rank']} ({r['rows']} rows of {B_TRAIN} x 12 s): steps "
            f"{ms} ms (the first with the rank's start-up; "
            + ("the ranks share one card: not a scaling number" if shared
               else "one card per rank") + "), loss "
            f"{r['loss']:.4f}, resident params + Adam {r['resident_bytes'] / 2**20:.1f} MiB "
            f"(whole {r['whole_bytes'] / 2**20:.1f} MiB), launches per step "
            f"{[launched(c) for c in r['launches']]}")
    if "loss_rel_err" in r:
        errs = lambda e: ", ".join(f"{k} {x:.2e}" for k, x in e.items())  # noqa: E731
        line += (f"; vs one process: loss {r['loss_rel_err']:.2e} (tolerance {DP_RTOL:g}); "
                 f"worst gradient leaves, of their max: {errs(r['grad_rel_err'])} "
                 f"(tolerance {DP_GRAD_RTOL:g}); worst weight leaves after the Adam step: "
                 f"{errs(r['weight_rel_err'])}, {r['weights_off']} of {r['weights_total']} "
                 f"weights off by more than {DP_RTOL:g} of their leaf's max; weights against "
                 f"the initial ones less Adam's first update from the rank's moments: worst "
                 f"{r['weights_vs_own_step'][0]} {r['weights_vs_own_step'][1]:.2e} of max "
                 f"(tolerance {DP_RTOL:g})")
    line += (f"; all-reduce of {r['all_reduce_bytes']:,} bytes per step in "
             f"{r['all_reduce_ms']:.3f} ms")
    if "replicas_bit_identical" in r:
        line += f"; replicas bit-identical {r['replicas_bit_identical']}"
    if "all_gather_ms" in r:
        line += (f"; {r['sharded_leaves']} of {r['leaves']} leaves sharded; all-gather and "
                 f"reduce-scatter of {r['all_gather_bytes']:,} bytes in "
                 f"{r['all_gather_ms']:.3f} / {r['reduce_scatter_ms']:.3f} ms"
                 f"; gathered weights vs DP after 2 steps {r['vs_dp_rel_err']:.2e} of max "
                 f"({r['vs_dp_leaf']}; tolerance {FSDP_RTOL:g})")
    print(line + f"  [{gpu}]", flush=True)


def across_cards(dev, gpu: str, work: Path) -> list | None:
    """Phase 68 over nccl with one card per rank, world min(cards, 4), when the
    machine shows two or more cards: each rank's numbers, rank 0's against
    the one-process step on card 0."""
    many = torch.cuda.device_count() if dev.type == "cuda" else 0
    if many < 2:
        print(f"phase 68 across cards over nccl: the machine shows {many} card; not run "
              "(not a pass)", flush=True)
        return None
    k = min(many, 4)
    across = [r["dp"] for r in spawn_ranks(k, "nccl", work, ("ls100_ctc",))]
    for r in across:
        print_dp(f"68 ls100_ctc DP world {k} over nccl, one card per rank", r, gpu,
                 shared=False)
    return across


def run_data_parallel(dev, gpu: str, work: Path, t0: float,
                      overrides: dict | None = None) -> tuple:
    """Phases 68-70: ls100_ctc under DP (world 2 on the one card over gloo,
    then world 1 over nccl), under ZeRO-3, ls960_joint under DP, and ``fit``
    with ``num_devices: 2`` against one process. ``overrides``: module
    constants for the ranks (``dp_rank``). Returns (launch counts by path,
    the numbers)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import (
        CheckpointManager)

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share the card with this process
    t = time.perf_counter()
    ranks = spawn_ranks(DP_WORLD, "gloo", work, ("ls100_ctc", "fsdp", "ls960_joint", "fit"),
                        dev.type, overrides)
    spawn_s = time.perf_counter() - t
    for key, what in (("dp", "68 ls100_ctc DP world 2 (gloo)"),
                      ("fsdp", "69 ls100_ctc ZeRO-3 world 2 (gloo)"),
                      ("joint", "70 ls960_joint DP world 2 (gloo)")):
        for r in ranks:
            print_dp(what, r[key], gpu)
    clock(f"phases 68-70 ranks done ({spawn_s:.1f} s with the spawn)", t0)
    nccl1 = world_one_nccl(dev, gpu, work)
    # fit: world 2 against one process, and the rank-0 checkpoint in one process
    fit2 = ranks[0]["fit"]
    one_dir = work / "dp_fit_one"
    exp1 = experiment_from_dict(dict(LS100_CTC, dropout=1.0, num_epoch=1))
    one = fit(exp1, one_dir, log_every=1, print_fn=lambda *a: None, device=dev)
    _, state = CheckpointManager(work / f"dp_gloo_{DP_WORLD}" / "dp_fit" / "checkpoints"
                                 ).restore({"params": None})
    task = experiment_from_dict(dict(LS100_CTC, dropout=1.0)).ctc_task(len(CHAR_UNITS))
    model = ctc_task.init_model(task)
    model.load_state_dict(state["params"])  # strict: whole tensors under the one-device names
    train_utts, dev_utts, _, tok = build_corpus_splits(exp1, need=("dev",))
    from tensorflow_end2end_speech_recognition_tpu_torch.data.dataset import Dataset
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.metrics import evaluate_ctc

    restored = evaluate_ctc(ctc_task.make_eval_step(task),
                            {k: v.to(dev) for k, v in state["params"].items()},
                            Dataset(dev_utts, exp1.eval_batch_size or exp1.batch_size,
                                    sort_utt=True), tok, exp1.label_type, 0, dev)
    s2 = fit2["summary"]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    errs = {"dev_loss": rel(s2["dev_loss"], one["dev_loss"]),
            "train_loss": rel(s2["train_loss"], one["train_loss"]),
            "restored_dev_loss": rel(restored["loss"], s2["dev_loss"])}
    print(f"phase 70 fit ls100_ctc 1 toy epoch, num_devices 2 (gloo, one card): "
          f"{fit2['wall_s']:.1f} s wall, {s2['steps']} steps, dev error "
          f"{s2['dev_error_rate']:.4f} (world 1: {one['dev_error_rate']:.4f}), dev loss "
          f"{s2['dev_loss']!r} (world 1: {one['dev_loss']!r}), train loss "
          f"{s2['train_loss']!r} (world 1: {one['train_loss']!r}); rank launches "
          f"{[launched(r['fit']['launches']) for r in ranks]}; rank 0's checkpoint restored "
          f"in one process: dev error {restored['error_rate']:.4f}, dev loss "
          f"{restored['loss']!r}; relative differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tolerance {FIT_RTOL:g})  [{gpu}]", flush=True)
    if not (s2["dev_error_rate"] == one["dev_error_rate"] == restored["error_rate"]
            and s2["steps"] == one["steps"] and max(errs.values()) <= FIT_RTOL):
        raise RuntimeError(f"fit with num_devices 2 {s2} differs from one process {one} or "
                           f"its restored checkpoint {restored}: {errs}")
    across = across_cards(dev, gpu, work)
    clock("phases 68-70 (data parallelism, ZeRO-3) done", t0)
    counts = {}
    for r in ranks:
        counts[f"dp_ls100_ctc_rank{r['dp']['rank']}"] = r["dp"]["launches"][0]
        counts[f"fsdp_ls100_ctc_rank{r['fsdp']['rank']}"] = r["fsdp"]["launches"][0]
        counts[f"dp_ls960_joint_rank{r['joint']['rank']}"] = r["joint"]["launches"][0]
        counts[f"dp_fit_rank{r['dp']['rank']}"] = r["fit"]["launches"]
    strip = lambda r: {k: v for k, v in r.items() if k != "launches"}  # noqa: E731
    numbers = {"world": DP_WORLD, "backend": "gloo", "spawn_s": spawn_s,
               "dp": [strip(r["dp"]) for r in ranks], "fsdp": [strip(r["fsdp"]) for r in ranks],
               "ls960_joint": [strip(r["joint"]) for r in ranks],
               "fit": {"world2": s2, "world1": one, "restored_dev_error": restored["error_rate"],
                       "restored_dev_loss": restored["loss"], "rel_errs": errs,
                       "wall_s": fit2["wall_s"]},
               "nccl_world1": nccl1,
               "nccl_across_cards": [strip(r) for r in across] if across else None}
    return counts, numbers


# ---- phases 71-73: tensor, sequence, expert and pipeline parallelism ---------------

# (phase, config, task module, mesh axes, placement, fsdp); world = the axes' product.
# The pipeline jobs (placement "pp") run num_pipeline_stages = the pipe axis, in the
# default 4 x stages microbatches
AXES_CONFIGS = {"ls960_conformer_ctc": (LS960_CONFORMER_CTC, "ctc_task"),
                "ls960_transformer_ctc": (LS960_TRANSFORMER_CTC, "ctc_task"),
                "ls960_moe_conformer": (LS960_MOE_CONFORMER, "ctc_task"),
                "ls_conformer_transducer": (LS_CONFORMER_TRANSDUCER, "transducer_task")}
AXES_JOBS = (
    ("71 tp2", "ls960_conformer_ctc", {"data": 1, "model": 2}, "tp", False),
    ("71 sp2", "ls960_conformer_ctc", {"data": 1, "seq": 2}, None, False),
    ("71 ep2", "ls960_moe_conformer", {"data": 1, "expert": 2}, "ep", False),
    ("71 sp2", "ls_conformer_transducer", {"data": 1, "seq": 2}, None, False),
    ("71 tp2 x sp2", "ls960_conformer_ctc", {"data": 1, "seq": 2, "model": 2}, "tp", False),
    ("71 dp2 x tp2 + fsdp", "ls960_conformer_ctc", {"data": 2, "model": 2}, "tp", True),
    ("71 ep4", "ls960_moe_conformer", {"data": 1, "expert": 4}, "ep", False),
    ("71 dp2 x ep2 + fsdp", "ls960_moe_conformer", {"data": 2, "expert": 2}, "ep", True),
    ("73 pp2", "ls960_conformer_ctc", {"data": 1, "pipe": 2}, "pp", False),
    ("73 pp2", "ls960_transformer_ctc", {"data": 1, "pipe": 2}, "pp", False),
    ("73 pp2", "ls_conformer_transducer", {"data": 1, "pipe": 2}, "pp", False),
    ("73 pp4", "ls960_conformer_ctc", {"data": 1, "pipe": 4}, "pp", False),
    ("73 dp2 x pp2", "ls960_conformer_ctc", {"data": 2, "pipe": 2}, "pp", False),
    ("73 pp2 x tp2", "ls960_conformer_ctc", {"data": 1, "pipe": 2, "model": 2}, "pp", False),
)
AXES_SEED = 71
AXES_FIT = LS960_CONFORMER_CTC | {"dropout": 1.0, "toy_num_utts": 256, "num_epoch": 1}
CANCELLED_AXES_RTOL = 1e-4  # a gradient zero in exact arithmetic, of the largest entry


# a CTC step's launches per rank: every rank, each pipeline stage too, computes the loss
AXES_STEP_WANT = dict(NONE_LAUNCHED, ctc_loss=1)
AXES_FIT_LAUNCHED = ("ctc_loss", "ctc_loss_fwd_only")  # phases 72-73's fits and bin/eval: #5, #6
AXES_EVAL_LAUNCHED = ("ctc_loss_fwd_only",)


def axes_want(config: str) -> dict | None:
    """The launches of one train step of ``config``: one #5 for the CTC models,
    none for the transducer (its loss is plain PyTorch); None checks nothing."""
    if AXES_STEP_WANT is None:
        return None
    return NONE_LAUNCHED if config == "ls_conformer_transducer" else AXES_STEP_WANT


def axes_raw(config: str, axes: dict) -> dict:
    """The config dict of a job: dropout off, the pipe axis's stages."""
    raw = dict(AXES_CONFIGS[config][0], dropout=1.0)
    return raw | ({"num_pipeline_stages": axes["pipe"]} if "pipe" in axes else {})


def axes_specs(params: dict, axes: dict, place, fsdp: bool):
    """The leaves' specs of a job (``params`` stacked for the pipeline)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
        expert_partition_specs, fsdp_partition_specs, param_partition_specs,
        pipeline_param_specs)

    if place == "pp":
        return pipeline_param_specs(params, "model" in axes)
    specs = {"tp": param_partition_specs, "ep": expert_partition_specs}[place](params) \
        if place else None
    return fsdp_partition_specs(params, axes["data"], specs) if fsdp else specs


def axes_against_one_process(what: str, config: str, axes: dict, place, fsdp: bool,
                             mesh) -> dict:
    """One Adam step of ``config`` at full width, dropout off, on this rank's
    rows and shards of the global batch; rank 0 holds it against the
    one-process step on the whole batch (loss, every gradient leaf, the
    gathered weights against the rank's own Adam step). Returns the numbers."""
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import pp_stack_tree
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.fsdp import (
        gather_whole, place as place_state)
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        TRAFFIC, reset_traffic, shard_batch)

    task_mod = {"ctc_task": ctc_task, "transducer_task": transducer_task}[AXES_CONFIGS[config][1]]
    dev = mesh.device
    task = experiment_from_dict(axes_raw(config, axes)).task(len(CHAR_UNITS))
    params = {k: v.to(dev) for k, v in
              task_mod.init_params(task, torch.Generator().manual_seed(0)).items()}
    batch = train_batch(B_TRAIN, 12.0, seed=AXES_SEED, max_labels=U)
    ref = one_process_step(task, task_mod, params, batch, dev) if mesh.rank == 0 else None
    opt = build_optimizer("adam", 5.0)
    # the pipeline holds the layers stacked [S, L/S, ...], each rank its stage
    start = pp_stack_tree(params, axes["pipe"]) if place == "pp" else params
    specs = axes_specs(start, axes, place, fsdp)
    held, state, _ = place_state(mesh, start, opt.init(start), specs)
    del start
    step = task_mod.make_train_step(task, opt, mesh=mesh, specs=specs)
    rows = shard_batch(mesh, batch)
    out = {"what": what, "config": config, "axes": axes, "rank": mesh.rank,
           "coords": mesh.coords(), "rows": len(rows["input_len"]),
           "resident_bytes": held_bytes(held) + held_bytes(state),
           "whole_bytes": 3 * held_bytes(params)}
    reset_traffic()
    held, state, aux, ms, counts = timed_step(step, held, state, rows, mesh, axes_want(config))
    out.update(ms=ms, launches=counts, loss=float(aux["loss"]),
               traffic={k: {"calls": c, "bytes": b} for k, (c, b) in TRAFFIC.items()})
    whole = gather_whole(mesh, held, specs)
    whole_state = gather_whole(mesh, state, specs)
    own = worst(leaf_errs(whole, adam_first_weights(params, whole_state)))
    if ref is not None:
        grad = {k: v / (1 - 0.9) for k, v in whole_state["mu"].items()}
        top = max(float(g.abs().max()) for g in ref["grad"].values())
        cancelled = {k: float((grad[k] - g).abs().max()) / top for k, g in ref["grad"].items()
                     if zero_gradient(task, k)}
        g_errs = leaf_errs({k: v for k, v in grad.items() if k not in cancelled},
                           {k: v for k, v in ref["grad"].items() if k not in cancelled})
        loss_err = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
        out.update(one_process_loss=ref["loss"], loss_rel_err=loss_err,
                   grad_rel_err=dict(sorted(g_errs.items(), key=lambda kv: -kv[1])[:3]),
                   cancelled=max(cancelled.values(), default=0.0), weights_vs_own_step=own,
                   weights_vs_one_process=worst(leaf_errs(whole, ref["params"])))
        if ref["nonfinite"] or not (loss_err <= DP_RTOL and max(g_errs.values()) <= DP_GRAD_RTOL
                                    and out["cancelled"] <= CANCELLED_AXES_RTOL
                                    and own[1] <= DP_RTOL):
            raise RuntimeError(f"{what} {config} disagrees with one process: loss {loss_err:.3e} "
                               f"(tolerance {DP_RTOL:g}), gradients {out['grad_rel_err']} "
                               f"(tolerance {DP_GRAD_RTOL:g}), cancelled {out['cancelled']:.3e}, "
                               f"weights against the rank's own Adam step {own}")
    elif own[1] > DP_RTOL:
        raise RuntimeError(f"{what} {config} rank {mesh.rank}: weights against its own Adam "
                           f"step {own}")
    out["replicas_bit_identical"] = same_on_ranks(mesh, whole)
    if not out["replicas_bit_identical"]:
        raise RuntimeError(f"{what} {config}: the gathered weights differ between the ranks")
    # a second step: the first carries the rank's start-up (its first collectives
    # on each group, the first launches)
    reset_traffic()
    held, state, aux, out["warm_ms"], out["warm_launches"] = timed_step(
        step, held, state, rows, mesh, axes_want(config))
    out["warm_traffic"] = {k: {"calls": c, "bytes": b} for k, (c, b) in TRAFFIC.items()}
    return out


def axes_fit(mesh, model_dir: Path, axis: str = "num_model_shards") -> dict:
    """Phase 72's ``fit`` with ``num_model_shards`` the world's size, or phase
    73's with ``num_pipeline_stages`` (``axis``; ``mesh``: the world's ranks);
    this rank's launch counts (#5 in training, #6 in its dev eval) and the
    summary."""
    exp = experiment_from_dict(dict(AXES_FIT, num_devices=mesh.size, **{axis: mesh.size}))
    reset_counts()
    t = time.perf_counter()
    summary = fit(exp, model_dir, log_every=1, print_fn=lambda *a: None, device=mesh.device)
    sync(mesh.device)
    counts = read_counts()
    launched = AXES_FIT_LAUNCHED
    if any(counts[k] < 1 for k in launched) or any(counts[k] for k in COUNTERS
                                                   if k not in launched):
        raise RuntimeError(f"rank {mesh.rank}: fit launched {counts}; expected {launched}")
    return {"summary": summary, "launches": counts, "wall_s": time.perf_counter() - t}


def axes_rank(rank: int, world: int, backend: str, store: str, out: str, jobs: tuple,
              device: str, overrides: dict) -> None:
    """One rank of phases 71-73 (a spawned process, as ``dp_rank``): the jobs
    of ``AXES_JOBS`` named in ``jobs``, then ``"fit"`` (tp) and ``"fit_pp"``;
    rank r writes ``<out>/rank<r>.pt``."""
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import make_grid, make_mesh

    globals().update(overrides)
    set_full_fp32()
    if device == "cuda":
        build.load_library()
        device = f"cuda:{rank if backend == 'nccl' else 0}"
    torch.distributed.init_process_group(backend, store=torch.distributed.FileStore(store, world),
                                         rank=rank, world_size=world)
    try:
        res = {"steps": []}
        for what, config, axes, place, fsdp in AXES_JOBS:
            if what in jobs:
                mesh = make_grid(axes, device=device)
                res["steps"].append(axes_against_one_process(what, config, axes, place, fsdp,
                                                             mesh))
        if "fit" in jobs:
            res["fit"] = axes_fit(make_mesh(world, device=device), Path(out) / "tp_fit")
        if "fit_pp" in jobs:
            res["fit_pp"] = axes_fit(make_mesh(world, device=device), Path(out) / "pp_fit",
                                     "num_pipeline_stages")
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def print_axes(r: dict, gpu: str, shared: bool = True) -> None:
    traffic = ", ".join(f"{k} {v['bytes']:,} B in {v['calls']}" for k, v in r["traffic"].items())
    line = (f"phase {r['what']} {r['config']} rank {r['rank']} {r['coords']} ({r['rows']} rows "
            f"of {B_TRAIN} x 12 s): steps {r['ms']:.3f} ms (with the rank's start-up), "
            f"{r['warm_ms']:.3f} ms ("
            + ("the ranks share one card over gloo: not a scaling number" if shared
               else "one card per rank") + f"), loss {r['loss']:.4f}, resident params + Adam "
            f"{r['resident_bytes'] / 2**20:.2f} MiB (whole {r['whole_bytes'] / 2**20:.2f} MiB), "
            f"launches {launched(r['launches'])} / {launched(r['warm_launches'])}, collectives "
            f"per step: {traffic}; gathered "
            f"weights bit-identical on every rank {r['replicas_bit_identical']}")
    if "loss_rel_err" in r:
        line += (f"; vs one process: loss {r['loss_rel_err']:.2e} (tolerance {DP_RTOL:g}), worst "
                 "gradient leaves of their max " + ", ".join(
                     f"{k} {x:.2e}" for k, x in r["grad_rel_err"].items())
                 + f" (tolerance {DP_GRAD_RTOL:g}), key biases of exact gradient 0 at "
                 f"{r['cancelled']:.2e} of the largest entry (tolerance "
                 f"{CANCELLED_AXES_RTOL:g}), weights against the rank's own Adam step "
                 f"{r['weights_vs_own_step'][1]:.2e} of max (tolerance {DP_RTOL:g}), against "
                 f"one process {r['weights_vs_one_process'][0]} "
                 f"{r['weights_vs_one_process'][1]:.2e} (reported)")
    print(line + f"  [{gpu}]", flush=True)


def run_model_axes(dev, gpu: str, work: Path, t0: float, overrides: dict | None = None) -> tuple:
    """Phases 71-73: the model axes' steps (tensor, sequence, expert shards,
    pipeline stages) against one process on worlds of 2 and 4 ranks sharing
    the card over gloo, ``fit`` with ``num_model_shards: 2`` and with
    ``num_pipeline_stages: 2`` against one process with ``bin/eval`` on each
    checkpoint, and dp2 x tp2 and pp2 x tp2 over nccl where the machine shows
    four cards. Returns (launch counts by path and rank, the numbers)."""
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = {}
    for world in (2, 4):
        jobs = tuple(n for n, _, axes, _, _ in AXES_JOBS if math.prod(axes.values()) == world)
        ranks[world] = spawn_ranks(world, "gloo", work,
                                   jobs + (("fit", "fit_pp") if world == 2 else ()),
                                   dev.type, overrides, entry=axes_rank, tag="axes")
    spawn_s = time.perf_counter() - t
    counts, steps = {}, []
    for world, rs in ranks.items():
        for i in range(len(rs[0]["steps"])):
            for r in rs:
                s = r["steps"][i]
                print_axes(s, gpu)
                tag = s["what"].split(" ", 1)[1].replace(" x ", "x").replace(" + ", "_")
                counts[f"{tag.replace(' ', '_')}_{s['config']}_rank{s['rank']}"] = s["launches"]
                steps.append({k: v for k, v in s.items() if k not in ("launches", "warm_launches")})
    clock(f"phase 71 ranks done ({spawn_s:.1f} s with the spawns)", t0)
    # phases 72-73: fit under tp2 and under pp2 against one process; bin/eval restores
    # each checkpoint alone
    one = fit(experiment_from_dict(AXES_FIT), work / "axes_fit_one", log_every=1,
              print_fn=lambda *a: None, device=dev)
    fits = {}
    for phase, key, axis, tag in (("72", "fit", "num_model_shards", "tp2"),
                                  ("73", "fit_pp", "num_pipeline_stages", "pp2")):
        fit2 = ranks[2][0][key]
        res, counts[f"eval_{tag}_checkpoint"] = run_cli(
            f"{phase} bin/eval of the {tag} checkpoint, one process", eval_cli.main,
            [str(work / "axes_gloo_2" / f"{tag[:2]}_fit"), "--device", str(dev.type),
             "--beam-width", "1"], AXES_EVAL_LAUNCHED, gpu)  # greedy, as fit's dev eval decodes
        s2 = fit2["summary"]
        errs = {"dev_loss": abs(s2["dev_loss"] - one["dev_loss"]) / abs(one["dev_loss"]),
                "train_loss": abs(s2["train_loss"] - one["train_loss"]) / abs(one["train_loss"])}
        print(f"phase {phase} fit ls960_conformer_ctc 1 toy epoch, {axis} 2 (gloo, one card): "
              f"{fit2['wall_s']:.1f} s wall, {s2['steps']} steps, dev error "
              f"{s2['dev_error_rate']:.4f} (one process: {one['dev_error_rate']:.4f}), dev loss "
              f"{s2['dev_loss']!r} ({one['dev_loss']!r}), train loss {s2['train_loss']!r} "
              f"({one['train_loss']!r}); rank launches "
              f"{[launched(r[key]['launches']) for r in ranks[2]]}; bin/eval in one process: "
              f"dev error {res['dev']['error_rate']:.4f}; relative differences "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tolerance {FIT_RTOL:g})  [{gpu}]", flush=True)
        if not (s2["dev_error_rate"] == one["dev_error_rate"] == res["dev"]["error_rate"]
                and s2["steps"] == one["steps"] and max(errs.values()) <= FIT_RTOL):
            raise RuntimeError(f"fit with {axis} 2 {s2} differs from one process {one} "
                               f"or bin/eval of its checkpoint {res['dev']}: {errs}")
        for rank, r in enumerate(ranks[2]):
            counts[f"{tag}_fit_rank{rank}"] = r[key]["launches"]
        fits[tag] = {"summary": s2, "rel_errs": errs, "bin_eval_dev": res["dev"],
                     "wall_s": fit2["wall_s"]}
    across = None
    many = torch.cuda.device_count() if dev.type == "cuda" else 0
    if many >= 4:
        across = [s for r in spawn_ranks(4, "nccl", work, ("71 dp2 x tp2 + fsdp", "73 pp2 x tp2"),
                                         entry=axes_rank, tag="axes") for s in r["steps"]]
        for r in across:
            print_axes(r, gpu, shared=False)
    else:
        print(f"phases 72-73 dp2 x tp2 and pp2 x tp2 over nccl, one card per rank: the machine "
              f"shows {many} card; not run (not a pass)", flush=True)
    clock("phases 71-73 (tensor, sequence, expert and pipeline parallelism) done", t0)
    return counts, {"spawn_s": spawn_s, "steps": steps,
                    "fit": dict(fits, one_process=one), "nccl_across_cards": across}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile-out", default=None,
                    help="directory for the train steps' full profile tables "
                         "(<config>_train_step_profile.txt)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 2
    set_full_fp32()
    dev = torch.device("cuda", 0)
    gpu = gpu_name_and_power()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}  [{gpu}]", flush=True)
    with tempfile.TemporaryDirectory() as work:  # the fit phases' model dirs, the LM dir
        return run(args, dev, gpu, Path(work))


def run(args, dev, gpu: str, work: Path) -> int:
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"phase build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}", flush=True)
    print(lib_path.with_suffix(".log").read_text().strip(), flush=True)

    serving_fwd = check_serving_kernel(dev, gpu)
    results = check_training_lstm(dev, gpu)
    results.update(check_ctc(dev, gpu))
    clock("kernels #1, #2, #5, #6 checked", t0)

    task = ls100_ctc_task()
    params_cpu = ctc_task.init_params(task, torch.Generator().manual_seed(0))
    model_cpu = ctc_task.init_model(task)
    model_cpu.load_state_dict(params_cpu)
    model = copy.deepcopy(model_cpu).to(dev).eval()
    check_model(task, model_cpu, model, dev)
    check_train_step(task, ctc_task, params_cpu, dev)
    clock("ls100_ctc card == CPU", t0)
    time_phases(task, model, dev, gpu)
    counts = {"serving": serve_requests(task, model, gpu)}
    check_ctc_beam(task, model, dev)
    ctc_beam = time_ctc_beam(task, model, dev, gpu)
    counts["ctc_beam_serving"] = serve_ctc_beam_requests(task, model, gpu)
    del model
    clock("ls100_ctc served, greedy and prefix beam", t0)
    time_train_steps("ls100_ctc", task, ctc_task, params_cpu, dev, gpu, args.profile_out,
                     dict(NONE_LAUNCHED, lstm_bidi_fwd=LAYERS, lstm_bidi_bwd=LAYERS, ctc_loss=1),
                     LAYERS)
    counts["training"] = train_one_epoch(
        "ls100_ctc", LS100_CTC, gpu,
        ("lstm_bidi_fwd", "lstm_bidi_bwd", "ctc_loss", "ctc_loss_fwd_only"), work / "ls100_ctc")
    clock("ls100_ctc trained", t0)

    results["location_attend"] = check_attention_kernel(dev, gpu)
    pyramidal = check_pyramidal_lstm(dev, gpu)
    clock("kernel #7 and #1 at T=1198 checked", t0)
    att = ls960_joint_task()
    att_cpu = att_task.init_model(att, torch.Generator().manual_seed(0)).eval()
    att_model = copy.deepcopy(att_cpu).to(dev).eval()
    check_att_model(att, att_cpu, att_model, dev)
    check_att_beam_eval(att, att_cpu, att_model, dev)
    clock("ls960_joint card == CPU", t0)
    time_att_phases(att, att_model, dev, gpu)
    rescoring = check_rescoring_ctc(dev, gpu)
    att_beam_eval = time_att_beam_eval(att, att_model, dev, gpu)
    counts["att_serving"] = serve_att_requests(att, att_model, gpu)
    del att_model
    clock("ls960_joint served; #6 at the rescoring shape and the beam eval step timed", t0)

    att_lstm = check_training_lstm(dev, gpu, t=T_PYR, d=D_PYR, seed=26, what="pyramidal train")
    att_grad = check_attention_grad(dev, gpu)
    clock("kernels #1, #2 at T=1198 and #7's gradient checked", t0)
    att_params = att_task.init_params(att, torch.Generator().manual_seed(0))
    check_train_step(ls960_joint_task(dropout=1.0), att_task, att_params, dev, seed=27,
                     max_labels=6)
    clock("ls960_joint train step card == CPU", t0)
    print(f"ls960_joint timed steps at global step {ATT_TRAIN_STEP}: scheduled sampling "
          f"{att_task.scheduled_sampling_prob(att, ATT_TRAIN_STEP):g}, CTC lambda "
          f"{att_task.ctc_lambda(att, ATT_TRAIN_STEP):g}, guided-attention weight "
          f"{att_task.ga_weight_schedule(att, ATT_TRAIN_STEP):g}", flush=True)
    joint32 = time_train_steps("ls960_joint", att, att_task, att_params, dev, gpu,
                               args.profile_out,
                               dict(NONE_LAUNCHED, lstm_bidi_fwd=LAYERS, lstm_bidi_bwd=LAYERS,
                                    ctc_loss=1),
                               LAYERS, shape=f"T={T_PYR} -> T'={ATT_T}",
                               global_step=ATT_TRAIN_STEP)
    counts["att_training"] = train_one_epoch(
        "ls960_joint", LS960_JOINT, gpu,
        ("lstm_bidi_fwd", "lstm_bidi_bwd", "ctc_loss", "location_attend"), work / "ls960_joint")
    clock("ls960_joint trained", t0)
    counts.update(run_clis(work / "ls100_ctc", work / "ls960_joint", work / "lm", gpu))
    check_fusion(task, model_cpu, copy.deepcopy(model_cpu).to(dev).eval(), att, att_cpu,
                 copy.deepcopy(att_cpu).to(dev).eval(), work / "lm", dev)
    clock("bin/eval, bin/decode, bin/train_lm and fusion run", t0)

    results.update(check_layer_kernels(dev, gpu))
    clock("kernels #3, #4 checked", t0)
    tr = ls_transducer_task()
    tr_params = transducer_task.init_params(tr, torch.Generator().manual_seed(0))
    tr_cpu = transducer_task.init_model(tr)
    tr_cpu.load_state_dict(tr_params)
    tr_model = copy.deepcopy(tr_cpu).to(dev).eval()
    check_transducer_model(tr, tr_cpu.eval(), tr_model, dev)
    check_train_step(tr, transducer_task, tr_params, dev, seed=25)
    clock("ls_transducer card == CPU", t0)
    time_transducer_phases(tr, tr_model, dev, gpu)
    counts["transducer_serving"] = serve_transducer_requests(tr, tr_model, gpu)
    del tr_model
    clock("ls_transducer served", t0)
    time_train_steps("ls_transducer", tr, transducer_task, tr_params, dev, gpu,
                     args.profile_out, dict(NONE_LAUNCHED, lstm_layer_fwd=TR_LAYERS,
                                            lstm_layer_bwd=TR_LAYERS), TR_LAYERS,
                     steps=TR_TIMED_STEPS)
    clock("ls_transducer train steps timed", t0)
    # 256 utterances instead of the config's 2048: one epoch within the time limit
    counts["transducer_training"] = train_one_epoch(
        "ls_transducer", dict(LS_TRANSDUCER, toy_num_utts=256), gpu,
        ("lstm_layer_fwd", "lstm_layer_bwd"), work / "ls_transducer")
    clock("ls_transducer trained", t0)
    conformer_counts, conformer = run_conformer(args, dev, gpu, work, t0)
    counts.update(conformer_counts)
    family_counts, family_kernels, families = run_families(args, dev, gpu, work, t0)
    counts.update(family_counts)
    stream_counts, carry, stream_numbers = run_streaming(dev, gpu, work, t0)
    counts.update(stream_counts)
    bf16_counts, bf16_kernels, bf16_numbers = run_bf16(
        args, dev, gpu, t0, params_cpu, conformer["conformer_ctc_512x8_train_step"])
    counts.update(bf16_counts)
    att_bf16_counts, att_bf16_kernel, att_bf16_numbers = run_attention_bf16(
        args, dev, gpu, t0, joint32)
    counts.update(att_bf16_counts)
    data_root_counts, data_root = run_data_root(args, dev, gpu, work, t0, params_cpu)
    counts.update(data_root_counts)
    export_counts, exported = run_export(args, dev, gpu, work, t0)
    counts.update(export_counts)
    carry_bf16 = check_carry_bf16_kernel(dev, gpu)
    clock("kernel #3's carried walk with bf16 products checked", t0)
    stream_bf16_counts, stream_bf16 = run_stream_bf16(dev, gpu, t0, stream_numbers)
    counts.update(stream_bf16_counts)
    zoo_counts, zoo = run_encoder_zoo(args, dev, gpu, work, t0)
    counts.update(zoo_counts)
    dp_counts, data_parallel = run_data_parallel(dev, gpu, work, t0)
    counts.update(dp_counts)
    axes_counts, model_axes = run_model_axes(dev, gpu, work, t0)
    counts.update(axes_counts)
    # the bf16 products' gradient from the float32 cotangent, read off phases 45 and 48
    head, conf = bf16_numbers["headline"], bf16_numbers["conformer_512x8"]
    cublas = conf[BF16]["by_kind"].get("matmul (cuBLAS)", {"ms": 0.0, "launches": 0})
    f1 = {"headline_grad_rel_err": head["card_vs_cpu"]["grad_rel_err"],
          "headline_bf16_ms": head[BF16]["ms"],
          "conformer_512x8_grad_rel_err": conf["card_vs_cpu"]["grad_rel_err"],
          "conformer_512x8_bf16_ms": conf[BF16]["ms"], "conformer_512x8_cublas": cublas}
    print(f"bf16 products' gradients from the float32 cotangent: headline bf16 step "
          f"{f1['headline_bf16_ms']:.3f} ms, gradients card vs CPU "
          f"{f1['headline_grad_rel_err']:.2e} of their maximum (gate {BF16_GRAD_RTOL:g}); "
          f"conformer 512 x 8 bf16 step {f1['conformer_512x8_bf16_ms']:.3f} ms, cuBLAS "
          f"{cublas['ms']:.3f} ms in {cublas['launches']} launches, gradients "
          f"{f1['conformer_512x8_grad_rel_err']:.2e} of their maximum  [{gpu}]", flush=True)

    # "launches": the count on the path that ported the kernel (CTC training
    # for #1, #2, #5, #6; attention serving for #7; transducer training for
    # #3, #4); every path's count beside it (attention training:
    # "launches_att_training")
    main_path = {"location_attend": "att_serving", "lstm_layer_fwd": "transducer_training",
                 "lstm_layer_bwd": "transducer_training"}
    entries = []
    for name, meta in KERNELS.items():
        if name.endswith("_bf16"):
            continue  # below
        r = results[name]
        entries.append({
            "name": name, "route": "cuda", **meta,
            "launches": counts[main_path.get(name, "training")][name],
            **{f"launches_{path}": c[name] for path, c in counts.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        if name == "location_attend":
            entries[-1].update(group=BEAM, split_us=r["split_us"], n8=r["n8"], tiled=r["tiled"],
                               backward=att_grad)
        if name in ("lstm_bidi_fwd", "lstm_layer_fwd"):
            shapes = {"serving": serving_fwd if name == "lstm_bidi_fwd" else r["serving"]}
            if name == "lstm_bidi_fwd":
                shapes["pyramidal"] = pyramidal
                shapes["att_training"] = att_lstm[name]
            entries[-1].update(us_per_step=r["us_per_step"], plan=r["plan"],
                               deterministic=r["deterministic"])
            for shape, x in shapes.items():
                entries[-1][shape] = {k: x[k] for k in (
                    "ms", "us_per_step", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "plan", "deterministic")}
        if name in ("ctc_loss", "ctc_loss_fwd_only"):
            entries[-1].update({k: v for k, v in r.items() if k not in entries[-1]})
        if name in ("lstm_bidi_bwd", "lstm_layer_bwd"):
            entries[-1].update(us_per_step=r["ms"] * 1e3 / T_ENC, plan=r["plan"],
                               deterministic=r["deterministic"],
                               function_backward_ms=r["function_backward_ms"])
        if name == "lstm_bidi_bwd":
            entries[-1]["att_training"] = {k: att_lstm[name][k] for k in (
                "ms", "us_per_step", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "plan", "deterministic", "function_backward_ms")}
        # the shapes of the VGG, multitask, BPE and word configs (phase 32)
        if name in ("lstm_bidi_fwd", "lstm_bidi_bwd"):
            for shape in ("csj_train", "timit_train"):
                entries[-1][shape] = {k: v for k, v in family_kernels[shape][name].items()
                                      if k not in ("ms_runs", "plain_ms_runs")}
        if name in ("ctc_loss", "ctc_loss_fwd_only"):
            for shape in ("c62", "c87", "c1030"):
                entries[-1][shape] = family_kernels[shape][name]
        if name == "location_attend":
            entries[-1]["location_a128"] = family_kernels["location_a128"]
    # #6 at the rescoring shape: launches on the ls960_joint bin/eval path (beam 8
    # with joint rescoring; one call per eval batch)
    entries.append({
        "name": "ctc_loss_fwd_only_rescoring", "route": "cuda", **KERNELS["ctc_loss_fwd_only"],
        "launches": counts["eval_joint"]["ctc_loss_fwd_only"],
        **{k: rescoring[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "shape": f"N={B_ATT * BEAM} T={ATT_T} C={C} U<={RESCORE_U}",
        **{k: v for k, v in rescoring.items() if k not in ("max_abs_err", "ms", "plain_ms",
                                                           "bound_ms", "bound_by",
                                                           "library_ms")},
        "att_beam_eval": att_beam_eval,
    })
    # #3 resuming from a carried state: launches on the streaming serving path
    # (bin/serve --stream ls_streaming_ctc), at its chunk shape, and at
    # ls_transducer's beside it
    c = carry["ls_streaming_ctc"]
    entries.append({
        "name": "lstm_layer_fwd_carry", "route": "cuda", **KERNELS["lstm_layer_fwd"],
        "launches": counts["stream_serving"]["lstm_layer_fwd"],
        **{f"launches_{path}": x["lstm_layer_fwd"] for path, x in stream_counts.items()},
        **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
        **{k: c[k] for k in ("shape", "eager_ms", "library_graph_ms", "us_per_step", "plan",
                             "deterministic")},
        "device_launches": {k: v["per_call"] for k, v in c["device_launches"].items()},
        "ls_transducer": {k: v for k, v in carry["ls_transducer"].items()
                          if k not in ("ms_runs", "plain_ms_runs", "device_launches")},
    })
    # the bf16-stream instantiations (phases 44-47): launches on the bf16 headline
    # step (#1, #2) and the ls_transducer bf16 train step (#3, #4); numbers at the
    # headline's B=128 (#1, #2) or the transducer step's B=32 (#3, #4), the other
    # shape beside them
    for name, shapes in bf16_kernels.items():
        bidi = name.startswith("lstm_bidi")
        main, path = ("b128", "bf16_headline") if bidi else ("b32", "bf16_transducer_training")
        r = shapes[main]
        entries.append({
            "name": name, "route": "cuda", **KERNELS[name], "launches": counts[path][name],
            **{f"launches_{p}": c[name] for p, c in counts.items()},
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            "shape": f"B={B_HEAD if bidi else B_TRAIN} T={T_ENC} H={H}",
            **{k: r[k] for k in ("float32_ms", "us_per_step", "device_launches",
                                 "library_note")},
            **{shape: {k: v for k, v in x.items() if k != "ms_runs"}
               for shape, x in shapes.items() if shape != main},
        })
    # #7 on bf16 rows (phase 49): launches on the ls960_joint bf16 serving path,
    # numbers at its beam call, the greedy and csj_joint calls beside them
    r = att_bf16_kernel["grouped"]
    entries.append({
        "name": "location_attend_bf16", "route": "cuda", **KERNELS["location_attend_bf16"],
        "launches": counts["bf16_att_serving"]["location_attend_bf16"],
        **{f"launches_{p}": c["location_attend_bf16"] for p, c in counts.items()},
        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
        **{k: r[k] for k in ("shape", "float32_ms", "ms_runs", "plain_ms_runs")},
        "device_launches": {k: v["per_call"] for k, v in r["device_launches"].items()},
        **{name: {k: v for k, v in x.items() if k != "device_launches"}
           for name, x in att_bf16_kernel.items() if name != "grouped"},
    })
    # #3's carried walk with bf16 products (phase 59): launches on the bf16 stream of
    # ls_streaming_ctc (phase 60), at its chunk shape, and at ls_transducer's beside it
    c = carry_bf16["ls_streaming_ctc"]
    entries.append({
        "name": "lstm_layer_fwd_carry_bf16", "route": "cuda",
        **KERNELS["lstm_layer_fwd_carry_bf16"],
        "launches": counts["bf16_stream_ls_streaming_ctc"]["lstm_layer_fwd_carry_bf16"],
        **{f"launches_{path}": x["lstm_layer_fwd_carry_bf16"] for path, x in counts.items()},
        **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
        **{k: c[k] for k in ("shape", "eager_ms", "float32_ms", "library_graph_ms",
                             "one_step_err", "versus_float32_walk", "us_per_step", "plan",
                             "deterministic")},
        "device_launches": {k: v["per_call"] for k, v in c["device_launches"].items()},
        "ls_transducer": {k: v for k, v in carry_bf16["ls_transducer"].items()
                          if k not in ("ms_runs", "plain_ms_runs", "device_launches")},
    })
    print(json.dumps({"kernels": entries, "ctc_prefix_beam": ctc_beam, "conformer": conformer,
                      "families": families, "streaming": stream_numbers,
                      "bf16": dict(bf16_numbers, f1=f1),
                      "attention_bf16": att_bf16_numbers, "data_root": data_root,
                      "export": exported, "stream_bf16": stream_bf16,
                      "encoder_zoo": zoo, "data_parallel": data_parallel,
                      "model_axes": model_axes}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
