"""Export a trained model as the port's serving artifact: its weights and contract.

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.export \\
        /tmp/model_dir /tmp/model.art [--batch 8] [--seconds 12] [--frames N] \\
        [--beam-width 20] [--epoch N] [--platforms cuda cpu] [--lm-dir DIR] \\
        [--lm-weight 0.3] [--streaming --chunk-ms 100] [--selfcheck] [--device cuda]

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/export.py``.
Rebuilds the task from the model dir's ``config.yml`` (the feature dim from
the dev split of a ``data_root`` corpus), restores the best epoch (or
``--epoch N``) on ``--device`` as ``bin/eval`` does, and writes ``OUT`` (the
weights, ``serving.export_model``) and ``OUT.json`` (the serving contract,
with the units and the config: ``bin/serve OUT`` needs neither the model dir
nor the corpus). ``--frames`` pads a features model's inputs (default 1200
frames), ``--seconds`` a waveform model's. ``--streaming`` exports the
chunked streaming step instead (causal configs; chunks of ``--chunk-ms``,
aligned down to the hop). ``--platforms`` lists the device types the
artifact may load on, by default ``--device``'s. ``--selfcheck`` loads the
artifact on ``--device`` and runs it on zeros. A model exported from a
``cmvn: speaker`` corpus expects features normalised already: the artifact
applies no speaker statistics, as the JAX artifact applies none.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..serving import export_model, export_streaming_model, load_exported, load_streaming
from ..train.loop import build_corpus_splits, build_task, feature_dim_of
from ..utils.config import ExperimentConfig
from .eval import open_device, restore_model


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model_dir")
    ap.add_argument("out_path")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=12.0,
                    help="padded audio seconds (frontend mode) per utterance")
    ap.add_argument("--frames", type=int, default=None,
                    help="padded frames (precomputed-feature mode)")
    ap.add_argument("--beam-width", type=int, default=1)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--platforms", nargs="*", default=None,
                    help="device types the artifact loads on (default: --device's)")
    ap.add_argument("--lm-dir", default=None,
                    help="RNN-LM dir from bin.train_lm: shallow fusion in the beam (batch "
                         "and --streaming artifacts; needs --beam-width > 1)")
    ap.add_argument("--lm-weight", type=float, default=0.3)
    ap.add_argument("--streaming", action="store_true",
                    help="export the chunked streaming step instead of the batch pipeline "
                         "(causal configs only; streaming.py)")
    ap.add_argument("--chunk-ms", type=float, default=100.0, help="streaming chunk duration")
    ap.add_argument("--selfcheck", action="store_true",
                    help="reload the artifact and run it on zeros")
    ap.add_argument("--device", default="cuda",
                    help="where the checkpoint is restored and the self-check runs")
    args = ap.parse_args(argv)
    device = open_device(args.device)

    model_dir = Path(args.model_dir)
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    _, dev_utts, _, tokenizer = build_corpus_splits(exp, need=("dev",))
    task, task_mod = build_task(exp, tokenizer, feature_dim_of(dev_utts))
    epoch, model = restore_model(model_dir, task, task_mod, args.epoch, device)
    platforms = tuple(args.platforms) if args.platforms else (device.type,)

    lm = None
    if args.lm_dir:
        from .train_lm import load_lm

        lm = load_lm(args.lm_dir, device)

    if args.streaming:
        if task.frontend is None:
            raise SystemExit("--streaming needs the waveform frontend; this model was "
                             "trained on precomputed features (data_root mode)")
        hop = task.frontend.frame_step
        chunk = max(hop, int(args.chunk_ms / 1000.0 * task.frontend.sample_rate))
        chunk -= chunk % hop  # must be hop-aligned
        out = export_streaming_model(
            task, model, args.out_path, args.batch, chunk, units=tokenizer.units,
            label_type=exp.label_type, experiment=exp, platforms=platforms,
            extra_meta={"label_type": exp.label_type, "sample_rate": task.frontend.sample_rate,
                        "lm_weight": args.lm_weight if lm else 0.0},
            beam_width=args.beam_width, lm=lm, lm_weight=args.lm_weight)
        print(f"exported epoch-{epoch} streaming {exp.model_type}/{exp.encoder_type} chunk "
              f"{chunk} samples beam {args.beam_width} -> {out} "
              f"({out.stat().st_size / 1e6:.1f} MB)", flush=True)
        if args.selfcheck:
            state, step, finalize = load_streaming(out, device)
            zeros = np.zeros((args.batch, chunk), np.float32)
            lens = np.full((args.batch,), chunk, np.int32)
            state, tokens, n = step(state, zeros, lens)
            state, tokens, n = step(state, zeros, lens)
            msg = (f"selfcheck ok: tokens {tuple(tokens.shape)}, counts "
                   f"{n.cpu().tolist()}")
            if finalize is not None:
                pref = finalize(state)[0]
                msg += f", beam final {tuple(pref.shape)}"
            print(msg, flush=True)
        return out

    if task.frontend is not None:
        num = int(args.seconds * task.frontend.sample_rate)
    else:
        num = args.frames or 1200
    out = export_model(
        task, model, args.out_path, args.batch, num, beam_width=args.beam_width,
        units=tokenizer.units, label_type=exp.label_type, experiment=exp, platforms=platforms,
        extra_meta={"label_type": exp.label_type, "model_type": exp.model_type,
                    "sample_rate": task.frontend.sample_rate
                    if task.frontend is not None else None},
        lm=lm, lm_weight=args.lm_weight)
    print(f"exported epoch-{epoch} {exp.model_type}/{exp.encoder_type} beam {args.beam_width} "
          f"-> {out} ({out.stat().st_size / 1e6:.1f} MB)", flush=True)
    if args.selfcheck:
        infer = load_exported(out, device)
        inputs = np.zeros((args.batch, num) if task.frontend is not None
                          else (args.batch, num, task.feature_dim), np.float32)
        lens = np.full((args.batch,), num, np.int32)
        decoded, dec_len = infer(inputs, lens)
        print(f"selfcheck ok: decoded {tuple(decoded.shape)}, lengths "
              f"{dec_len.cpu().tolist()}", flush=True)
    return out


if __name__ == "__main__":
    main()
