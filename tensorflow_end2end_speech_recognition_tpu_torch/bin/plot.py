"""Plots of a trained model dir: training curves, CTC posterior spikes,
attention heatmaps.

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.plot \\
        /tmp/model_dir [--epoch N] [--utt-index 0] [--device cuda]

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/plot.py``:
writes ``loss.png`` and ``ler.png`` from ``metrics.csv``, restores the best
epoch (or ``--epoch N``) with ``bin/eval.restore_model``, runs the first
dev batch and plots utterance ``--utt-index`` of it: the per-frame CTC
posteriors of a CTC model (``ctc_probs_utt<i>.png``), or the alignments of
an attention model's greedy decode (``attention_weights_utt<i>.png``).
Needs matplotlib (imported when a plot is drawn). Runs on the card
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import set_full_fp32
from ..data.dataset import Dataset, to_device
from ..models.seq2seq import greedy_decode
from ..ops.ctc import ctc_posteriors
from ..train.ctc_task import device_pipeline
from ..train.loop import build_corpus_splits, build_task, cmvn_stats_for, feature_dim_of
from ..utils.config import ATTENTION_MODEL_TYPES, CTC_MODEL_TYPES, ExperimentConfig
from ..utils.plot import plot_attention_weights, plot_ctc_posteriors, plot_training_curves
from .eval import open_device, restore_model


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model_dir")
    ap.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: best)")
    ap.add_argument("--utt-index", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    set_full_fp32()
    device = open_device(args.device)

    model_dir = Path(args.model_dir)
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    if exp.model_type not in CTC_MODEL_TYPES + ATTENTION_MODEL_TYPES:
        raise SystemExit(f"bin/plot draws CTC posteriors or attention weights; model_type "
                         f"{exp.model_type!r} has neither")
    made = [str(p) for p in plot_training_curves(model_dir)]

    _, dev_utts, _, tokenizer = build_corpus_splits(exp, need=("dev",))
    task, task_mod = build_task(exp, tokenizer, feature_dim_of(dev_utts))
    _, model = restore_model(model_dir, task, task_mod, args.epoch, device)
    ds = Dataset(dev_utts, min(8, len(dev_utts)),
                 cmvn_stats=cmvn_stats_for(exp, task, dev_utts, device))
    batch = next(ds.batches(0))
    i = args.utt_index
    n_rows = sum(1 for n in batch["names"] if n is not None)
    if not 0 <= i < n_rows:
        raise SystemExit(f"--utt-index {i} out of range (batch has {n_rows} utts)")

    with torch.inference_mode():
        feats, feat_len = device_pipeline(task, to_device(batch, device))
        if exp.model_type in CTC_MODEL_TYPES:
            out = model(feats, feat_len)
            post = ctc_posteriors(out.logits[i, : int(out.logit_len[i])]).cpu().numpy()
            made.append(str(plot_ctc_posteriors(
                post, model_dir / f"ctc_probs_utt{i}.png", blank_id=task.model.blank_id,
                unit_names=tokenizer.units)))
        else:
            out = greedy_decode(model, feats, feat_len)
            hyp = tokenizer.decode(out.predicted_ids[i].cpu().numpy())
            made.append(str(plot_attention_weights(
                out.attention_weights[i, : max(len(hyp), 1)].cpu().numpy(),
                model_dir / f"attention_weights_utt{i}.png", hyp_tokens=hyp or None)))
    print("wrote:", *made, sep="\n  ")
    return made


if __name__ == "__main__":
    main()
