"""Decode entry point: restore a checkpoint and print hypotheses beside references.

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.decode \\
        /tmp/model_dir [--beam-width 20] [--joint-rescore] [--nbest 2] \\
        [--num-utts 8] [--lm-dir DIR] [--device cuda]

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/decode.py``,
same options and output (``[name] score``, ``REF:``, ``HYP:``, ``HYPn
(score)``): greedy decoding for the CTC and transducer models, at
``--beam-width`` above 1 the CTC prefix beam or the transducer beam, and
for attention models the attention beam at ``max(--beam-width, 1)`` with
``--length-penalty`` and ``--joint-rescore`` (joint models); RNN-LM fusion
(``--lm-dir``) in every beam. A ``data_root`` model reads the dev or test
split's ``.npy`` features. Runs on the card (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import set_full_fp32
from ..data.dataset import Dataset, to_device
from ..decoding import attention_beam_search, ctc_greedy_decode, ctc_prefix_beam_search
from ..decoding.joint_rescoring import joint_rescore
from ..decoding.transducer_beam import transducer_beam_search
from ..decoding.transducer_greedy import transducer_greedy_decode
from ..train.ctc_task import device_pipeline
from ..train.loop import build_corpus_splits, build_task, cmvn_stats_for, feature_dim_of
from ..utils.config import ATTENTION_MODEL_TYPES, ExperimentConfig
from .eval import open_device, restore_model


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model_dir")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--beam-width", type=int, default=1)
    ap.add_argument("--joint-rescore", action="store_true")
    ap.add_argument("--length-penalty", type=float, default=0.0)
    ap.add_argument("--num-utts", type=int, default=8)
    ap.add_argument("--nbest", type=int, default=1,
                    help="print the top-N beam hypotheses per utterance "
                         "(beam decodes only; capped at beam width)")
    ap.add_argument("--data", choices=("dev", "test"), default="test")
    ap.add_argument("--lm-dir", default=None, help="RNN-LM dir from bin.train_lm")
    ap.add_argument("--lm-weight", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    set_full_fp32()
    device = open_device(args.device)

    lm = None
    if args.lm_dir:
        from .train_lm import load_lm

        lm = load_lm(args.lm_dir, device)
    model_dir = Path(args.model_dir)
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    _, dev_utts, test_utts, tokenizer = build_corpus_splits(exp, need=("dev", "test"))
    utts = (dev_utts if args.data == "dev" else test_utts)[: args.num_utts]
    task, task_mod = build_task(exp, tokenizer, feature_dim_of(utts))
    epoch, model = restore_model(model_dir, task, task_mod, args.epoch, device)
    batch = next(Dataset(utts, len(utts),
                         cmvn_stats=cmvn_stats_for(exp, task, utts, device)).batches(0))

    with torch.inference_mode():
        feats, fl = device_pipeline(task, to_device(batch, device))
        if exp.model_type == "transducer":
            f_proj, enc_len = model.encode(feats, fl)
            if args.beam_width > 1:
                fusion_lm = None
                if lm is not None:
                    from ..models.lm import make_fusion_lm

                    fusion_lm = make_fusion_lm(lm, task.model.vocab_with_blank)
                hyps, hyp_len, scores = transducer_beam_search(
                    model, f_proj, enc_len, beam_width=args.beam_width, fusion_lm=fusion_lm,
                    lm_weight=args.lm_weight if fusion_lm is not None else 0.0)
            else:
                d, dl = transducer_greedy_decode(model, f_proj, enc_len)
                hyps, hyp_len, scores = d[:, None], dl[:, None], torch.zeros((d.shape[0], 1))
        elif exp.model_type in ATTENTION_MODEL_TYPES:
            result = attention_beam_search(
                model, feats, fl, beam_width=max(args.beam_width, 1),
                length_penalty=args.length_penalty, lm=lm,
                lm_weight=args.lm_weight if lm is not None else 0.0)
            if args.joint_rescore:
                cfg = task.model
                if not cfg.is_joint:
                    raise SystemExit("--joint-rescore requires a joint_ctc_attention model")
                result = joint_rescore(result, cfg.ctc_loss_weight, cfg.num_classes,
                                       args.length_penalty)
            hyps, hyp_len, scores = result.tokens, result.lengths, result.scores
        else:
            if lm is not None and args.beam_width <= 1:
                print("WARNING: --lm-dir has no effect on greedy decode "
                      "(beam_width <= 1); pass --beam-width N for LM fusion")
            out = model(feats, fl)
            if args.beam_width > 1:
                fusion_lm = None
                if lm is not None:  # carried-state fusion: O(T) LM steps per utterance
                    from ..models.lm import make_fusion_lm

                    fusion_lm = make_fusion_lm(lm, task.model.vocab_with_blank)
                hyps, hyp_len, scores = ctc_prefix_beam_search(
                    out.logits, out.logit_len, task.model.blank_id,
                    beam_width=args.beam_width, fusion_lm=fusion_lm,
                    lm_weight=args.lm_weight if fusion_lm is not None else 0.0)
            else:
                d, dl = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
                hyps, hyp_len, scores = d[:, None], dl[:, None], torch.zeros((d.shape[0], 1))
        hyps, hyp_len, scores = (np.asarray(x.cpu()) for x in (hyps, hyp_len, scores))

    lines = [f"# model {exp.model_type}/{exp.encoder_type} epoch {epoch} "
             f"beam {args.beam_width}{' +joint-rescore' if args.joint_rescore else ''}"]
    n_best = max(1, min(args.nbest, hyps.shape[1]))
    for i, name in enumerate(batch["names"]):
        if name is None:
            continue
        ref = " ".join(tokenizer.decode([j for j in batch["labels"][i] if j >= 0]))
        lines += [f"[{name}] score {scores[i, 0]:.2f}", f"  REF: {ref}"]
        for r in range(n_best):
            hyp = " ".join(tokenizer.decode(hyps[i, r][: hyp_len[i, r]]))
            tag = "HYP" if r == 0 else f"HYP{r + 1} (score {scores[i, r]:.2f})"
            lines.append(f"  {tag}: {hyp}")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
