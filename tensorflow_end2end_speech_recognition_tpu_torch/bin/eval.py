"""Evaluation entry point: restore a checkpoint and score the dev and test sets.

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.eval \\
        /tmp/model_dir [--epoch N] [--beam-width W] [--lm-dir DIR] [--device cuda]

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/eval.py``:
rebuilds the task from the model dir's ``config.yml``, restores the best
epoch (or ``--epoch N``) that ``bin/train`` saved, and prints the error
rate, its substitution / insertion / deletion split, the WER of character
models and the loss for each set. A beam width above 1 (the config's
``beam_width``, or ``--beam-width``) decodes CTC models with the prefix
beam and attention models with the attention beam, joint models re-ranked
by joint CTC rescoring at their ``ctc_loss_weight``; ``--lm-dir`` (from
``bin/train_lm``) fuses an RNN-LM into either beam. A ``data_root`` model
is scored on every split on disk whose name does not start with "train",
each loaded when its turn comes and freed after it. Runs on the card
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import set_full_fp32
from ..data.dataset import Dataset
from ..train.checkpoint import CheckpointManager
from ..data.npy_corpus import available_splits, load_npy_split
from ..train.loop import build_corpus_splits, build_task, cmvn_stats_for, feature_dim_of
from ..utils.config import ATTENTION_MODEL_TYPES, ExperimentConfig
from ..utils.metrics import evaluate_ctc


def open_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} needs a CUDA card; pass --device cpu for the CPU")
    return device


def restore_model(model_dir: Path, task, task_mod, epoch: int | None, device):
    """(epoch, model on ``device``) from the best or the given checkpoint; the
    weights must match the task's model exactly."""
    epoch, state = CheckpointManager(model_dir / "checkpoints").restore({"params": None}, epoch)
    model = task_mod.init_model(task)
    model.load_state_dict(state["params"])
    return epoch, model.to(device).eval()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model_dir")
    ap.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: best)")
    ap.add_argument("--beam-width", type=int, default=None,
                    help="override config beam_width (1 = greedy)")
    ap.add_argument("--lm-dir", default=None,
                    help="RNN-LM dir from bin.train_lm: shallow fusion in the beam")
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
    if exp.data_root is not None:
        # every non-train split, each split's features in memory only while it is scored
        _, _, _, tokenizer = build_corpus_splits(exp, need=())
        names = [s for s in available_splits(exp.data_root) if not s.startswith("train")]
        if not names:
            raise SystemExit(f"no non-train splits found under {exp.data_root}")
        loaded = {names[0]: load_npy_split(exp.data_root, names[0], tokenizer)}
        feature_dim = feature_dim_of(loaded[names[0]])
        sets = [(name, lambda name=name: loaded.pop(name, None)
                 or load_npy_split(exp.data_root, name, tokenizer)) for name in names]
    else:
        _, dev_utts, test_utts, tokenizer = build_corpus_splits(exp, need=("dev", "test"))
        sets = [("dev", lambda: dev_utts), ("test", lambda: test_utts)]
        feature_dim = None
    task, task_mod = build_task(exp, tokenizer, feature_dim)
    epoch, model = restore_model(model_dir, task, task_mod, args.epoch, device)
    params = dict(model.state_dict())
    beam_width = args.beam_width if args.beam_width is not None else exp.beam_width
    if beam_width and beam_width > 1:
        if exp.model_type in ATTENTION_MODEL_TYPES:
            eval_step = task_mod.make_beam_eval_step(
                task, beam_width, exp.length_penalty,
                joint_rescore_weight=exp.ctc_loss_weight
                if exp.model_type == "joint_ctc_attention" else None,
                lm=lm, lm_weight=args.lm_weight)
        else:
            eval_step = task_mod.make_beam_eval_step(task, beam_width, lm=lm,
                                                     lm_weight=args.lm_weight)
        print(f"decoding with beam width {beam_width}"
              + (f" + LM fusion w={args.lm_weight}" if lm is not None else ""))
    else:
        if lm is not None:
            print("warning: --lm-dir requires beam decoding; ignored for greedy")
        eval_step = task_mod.make_eval_step(task)
    results = {}
    for name, load_set in sets:
        utts = load_set()
        ds = Dataset(utts, exp.eval_batch_size or exp.batch_size,
                     cmvn_stats=cmvn_stats_for(exp, task, utts, device))
        m = results[name] = evaluate_ctc(eval_step, params, ds, tokenizer, exp.label_type,
                                         device=device)
        del utts, ds  # free this split before the next loads
        wer = f" wer {m['wer']:.4f}" if "wer" in m else ""
        print(f"{name} (epoch {epoch}): error_rate {m['error_rate']:.4f} "
              f"(S {m['sub_rate']:.4f} / I {m['ins_rate']:.4f} / D {m['del_rate']:.4f})"
              f"{wer} loss {m['loss']:.4f} [{m['num_utts']} utts]")
    return results


if __name__ == "__main__":
    main()
