"""Train an RNN-LM on a corpus's transcripts for shallow fusion.

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.train_lm \\
        configs/ls960_joint.yml /tmp/lm_dir [--epochs N] [--device cuda]

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/train_lm.py``:
the acoustic config gives the corpus and its units, so the LM's vocabulary
(units + sos + eos) is the attention task's and the LM drops into
``bin/eval --lm-dir`` and ``bin/decode --lm-dir``. Adam with a global-norm
clip of 5.0; the dev perplexity of each epoch decides which checkpoints
(``torch.save``, ``train/checkpoint.py``) are kept; ``lm_config.json``
holds the LM's shape. ``load_lm`` reads such a dir. Runs on the card
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .. import set_full_fp32
from ..data.dataset import to_device
from ..models.lm import LMConfig, RNNLM
from ..train.checkpoint import CheckpointManager, tree_to
from ..train.lm_task import LMTaskConfig, init_params, make_eval_step, make_train_step
from ..train.loop import build_corpus_splits
from ..train.optimizer import build_optimizer
from ..utils.config import ExperimentConfig
from .eval import open_device


def _batches(utts, batch_size: int, u_pad: int, seed: int):
    """Shuffled label batches; a short batch is filled modulo the utterances,
    with weight 0 on the fill rows (they count in neither loss nor perplexity)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(utts))
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        n_real = len(idx)
        fill = [order[(j - n_real) % len(order)] for j in range(n_real, batch_size)]
        idx = np.concatenate([idx, np.asarray(fill, order.dtype)]) if fill else idx
        labels = np.full((batch_size, u_pad), -1, np.int32)
        label_len = np.zeros((batch_size,), np.int32)
        weight = np.zeros((batch_size,), np.float32)
        weight[:n_real] = 1.0
        for j, i in enumerate(idx):
            ids = utts[i].label_ids[:u_pad]
            labels[j, : len(ids)] = ids
            label_len[j] = len(ids)
        yield {"labels": labels, "label_len": label_len, "weight": weight}


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="acoustic experiment YAML (provides corpus + units)")
    ap.add_argument("lm_dir")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--num-units", type=int, default=256)
    ap.add_argument("--embedding-dim", type=int, default=128)
    ap.add_argument("--num-layers", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.epochs < 1:
        raise SystemExit("--epochs must be >= 1")
    set_full_fp32()
    device = open_device(args.device)

    exp = ExperimentConfig.from_yaml(args.config)
    # token ids only: a data_root corpus's acoustic features are not read
    train_utts, dev_utts, _, tokenizer = build_corpus_splits(exp, need=("train", "dev"),
                                                             load_features=False)
    cfg = LMConfig(vocab=tokenizer.num_units + 2, num_units=args.num_units,
                   embedding_dim=args.embedding_dim, num_layers=args.num_layers)
    task = LMTaskConfig(model=cfg)
    params = tree_to(init_params(task, torch.Generator().manual_seed(exp.seed)), device)
    opt = build_optimizer("adam", clip_grad_norm=5.0)
    opt_state = opt.init(params)
    train_step, eval_step = make_train_step(task, opt), make_eval_step(task)

    lm_dir = Path(args.lm_dir)
    lm_dir.mkdir(parents=True, exist_ok=True)
    (lm_dir / "lm_config.json").write_text(json.dumps(cfg._asdict()))
    ckpts = CheckpointManager(lm_dir / "checkpoints")
    u_pad = max(len(u.label_ids) for u in train_utts) + 1
    for epoch in range(args.epochs):
        for batch in _batches(train_utts, args.batch_size, u_pad, exp.seed + epoch):
            params, opt_state, aux = train_step(params, opt_state, to_device(batch, device),
                                                args.learning_rate)
        nll = tok = 0.0
        for batch in _batches(dev_utts, args.batch_size, u_pad, 0):
            n, t = eval_step(params, to_device(batch, device))
            nll += float(n)
            tok += float(t)
        ppl = float(np.exp(nll / max(tok, 1)))
        print(f"epoch {epoch}: train_loss {float(aux['loss']):.4f} dev_ppl {ppl:.2f}")
        ckpts.save(epoch, {"params": params}, ppl)
    print("FINAL dev_ppl", ppl)
    return ppl


def load_lm(lm_dir, device) -> RNNLM:
    """The best-perplexity ``RNNLM`` of a ``train_lm`` dir, on ``device`` (the
    callers' ``--device``: the card unless they ask for the CPU)."""
    lm_dir = Path(lm_dir)
    cfg = LMConfig(**json.loads((lm_dir / "lm_config.json").read_text()))
    _, state = CheckpointManager(lm_dir / "checkpoints").restore({"params": None})
    lm = RNNLM(cfg)
    lm.load_state_dict(state["params"])
    return lm.to(device).eval()


if __name__ == "__main__":
    main()
