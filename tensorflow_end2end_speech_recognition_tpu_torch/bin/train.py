"""Training entry point of the port.

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.train \\
        configs/ls100_ctc.yml /tmp/model_dir [--epochs N] [--device cuda] [--profile]

The CTC (``ls100_ctc``, ``timit_ctc_blstm``), attention and joint
CTC-attention (``timit_attention``, ``ls960_joint``) and transducer
(``ls_transducer``) configs train.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/train.py``:
reads a reference-shaped YAML config, trains with ``train/loop.fit`` on the
card (``--device cpu`` for the CPU), and tees its output to
``<model_dir>/train.log``. ``--profile`` writes a ``torch.profiler`` Chrome
trace of steps 2-5 under ``<model_dir>/trace``.

Across ranks (a config with ``num_devices: N``; ``num_model_shards``,
``num_sequence_shards`` or ``num_expert_shards`` for a conformer /
transformer / MoE encoder's tensor, sequence or expert shards,
``num_pipeline_stages`` for its GPipe stages, and ``fsdp: true`` for
ZeRO-3), launch one process per rank with ``torchrun``:

    torchrun --nproc-per-node N -m tensorflow_end2end_speech_recognition_tpu_torch.bin.train \
        CONFIG MODEL_DIR            # one card per rank, nccl
    torchrun --nproc-per-node N -m ... CONFIG MODEL_DIR --device cpu   # gloo on the CPU

The process group starts from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) with
``nccl`` for the card and ``gloo`` for the CPU; a backend that fails to
start is an error. Rank 0 alone prints and writes the model dir.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from .. import set_full_fp32
from ..train.loop import fit
from ..utils.config import ExperimentConfig


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for f in self.streams:
            f.write(s)

    def flush(self):
        for f in self.streams:
            f.flush()


def init_ranks(device: str) -> bool:
    """Start the default process group from ``torchrun``'s environment when
    it runs more than one rank (``nccl`` for a card, ``gloo`` for the CPU);
    whether one was started."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="YAML experiment config (reference key names accepted)")
    ap.add_argument("model_dir", help="directory for checkpoints, logs and the config copy")
    ap.add_argument("--epochs", type=int, default=None, help="override num_epoch")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of steps 2-5 into the model dir")
    args = ap.parse_args(argv)
    set_full_fp32()

    started = init_ranks(args.device)
    try:
        exp = ExperimentConfig.from_yaml(args.config)
        if args.epochs is not None:
            exp = dataclasses.replace(exp, num_epoch=args.epochs)
        if dist.is_initialized() and dist.get_rank() > 0:  # rank 0 prints and logs
            return fit(exp, args.model_dir, device=args.device, print_fn=lambda *a: None,
                       profile_steps=(2, 5) if args.profile else None)
        Path(args.model_dir).mkdir(parents=True, exist_ok=True)
        orig = sys.stdout
        with open(Path(args.model_dir) / "train.log", "a") as log_f:
            sys.stdout = _Tee(orig, log_f)  # the run's output also lands in train.log
            try:
                summary = fit(exp, args.model_dir, device=args.device,
                              profile_steps=(2, 5) if args.profile else None)
                print("FINAL", summary)
            finally:
                sys.stdout = orig
        return summary
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
