"""Epoch-level plateau learning-rate controller.

A copy of ``tensorflow_end2end_speech_recognition_tpu/train/lr_controller.py``
(the reference's ``Controller(lr_init, decay_start_epoch, decay_rate,
decay_patient_epoch)``): decays the LR when the epoch's dev metric stops
improving. Host-side state; the LR reaches the train step as a Python float.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LRController:
    learning_rate_init: float
    decay_start_epoch: int = 1
    decay_rate: float = 0.9
    decay_patient_epoch: int = 1
    lower_better: bool = True

    _best: float = field(default=float("inf"), init=False)
    _not_improved: int = field(default=0, init=False)
    lr: float = field(init=False)

    def __post_init__(self):
        self.lr = self.learning_rate_init
        if not self.lower_better:
            self._best = -float("inf")

    def state_dict(self) -> dict:
        """Resume state (checkpointed alongside optimizer slots)."""
        return {"lr": self.lr, "best": self._best, "not_improved": self._not_improved}

    def load_state_dict(self, d: dict):
        self.lr = float(d["lr"])
        self._best = float(d["best"])
        self._not_improved = int(d["not_improved"])

    def update(self, epoch: int, metric: float) -> float:
        """Report the epoch's dev metric; returns the LR for the next epoch."""
        improved = metric < self._best if self.lower_better else metric > self._best
        if improved:
            self._best = metric
            self._not_improved = 0
        else:
            self._not_improved += 1
        if epoch >= self.decay_start_epoch and self._not_improved > self.decay_patient_epoch:
            self.lr *= self.decay_rate
            self._not_improved = 0
        return self.lr
