"""Training curves, CTC posterior spikes and attention alignment heatmaps.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/utils/plot.py``:
PNGs on the host with matplotlib's Agg backend. matplotlib is imported
inside each function, never when this module is imported, so the port runs
where it is not installed; there a plot raises ``ModuleNotFoundError``.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_training_curves(model_dir: str | Path) -> list:
    """``loss.png`` and ``ler.png`` from the model dir's ``metrics.csv`` (the
    train loss and the dev error rate per epoch); the paths written."""
    model_dir = Path(model_dir)
    with open(model_dir / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return []
    plt = _pyplot()
    epochs = [int(r["epoch"]) for r in rows]
    outs = []
    for col, fname, ylabel in (("train_loss", "loss.png", "train loss"),
                               ("dev_error_rate", "ler.png", "dev error rate")):
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(epochs, [float(r[col]) for r in rows])
        ax.set_xlabel("epoch")
        ax.set_ylabel(ylabel)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        path = model_dir / fname
        fig.savefig(path, dpi=100)
        plt.close(fig)
        outs.append(path)
    return outs


def plot_ctc_posteriors(posteriors: np.ndarray, path: str | Path, blank_id: int | None = None,
                        unit_names: list[str] | None = None, threshold: float = 0.1) -> Path:
    """The CTC 'spike' plot of ``posteriors`` [T, C]: the blank in grey and
    every class whose posterior passes ``threshold`` somewhere."""
    posteriors = np.asarray(posteriors)
    t, c = posteriors.shape
    blank = blank_id if blank_id is not None else c - 1
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(posteriors[:, blank], color="lightgray", label="blank", lw=1)
    active = [k for k in range(c) if k != blank and posteriors[:, k].max() > threshold]
    for k in active:
        name = unit_names[k] if unit_names and k < len(unit_names) else str(k)
        ax.plot(posteriors[:, k], label=name, lw=1.2)
    ax.set_xlabel("frame")
    ax.set_ylabel("posterior")
    ax.set_ylim(0, 1.02)
    if len(active) <= 12:
        ax.legend(fontsize=7, ncol=6, loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def plot_attention_weights(weights: np.ndarray, path: str | Path,
                           hyp_tokens: list[str] | None = None) -> Path:
    """Attention alignment heatmap of ``weights`` [U, T_enc] (decoder steps x
    encoder frames)."""
    weights = np.asarray(weights)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(weights, aspect="auto", origin="lower", cmap="viridis")
    ax.set_xlabel("encoder frame")
    ax.set_ylabel("decoder step")
    if hyp_tokens:
        ax.set_yticks(range(len(hyp_tokens)))
        ax.set_yticklabels(hyp_tokens, fontsize=6)
    fig.colorbar(im, ax=ax, fraction=0.03)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)
