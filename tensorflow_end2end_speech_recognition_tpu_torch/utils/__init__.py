"""Configs, edit-distance rates and corpus-level scoring (the JAX package's
``utils`` names), the weight bridge and the YAML config subset.

The names load on first use: ``utils/config.py`` and ``utils/metrics.py``
import the data and model modules, which import ``utils`` submodules."""

import importlib

_NAMES = {
    "ExperimentConfig": "config",
    "compute_cer": "edit_distance",
    "compute_per": "edit_distance",
    "compute_wer": "edit_distance",
    "evaluate_ctc": "metrics",
    "score_pair": "metrics",
    "wer_align": "edit_distance",
}

__all__ = sorted(_NAMES)


def __getattr__(name: str):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
