"""Checkpoints with best-on-dev retention, written with ``torch.save``.

Counterpart of ``CheckpointManager`` in
``tensorflow_end2end_speech_recognition_tpu/train/checkpoint.py`` (orbax
there) with the same API: ``save(epoch, state, dev_error_rate)``,
``restore(state_like, epoch=None)``, ``latest_epoch``, ``best_epoch``. A
checkpoint is one file per epoch holding named items (``params`` apart from
``extra``: optimizer state, generator state, LR-controller state, counters),
so a consumer reads only what it needs and a resumed run continues exactly.
The newest checkpoint and the ``max_to_keep`` with the lowest dev error are
kept; the others are deleted after each save. Tensors are stored on the CPU.

Over data-parallel ranks (``mesh``, ``parallel/mesh.py``) every rank calls
``save`` with the same whole state (gathered from the ranks' blocks:
``parallel/fsdp.gather_whole``), rank 0 alone writes it, and a barrier
holds the ranks until the file is there; every rank restores the whole
state and re-places it (``parallel/fsdp.place``), so a
checkpoint keeps the one-device layout and resumes at any world size.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch
import torch.distributed


def tree_to(tree, device):
    """Every tensor of nested dicts moved to ``device``; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return tree


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3, mesh=None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.writes = mesh is None or mesh.is_lead
        self._index_path = self.directory / "index.json"
        self._metrics = {}  # epoch -> dev error rate
        if self._index_path.exists():
            raw = json.loads(self._index_path.read_text())
            self._metrics = {int(k): float(v) for k, v in raw.items()}

    def _path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{epoch}.pt"

    def save(self, epoch: int, state: dict, dev_error_rate: float) -> None:
        """``state`` maps item names (``params``, ``extra``) to nested dicts."""
        if self.writes:
            tmp = self._path(epoch).with_suffix(".tmp")
            torch.save(tree_to(state, "cpu"), tmp)
            os.replace(tmp, self._path(epoch))
        self._metrics[epoch] = float(dev_error_rate)
        best = sorted(self._metrics, key=lambda e: (self._metrics[e], e))[: self.max_to_keep]
        keep = set(best) | {max(self._metrics)}
        for e in sorted(set(self._metrics) - keep):
            if self.writes:
                self._path(e).unlink(missing_ok=True)
            del self._metrics[e]
        if self.writes:
            tmp = self._index_path.with_suffix(".tmp")
            tmp.write_text(json.dumps({str(k): v for k, v in sorted(self._metrics.items())}))
            os.replace(tmp, self._index_path)
        if self.mesh is not None and self.mesh.group is not None:
            torch.distributed.barrier(group=self.mesh.group)  # the file is there for every rank

    def restore(self, state_like: dict, epoch: int | None = None):
        """``(epoch, {item: value})`` of the best (or the given) epoch; only the
        items named in ``state_like`` are returned. Tensors come back on the CPU."""
        if epoch is None:
            epoch = self.best_epoch if self.best_epoch is not None else self.latest_epoch
        if epoch is None:
            raise FileNotFoundError("no checkpoint found")
        restored = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        return epoch, {k: restored[k] for k in state_like}

    @property
    def latest_epoch(self):
        return max(self._metrics) if self._metrics else None

    @property
    def best_epoch(self):
        if not self._metrics:
            return None
        return min(self._metrics, key=lambda e: (self._metrics[e], e))
