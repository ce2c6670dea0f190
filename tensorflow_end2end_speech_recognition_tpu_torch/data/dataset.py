"""Bucketed, length-sorted batching over utterances (host side of the pipeline).

A copy of ``tensorflow_end2end_speech_recognition_tpu/data/dataset.py``:
length-sorted batches for the first ``sort_stop_epoch`` epochs, block-shuffled
after; time padded to a quantile ladder of bucket bounds and labels to a
ladder of their own (``-1`` padded); a short final batch filled with earlier
utterances whose rows carry ``weight`` 0 and name ``None``. Utterances with
multitask sub labels give ``labels_sub`` / ``label_len_sub`` too, ``-1``
padded to a ladder of their own (at least 8 wide). The same seed and epoch
give the same batches as the JAX ``Dataset``. Batches are padded by the C++
runtime's ``batch_assemble`` (``data/native.py``; its numpy fallback where
no compiler is found).

Utterances carry waveforms (``[N]`` samples) or precomputed feature
matrices (``[T, D]``, the ``.npy`` corpora of ``data/npy_corpus.py``);
``input_kind="auto"`` tells them apart by rank. In features mode lengths
count frames and the time ladder rounds to 16 frames, not 512 samples.
With ``cmvn_stats`` (``frontend/speaker_cmvn.compute_speaker_stats``) each
batch also carries every row's speaker ``cmvn_mean`` / ``cmvn_inv_std``,
fill rows included. ``max_frames_per_batch`` halves a long batch's rows,
rounded down to a multiple of ``min_batch_rows`` (the gradient
accumulation's microbatch count), until its padded frames fit.
"""

from __future__ import annotations

import numpy as np
import torch

from .native import batch_assemble
from .toy_corpus import Utterance

NUM_WAV_BUCKETS, NUM_LABEL_BUCKETS = 4, 3


def bucket_ladder(lengths, num_buckets: int = 4, multiple: int = 512):
    """Quantile-based ladder of padded lengths, rounded up to ``multiple``."""
    lengths = np.asarray(lengths)
    qs = np.quantile(lengths, np.linspace(1.0 / num_buckets, 1.0, num_buckets))
    ladder = sorted({int(-(-q // multiple) * multiple) for q in qs})
    if ladder[-1] < lengths.max():
        ladder[-1] = int(-(-int(lengths.max()) // multiple) * multiple)
    return ladder


def pad_to_ladder(n: int, ladder) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (the ``names`` stay on the host)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items() if k != "names"}


class Dataset:
    """Iterator factory over utterance batches (see the module docstring)."""

    def __init__(
        self,
        utterances: list[Utterance],
        batch_size: int,
        sort_utt: bool = True,
        sort_stop_epoch: int | None = None,
        seed: int = 0,
        input_kind: str = "auto",  # "wav" | "features" | "auto" (by rank)
        cmvn_stats: dict | None = None,  # speaker -> (mean, inv_std): batches carry rows
        max_frames_per_batch: int | None = None,  # padded frames x rows budget
        min_batch_rows: int = 1,  # the halving's floor and multiple
        samples_per_frame: int = 1,  # wav mode: samples per frame (the budget counts frames)
    ):
        if not utterances:
            raise ValueError("empty dataset")
        self.utterances = list(utterances)
        self.cmvn_stats = cmvn_stats
        self.batch_size = batch_size
        self.max_frames_per_batch = max_frames_per_batch
        self.min_batch_rows = max(1, min_batch_rows)
        self.samples_per_frame = max(1, samples_per_frame)
        self.sort_utt = sort_utt
        self.sort_stop_epoch = sort_stop_epoch if sort_stop_epoch is not None else (1 << 30)
        self.seed = seed
        if input_kind == "auto":
            input_kind = "wav" if utterances[0].wav.ndim == 1 else "features"
        self.input_kind = input_kind
        lens = [u.wav.shape[0] for u in self.utterances]  # samples, or frames
        self._input_lens = np.asarray(lens)
        self.wav_ladder = bucket_ladder(lens, NUM_WAV_BUCKETS,
                                        multiple=512 if input_kind == "wav" else 16)
        label_lens = [len(u.label_ids) for u in self.utterances]
        self.label_ladder = bucket_ladder(label_lens, NUM_LABEL_BUCKETS, multiple=8)
        sub_lens = [len(u.sub_ids) for u in self.utterances if u.sub_ids is not None]
        self.sub_label_ladder = (bucket_ladder(sub_lens, NUM_LABEL_BUCKETS, multiple=8)
                                 if sub_lens else None)
        if max_frames_per_batch is None:
            self.num_batches = -(-len(self.utterances) // batch_size)
        else:
            order = np.argsort(self._input_lens, kind="stable")
            self.num_batches = len(self._batch_extents(order))

    def __len__(self):
        return len(self.utterances)

    def batches(self, epoch: int = 0):
        """Yield batch dicts for one epoch (length-sorted, then block-shuffled)."""
        order = np.argsort(self._input_lens, kind="stable")
        rng = np.random.RandomState(self.seed + epoch)
        if not self.sort_utt or epoch >= self.sort_stop_epoch:
            # after the curriculum, shuffle inside blocks of a few batches of
            # the sorted order: batch membership changes, lengths stay close
            block = max(self.batch_size * 4, 1)
            for s in range(0, len(order), block):
                rng.shuffle(order[s : s + block])
            shuffle_batches = True
        else:
            shuffle_batches = False
        extents = self._batch_extents(order)
        if shuffle_batches:
            rng.shuffle(extents)
        for start, rows in extents:
            yield self._make_batch(order[start : start + rows], rows)

    def _batch_extents(self, order):
        """``(start, rows)`` slices of the epoch order; long batches halve their
        rows, rounded down to a multiple of ``min_batch_rows`` (and not below
        it), until ``max_frames_per_batch`` fits."""
        extents = []
        i, n = 0, len(order)
        while i < n:
            rows = self.batch_size
            if self.max_frames_per_batch is not None:
                while True:
                    idx = order[i : i + rows]
                    t_pad = pad_to_ladder(int(self._input_lens[idx].max()), self.wav_ladder)
                    frames = -(-t_pad // self.samples_per_frame)
                    if frames * rows <= self.max_frames_per_batch or rows <= self.min_batch_rows:
                        break
                    # every row count stays a multiple of min_batch_rows: batch_size
                    # // min_batch_rows need not be a power of two (24 rows at 8: 12
                    # would not divide into 8 microbatches)
                    m = self.min_batch_rows
                    rows = max(m, (rows // 2) // m * m)
            extents.append((i, rows))
            i += rows
        return extents

    def _make_batch(self, idx, rows: int | None = None):
        utts = [self.utterances[i] for i in idx]
        b = rows if rows is not None else self.batch_size
        t_pad = pad_to_ladder(max(self._input_lens[i] for i in idx), self.wav_ladder)
        u_pad = pad_to_ladder(max(len(u.label_ids) for u in utts), self.label_ladder)
        # short final batch: repeat earlier utterances (weight 0, name None)
        fill = [utts[(j - len(utts)) % len(utts)] for j in range(len(utts), b)]
        all_utts = utts + fill
        inputs, input_len = batch_assemble([u.wav for u in all_utts], t_pad)
        labels = np.full((b, u_pad), -1, dtype=np.int32)
        label_len = np.zeros((b,), dtype=np.int32)
        has_sub = all_utts[0].sub_ids is not None
        if has_sub:
            su_pad = max(8, pad_to_ladder(max(len(u.sub_ids) for u in all_utts),
                                          self.sub_label_ladder))
            labels_sub = np.full((b, su_pad), -1, dtype=np.int32)
            label_len_sub = np.zeros((b,), dtype=np.int32)
        names = []
        for j, u in enumerate(all_utts):
            labels[j, : len(u.label_ids)] = u.label_ids
            label_len[j] = len(u.label_ids)
            if has_sub:
                labels_sub[j, : len(u.sub_ids)] = u.sub_ids
                label_len_sub[j] = len(u.sub_ids)
            names.append(u.name if j < len(utts) else None)
        weight = np.zeros((b,), dtype=np.float32)
        weight[: len(utts)] = 1.0
        batch = {
            "inputs": inputs,
            "labels": labels,
            "input_len": input_len,
            "label_len": label_len,
            "weight": weight,
            "names": names,
        }
        if has_sub:
            batch["labels_sub"] = labels_sub
            batch["label_len_sub"] = label_len_sub
        if self.cmvn_stats is not None:
            from ..frontend.speaker_cmvn import batch_cmvn_rows

            batch["cmvn_mean"], batch["cmvn_inv_std"] = batch_cmvn_rows(self.cmvn_stats,
                                                                        all_utts)
        return batch
