"""The one traffic generator: training batches and serving requests from a
mix's parameters (``portbench/traffic/<name>.json``) and ``--seed``.

Every seed gets the same set of sizes and arrivals, in another order: the
batch lengths, the rows' lengths within a batch, the request lengths and
the gaps between arrivals are fixed quantiles of the mix's distributions,
and the seed only permutes them and draws the content (waveform samples,
label ids, where each request's audio starts in the pool). So the work of a
run does not move with the seed.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

SAMPLE_RATE = 16000


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed (seeds may exceed 32 bits)."""
    return np.random.Generator(np.random.PCG64([stream, seed & (2**64 - 1)]))


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, one per use of the run's seed."""
    return int(rng(seed, stream).integers(0, 2**63 - 1))


def batch_shapes(mix: dict) -> list:
    """The mix's fixed set of batches: each a list of row lengths in samples,
    the longest first. Base lengths lie evenly over ``base_seconds``; a
    batch's rows lie evenly within ``row_spread_seconds`` below its base, as
    length-sorted bucketing gives."""
    lo, hi = mix["base_seconds"]
    n, rows, spread = mix["distinct_batches"], mix["rows"], mix["row_spread_seconds"]
    out = []
    for i in range(n):
        base = lo + (i + 0.5) * (hi - lo) / n
        out.append([int(round((base - k * spread / rows) * SAMPLE_RATE)) for k in range(rows)])
    return out


def labels_for(samples: int, per_second: float) -> int:
    return max(1, int(round(per_second * samples / SAMPLE_RATE)))


def train_batches(mix: dict, num_classes: int, labels_per_second: float, seed: int,
                  device) -> list:
    """The mix's batches in the seed's order, each a dict of pinned host
    tensors in the layout of the port's loader: ``inputs`` [B, N] float32
    (0.1 x normal noise, zero past each row's length, N the batch's
    longest), ``input_len`` int32, ``labels`` [B, U] int32 (-1 padded),
    ``label_len`` int32, ``weight`` float32 ones. Rows are in the seed's
    order inside each batch; a row of s seconds has ``round(labels_per_second
    · s)`` labels (the configuration's speaking rate in its units). The
    waveforms are drawn on ``device`` in one call and copied to pinned host
    memory, as a loader with ``pin_memory`` holds them."""
    order = rng(seed, 1)
    shapes = batch_shapes(mix)
    shapes = [shapes[i] for i in order.permutation(len(shapes))]
    shapes = [[rows[i] for i in order.permutation(len(rows))] for rows in shapes]
    total = sum(max(rows) * len(rows) for rows in shapes)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    noise = torch.randn(total, generator=gen, device=device) * 0.1
    label_rng = rng(seed, 3)
    pin = device.type == "cuda"
    out, at = [], 0
    for rows in shapes:
        b, n = len(rows), max(rows)
        wav = noise[at:at + b * n].view(b, n)
        at += b * n
        lens = torch.tensor(rows, dtype=torch.int32, device=device)
        wav = wav * (torch.arange(n, device=device)[None, :] < lens[:, None])
        ulen = np.asarray([labels_for(r, labels_per_second) for r in rows], np.int32)
        labels = np.full((b, int(ulen.max())), -1, np.int32)
        for i, u in enumerate(ulen):
            labels[i, :u] = label_rng.integers(0, num_classes, u)
        batch = {"inputs": wav.cpu(), "input_len": lens.cpu(),
                 "labels": torch.from_numpy(labels), "label_len": torch.from_numpy(ulen),
                 "weight": torch.ones(b, dtype=torch.float32)}
        out.append({k: v.pin_memory() if pin else v for k, v in batch.items()})
    return out


def batch_audio_seconds(batch: dict) -> float:
    return float(batch["input_len"].sum()) / SAMPLE_RATE


def arrival_gaps(rate: float, n: int) -> np.ndarray:
    """The ``n`` quantiles of an exponential gap at ``rate``: a Poisson
    process's gaps, the same set for every seed."""
    return np.asarray([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])


class Requests:
    """A serving mix's requests for a window of ``seconds``: due times (s from
    the window's start), lengths in samples and where each one's audio
    starts in a pool of noise, all from the seed."""

    def __init__(self, mix: dict, seed: int, seconds: float):
        rate = float(mix["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        q = [(i + 0.5) / n for i in range(n)]
        gaps = arrival_gaps(rate, n)
        lm = mix["lengths"]
        normal = statistics.NormalDist(math.log(lm["median_seconds"]), lm["sigma"])
        secs = np.clip(np.exp([normal.inv_cdf(p) for p in q]),
                       lm["min_seconds"], lm["max_seconds"])
        order = rng(seed, 4)
        gaps = gaps[order.permutation(n)]
        self.due = np.concatenate([[0.0], np.cumsum(gaps[1:])])  # the first is due at once
        self.samples = np.round(secs[order.permutation(n)] * SAMPLE_RATE).astype(np.int64)
        pool_n = int(mix["audio_pool_seconds"] * SAMPLE_RATE)
        self.pool = (rng(seed, 5).standard_normal(pool_n) * 0.1).astype(np.float32)
        self.offset = order.integers(0, pool_n - self.samples + 1)
        self.row_samples = int(mix["row_seconds"] * SAMPLE_RATE)

    def __len__(self) -> int:
        return len(self.due)

    def row(self, i: int) -> np.ndarray:
        """Request ``i``'s audio as the server's row: zero past its length."""
        out = np.zeros(self.row_samples, np.float32)
        n, at = int(self.samples[i]), int(self.offset[i])
        out[:n] = self.pool[at:at + n]
        return out

    def sample(self, seed: int, count: int, done) -> list:
        """Up to ``count`` of the finished requests ``done``, drawn from the
        seed, the longest finished one always among them."""
        done = sorted(done)
        if not done:
            return []
        longest = max(done, key=lambda i: (self.samples[i], -i))
        rest = [i for i in done if i != longest]
        pick = rng(seed, 6).permutation(len(rest))[:max(0, count - 1)]
        return [longest] + sorted(rest[i] for i in pick)
