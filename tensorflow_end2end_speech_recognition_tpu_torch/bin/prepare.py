"""Offline corpus preparation: wav files -> per-utterance ``.npy`` features.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/prepare.py``:
it writes the on-disk layout that ``data_root:`` configs read
(``data/npy_corpus.py``), with the port's frontend (``extract_features``)
on ``--device`` (the card unless ``--device cpu``), so offline and online
features are the same.

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.prepare \\
        <out_root> <split> --wav-scp scp.tsv \\
        [--feature fbank] [--input-size 40] [--no-delta] [--no-energy] \\
        [--cmvn utterance|speaker|none] [--batch 16] [--device cuda]

``scp.tsv`` lines: ``utt_id<TAB>wav_path<TAB>text`` or
``utt_id<TAB>wav_path<TAB>speaker<TAB>text``. Wavs must be 16-bit PCM at the
frontend sample rate (several channels are mixed down). ``--input-size``
sets the mel bands, for MFCC too (13 cepstra kept). Output:

    <out_root>/<split>/feats/<utt_id>.npy    float32 [T, D]
    <out_root>/<split>/transcripts.tsv       utt_id<TAB>[speaker<TAB>]text

Only one batch of waveforms is in memory at a time. Per-utterance CMVN and
``none`` write the final features at once; per-speaker CMVN writes the raw
features while summing each speaker's frames, then normalizes every file
in a second pass.
"""

from __future__ import annotations

import argparse
import wave
from pathlib import Path

import numpy as np
import torch

from .. import set_full_fp32
from ..frontend.features import FrontendConfig, extract_features
from .eval import open_device


def read_wav(path: str | Path, expect_rate: int) -> np.ndarray:
    """16-bit PCM wav (several channels mixed down) -> float32 in [-1, 1]."""
    with wave.open(str(path), "rb") as w:
        if w.getframerate() != expect_rate:
            raise ValueError(
                f"{path}: sample rate {w.getframerate()} != frontend rate "
                f"{expect_rate} (resampling is out of scope; re-record or "
                f"resample offline)"
            )
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM supported")
        raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(axis=1).astype(np.int16)
    return raw.astype(np.float32) / 32768.0


def parse_scp(path: str | Path):
    """[(utt_id, wav_path, speaker|None, text)] from a scp tsv."""
    rows = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        cols = line.split("\t")
        if len(cols) == 3:
            rows.append((cols[0], cols[1], None, cols[2]))
        elif len(cols) >= 4:
            rows.append((cols[0], cols[1], cols[2], "\t".join(cols[3:])))
        else:
            raise ValueError(f"bad scp line (need >=3 tab columns): {line!r}")
    return rows


def extract_group(wavs: list[np.ndarray], fe, device) -> list[np.ndarray]:
    """Raw frontend features (no CMVN) of one batch of waveforms, each batch
    padded to a whole second."""
    lens = np.asarray([len(w) for w in wavs], np.int32)
    pad_to = max(fe.frame_length, -(-int(lens.max()) // fe.sample_rate) * fe.sample_rate)
    mat = np.zeros((len(wavs), pad_to), np.float32)
    for i, w in enumerate(wavs):
        mat[i, : len(w)] = w
    with torch.no_grad():
        feats, flen = extract_features(torch.from_numpy(mat).to(device),
                                       torch.from_numpy(lens).to(device), fe)
    feats, flen = feats.cpu().numpy(), flen.cpu().numpy()
    return [feats[i, : flen[i]].astype(np.float32) for i in range(len(wavs))]


def cmvn_utterance_np(f: np.ndarray, var_norm: bool = True) -> np.ndarray:
    mu = f.mean(axis=0, keepdims=True)
    sd = (f.std(axis=0, keepdims=True) + 1e-8) if var_norm else 1.0
    return ((f - mu) / sd).astype(np.float32)


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_root")
    ap.add_argument("split")
    ap.add_argument("--wav-scp", required=True)
    ap.add_argument("--feature", choices=("fbank", "mfcc"), default="fbank")
    ap.add_argument("--input-size", type=int, default=40)
    ap.add_argument("--no-delta", action="store_true")
    ap.add_argument("--no-energy", action="store_true")
    ap.add_argument("--cmvn", choices=("utterance", "speaker", "none"), default="utterance")
    ap.add_argument("--sample-rate", type=int, default=16000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    set_full_fp32()
    device = open_device(args.device)
    fe = FrontendConfig(
        feature_type=args.feature,
        num_mels=args.input_size,
        use_energy=not args.no_energy,
        add_deltas=not args.no_delta,
        sample_rate=args.sample_rate,
        cmvn="none",  # CMVN is applied offline below (reference semantics)
    )
    rows = parse_scp(args.wav_scp)
    if args.cmvn == "speaker" and any(s is None for _, _, s, _ in rows):
        raise ValueError("--cmvn speaker needs 4-column scp lines with speaker ids")

    out = Path(args.out_root) / args.split
    (out / "feats").mkdir(parents=True, exist_ok=True)
    spk_stats: dict = {}
    dim = 0
    for lo in range(0, len(rows), args.batch):
        group = rows[lo : lo + args.batch]
        wavs = [read_wav(p, args.sample_rate) for _, p, _, _ in group]
        for (utt, _, spk, _), f in zip(group, extract_group(wavs, fe, device)):
            if args.cmvn == "utterance":
                f = cmvn_utterance_np(f)
            elif args.cmvn == "speaker":
                n, su, sq = spk_stats.get(spk, (0, 0.0, 0.0))
                spk_stats[spk] = (n + len(f), su + f.sum(axis=0), sq + (f**2).sum(axis=0))
            np.save(out / "feats" / f"{utt}.npy", f)
            dim = f.shape[1]

    if args.cmvn == "speaker":
        norms = {}
        for s, (n, su, sq) in spk_stats.items():
            mu = su / n
            sd = np.sqrt(np.maximum(sq / n - mu**2, 0.0)) + 1e-8
            norms[s] = (mu, sd)
        for utt, _, spk, _ in rows:
            path = out / "feats" / f"{utt}.npy"
            mu, sd = norms[spk]
            np.save(path, ((np.load(path) - mu) / sd).astype(np.float32))

    lines = [f"{utt}\t{spk}\t{text}" if spk else f"{utt}\t{text}"
             for utt, _, spk, text in rows]
    (out / "transcripts.tsv").write_text("\n".join(lines) + "\n")
    print(f"prepared {len(rows)} utterances -> {out} (feature dim {dim}, "
          f"cmvn {args.cmvn})")
    return out


if __name__ == "__main__":
    main()
