"""Corpus-level error rates of a model's eval step on a dataset.

Counterpart of ``eval_counts`` / ``rates_from_counts`` / ``evaluate_ctc`` in
``tensorflow_end2end_speech_recognition_tpu/utils/metrics.py``, in one
process or over data-parallel ranks: run the eval step batch by batch, map
ids to the scoring units (TIMIT phones folded to 39; BPE units detokenized
to words; word units as they are; otherwise the characters of the joined
string, kana included),
and accumulate edit counts (the C++ runtime's ``levenshtein_batch``,
``data/native.py``); character models also count words. Only the
decoded ids, their lengths and the per-row loss leave the device, once per
batch.
"""

from __future__ import annotations

import functools

import numpy as np

from ..data.dataset import to_device
from ..data.tokenizers import PhoneTokenizer, Tokenizer
from ..data.native import levenshtein_batch
from .edit_distance import compute_per


def ids_to_tokens(ids, tokenizer: Tokenizer) -> list:
    """Label ids -> the tokenizer's units."""
    return tokenizer.decode([int(i) for i in ids])


def scoring_tokens(ref_ids, hyp_ids, tokenizer: Tokenizer, label_type: str):
    """Scoring-unit token sequences and the reference-length denominator."""
    ref = ids_to_tokens(ref_ids, tokenizer)
    hyp = ids_to_tokens(hyp_ids, tokenizer)
    if label_type.startswith("phone") and isinstance(tokenizer, PhoneTokenizer):
        ref = tokenizer.fold_for_scoring(ref)
        hyp = tokenizer.fold_for_scoring(hyp)
    elif label_type.startswith("bpe"):  # WER over the detokenized words
        detok = lambda seq: "".join(seq).replace("▁", " ").split()  # noqa: E731
        ref, hyp = detok(ref), detok(hyp)
    elif not label_type.startswith("word"):
        ref = list("".join(ref))
        hyp = list("".join(hyp))
    return ref, hyp, max(len(ref), 1)


def score_pair(ref_ids, hyp_ids, tokenizer: Tokenizer, label_type: str):
    """(edit distance numerator, reference-length denominator) of one pair."""
    ref, hyp, denom = scoring_tokens(ref_ids, hyp_ids, tokenizer, label_type)
    return compute_per(ref, hyp, normalize=False), denom


def word_tokens(ref_ids, hyp_ids, tokenizer: Tokenizer, label_type: str):
    """Word sequences of a character model (its WER readout), else None: phone
    models have no words, BPE and word models score words already."""
    if label_type not in ("character", "character_capital_divide"):
        return None
    join = getattr(tokenizer, "decode_text", None)
    if join is None:
        return None
    return join(ref_ids).split(), join(hyp_ids).split()


def _integerize(ref, hyp):
    vocab = {}
    enc = lambda seq: [vocab.setdefault(t, len(vocab)) for t in seq]  # noqa: E731
    return enc(ref), enc(hyp)


def eval_counts(eval_step, params, dataset, tokenizer: Tokenizer, label_type: str,
                epoch: int = 0, device="cuda", row_slice=None) -> np.ndarray:
    """Corpus count vector ``[edit, sub, ins, del, ref_len, num_utts, loss_sum,
    w_edit, w_sub, w_ins, w_del, w_ref_len]`` (float64), as the JAX one;
    ``row_slice`` (a host batch -> its rows to score here) keeps each rank
    to its own rows."""
    total = np.zeros(12, np.float64)
    for batch in dataset.batches(epoch):
        if row_slice is not None:
            batch = row_slice(batch)
        decoded, dec_len, nll = eval_step(params, to_device(batch, device))
        decoded, dec_len, nll = (x.cpu().numpy() for x in (decoded, dec_len, nll))
        refs, hyps, wrefs, whyps = [], [], [], []
        for i, name in enumerate(batch["names"]):
            if name is None:  # batch filler
                continue
            ref_ids = [j for j in batch["labels"][i] if j >= 0]
            hyp_ids = decoded[i][: dec_len[i]]
            r, h, n = scoring_tokens(ref_ids, hyp_ids, tokenizer, label_type)
            r, h = _integerize(r, h)
            refs.append(r)
            hyps.append(h)
            w = word_tokens(ref_ids, hyp_ids, tokenizer, label_type)
            if w is not None:
                wr, wh = _integerize(*w)
                wrefs.append(wr)
                whyps.append(wh)
            total[4] += n
            total[5] += 1
            total[6] += float(nll[i])
        if refs:
            total[0:4] += levenshtein_batch(refs, hyps)[:, 0:4].sum(axis=0)
        if wrefs:
            total[7:11] += levenshtein_batch(wrefs, whyps)[:, 0:4].sum(axis=0)
            total[11] += sum(max(len(r), 1) for r in wrefs)
    return total


def rates_from_counts(counts: np.ndarray) -> dict:
    """Count vector (``eval_counts``) -> the reported rate dict."""
    (edit, sub, ins, dele, ref_len, n_utts, loss_sum,
     w_edit, _w_sub, _w_ins, _w_del, w_ref_len) = (float(c) for c in counts)
    total_len = max(ref_len, 1.0)
    out = {
        "error_rate": edit / total_len,
        "loss": loss_sum / n_utts if n_utts else float("nan"),
        "sub_rate": sub / total_len,
        "ins_rate": ins / total_len,
        "del_rate": dele / total_len,
        "num_utts": int(n_utts),
    }
    if w_ref_len > 0:
        out["wer"] = w_edit / w_ref_len
    return out


def evaluate_ctc(eval_step, params, dataset, tokenizer: Tokenizer, label_type: str,
                 epoch: int = 0, device="cuda", mesh=None) -> dict:
    """Decode a dataset with ``eval_step`` on ``device``; error rate, loss, S/I/D rates.

    With a ``mesh`` of several ranks (``parallel/mesh.py``; ``params`` whole
    on every rank, ``multihost.local_replica``) each rank decodes only its
    own rows of every batch (``multihost.process_slice``; fill rows, whose
    name is None, count on no rank) and the count vectors are summed over
    the ranks (``allreduce_counts``): the rates equal one process scoring
    the whole set."""
    row_slice = None
    if mesh is not None and mesh.size > 1:
        from ..parallel.multihost import process_slice

        row_slice = functools.partial(process_slice, process_index=mesh.rank,
                                      process_count=mesh.size)
    counts = eval_counts(eval_step, params, dataset, tokenizer, label_type, epoch, device,
                         row_slice)
    if mesh is not None:
        from ..parallel.multihost import allreduce_counts

        counts = allreduce_counts(counts, mesh)
    return rates_from_counts(counts)
