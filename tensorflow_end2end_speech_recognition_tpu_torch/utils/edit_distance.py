"""Edit distance with substitution / insertion / deletion counts, and PER /
CER / WER.

Counterpart of ``utils/edit_distance.py`` and of the Python fallback of
``levenshtein_batch`` in ``data/native.py`` of
``tensorflow_end2end_speech_recognition_tpu``, written in Python and numpy
(the card machine has no ``Levenshtein`` package). ``levenshtein`` is the
fallback of the port's ``data/native.levenshtein_batch``, which runs the
C++ runtime where it builds; its backtrace breaks ties as that runtime does
(diagonal, then deletion, then insertion). ``compute_cer``,
``compute_wer`` and ``compute_per`` are the JAX package's rates on its
distance; ``wer_align`` counts S/I/D as ``Levenshtein.editops`` does, ties
included: the common prefix and suffix stripped, then a backtrace from the
end that deletes while the column above is one less, else steps up a row
and inserts while the cell to its left there is one more, else takes the
diagonal (rapidfuzz's ``recover_alignment`` read on the full matrix).
"""

from __future__ import annotations

import numpy as np


def levenshtein(ref, hyp) -> tuple[int, int, int, int]:
    """``(distance, subs, ins, dels)`` between two token sequences."""
    n, m = len(ref), len(hyp)
    dp = np.zeros((n + 1, m + 1), np.int64)
    dp[0, :] = np.arange(m + 1)
    dp[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i, j] = min(dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                           dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    i, j, subs, ins, dels = n, m, 0, 0, 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            subs += int(ref[i - 1] != hyp[j - 1])
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return int(dp[n, m]), subs, ins, dels


def levenshtein_batch(refs, hyps) -> np.ndarray:
    """Per pair ``[distance, subs, ins, dels]``, int32 ``[N, 4]``."""
    out = np.zeros((len(refs), 4), np.int32)
    for k, (r, h) in enumerate(zip(refs, hyps)):
        out[k] = levenshtein(r, h)
    return out


def _distance_matrix(ref, hyp) -> np.ndarray:
    n, m = len(ref), len(hyp)
    dp = np.zeros((n + 1, m + 1), np.int64)
    dp[0, :] = np.arange(m + 1)
    dp[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i, j] = min(dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                           dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    return dp


def compute_cer(ref: str, hyp: str, normalize: bool = True) -> float:
    """Character error rate between strings."""
    d = levenshtein(list(ref), list(hyp))[0]
    return d / max(len(ref), 1) if normalize else float(d)


def compute_wer(ref: str, hyp: str, normalize: bool = True) -> float:
    """Word error rate; words are whitespace tokens."""
    r, h = ref.split(), hyp.split()
    d = levenshtein(r, h)[0]
    return d / max(len(r), 1) if normalize else float(d)


def compute_per(ref_tokens: list, hyp_tokens: list, normalize: bool = True) -> float:
    """Phone error rate over token lists."""
    d = levenshtein(list(ref_tokens), list(hyp_tokens))[0]
    return d / max(len(ref_tokens), 1) if normalize else float(d)


def wer_align(ref: list, hyp: list) -> dict:
    """``{"sub", "ins", "del", "hits"}`` of the alignment ``Levenshtein.editops``
    picks (module docstring)."""
    ref, hyp = list(ref), list(hyp)
    n, m = len(ref), len(hyp)
    p = 0
    while p < min(n, m) and ref[p] == hyp[p]:
        p += 1
    s = 0
    while s < min(n, m) - p and ref[n - 1 - s] == hyp[m - 1 - s]:
        s += 1
    a, b = ref[p:n - s], hyp[p:m - s]
    dp = _distance_matrix(a, b)
    col, row = len(a), len(b)
    counts = {"sub": 0, "ins": 0, "del": 0}
    while row and col:
        if dp[col, row] - dp[col - 1, row] == 1:
            counts["del"] += 1
            col -= 1
            continue
        row -= 1
        if row and dp[col, row] - dp[col - 1, row] == -1:
            counts["ins"] += 1
        else:
            col -= 1
            counts["sub"] += int(a[col] != b[row])
    counts["del"] += col
    counts["ins"] += row
    counts["hits"] = len(ref) - counts["sub"] - counts["del"]
    return counts
