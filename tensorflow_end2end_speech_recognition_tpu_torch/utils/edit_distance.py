"""Edit distance with substitution / insertion / deletion counts.

Counterpart of ``utils/edit_distance.py`` and of the Python fallback of
``levenshtein_batch`` in ``data/native.py`` of
``tensorflow_end2end_speech_recognition_tpu``, written in Python and numpy
(the card machine has no ``Levenshtein`` package): the fallback of the
port's ``data/native.levenshtein_batch``, which runs the C++ runtime where
it builds. The backtrace breaks ties as the reference does (diagonal, then
deletion, then insertion), so the S/I/D split matches it.
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
