"""The port's ``utils`` helpers (``compute_cer``, ``compute_wer``,
``compute_per``, ``wer_align``, ``ids_to_tokens``, ``score_pair``) against
the JAX package's, which run on the ``Levenshtein`` package, on seeded
random strings, word sequences and token lists over small alphabets, so
that many pairs have several optimal alignments: ``wer_align``'s S/I/D
split must be the one ``Levenshtein.editops`` picks on ties too. Pure
Python, no spawn.
"""

import numpy as np
import pytest

from tensorflow_end2end_speech_recognition_tpu.data.tokenizers import (
    build_tokenizer as jbuild_tokenizer,
)
from tensorflow_end2end_speech_recognition_tpu.utils import edit_distance as jed
from tensorflow_end2end_speech_recognition_tpu.utils import metrics as jmetrics
from tensorflow_end2end_speech_recognition_tpu_torch import utils
from tensorflow_end2end_speech_recognition_tpu_torch.data.toy_corpus import (
    TOY_WORDS,
    toy_tokenizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils import metrics

LABEL_TYPES = ("character", "character_capital_divide", "phone61", "phone39", "word", "bpe_50")


def pairs(seed: int, n: int = 300, alphabet: int = 3, longest: int = 12):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield ([f"t{x}" for x in rng.randint(0, alphabet, rng.randint(0, longest))],
               [f"t{x}" for x in rng.randint(0, alphabet, rng.randint(0, longest))])


@pytest.mark.parametrize("alphabet", [2, 3, 5])
def test_wer_align_matches_levenshtein_editops_ties_included(alphabet):
    ties = 0
    for ref, hyp in pairs(alphabet, 400, alphabet, 16):
        got, want = utils.wer_align(ref, hyp), jed.wer_align(ref, hyp)
        assert got == want, (ref, hyp)
        # a pair whose distance also splits another way is a tie
        ties += got["sub"] > 0 and (got["ins"] + got["del"]) > 0
    assert ties > 50


@pytest.mark.parametrize("seed", [0, 1])
def test_rates_match_jax(seed):
    for ref, hyp in pairs(seed):
        for norm in (True, False):
            assert utils.compute_per(ref, hyp, norm) == jed.compute_per(ref, hyp, norm)
            r, h = " ".join(ref), " ".join(hyp)
            assert utils.compute_wer(r, h, norm) == jed.compute_wer(r, h, norm)
            rc, hc = "".join(x[-1] for x in ref), "".join(x[-1] for x in hyp)
            assert utils.compute_cer(rc, hc, norm) == jed.compute_cer(rc, hc, norm)
    assert utils.compute_cer("", "ab") == jed.compute_cer("", "ab") == 2.0


@pytest.mark.parametrize("label_type", LABEL_TYPES)
def test_ids_to_tokens_and_score_pair_match_jax(label_type):
    tok = toy_tokenizer(label_type)  # the JAX toy corpus's units, learnt from its words
    learns = label_type.startswith(("word", "bpe"))
    jtok = jbuild_tokenizer(label_type, **({"corpus_texts": [" ".join(TOY_WORDS * 3)]}
                                           if learns else {}))
    assert tok.units == jtok.units
    rng = np.random.RandomState(len(label_type))
    for _ in range(60):
        ref = rng.randint(0, tok.num_units, rng.randint(1, 10))
        hyp = np.concatenate([ref[:rng.randint(0, len(ref) + 1)],
                              rng.randint(0, tok.num_units, rng.randint(0, 4))])
        assert metrics.ids_to_tokens(ref, tok) == jmetrics.ids_to_tokens(ref, jtok)
        got = metrics.score_pair(ref, hyp, tok, label_type)
        assert got == jmetrics.score_pair(ref, hyp, jtok, label_type)
        assert isinstance(got[0], float)
