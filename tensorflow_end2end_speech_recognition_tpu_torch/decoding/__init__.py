"""Decoders: CTC greedy collapse, the CTC prefix beam, the attention beam
search and joint CTC-attention rescoring."""

from .attention_beam import BeamSearchResult, attention_beam_search
from .ctc_greedy import ctc_greedy_decode
from .ctc_prefix_beam import BeamState, ctc_prefix_beam_search
from .joint_rescoring import joint_rescore

__all__ = ["BeamSearchResult", "BeamState", "attention_beam_search", "ctc_greedy_decode",
           "ctc_prefix_beam_search", "joint_rescore"]
