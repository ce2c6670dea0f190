"""Decoders: CTC greedy collapse and the attention beam search."""

from .attention_beam import BeamSearchResult, attention_beam_search
from .ctc_greedy import ctc_greedy_decode

__all__ = ["BeamSearchResult", "attention_beam_search", "ctc_greedy_decode"]
