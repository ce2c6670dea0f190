"""BLSTM, pyramidal BLSTM, conformer and transformer encoders, the CTC model,
the attention seq2seq (+ joint CTC-attention) model."""

from .attention import Attention, AttentionConfig
from .ctc import CTCConfig, CTCModel
from .encoders import Encoder, EncoderConfig
from .seq2seq import Seq2SeqConfig, Seq2SeqModel, encode, greedy_decode

__all__ = ["Attention", "AttentionConfig", "CTCConfig", "CTCModel", "Encoder", "EncoderConfig",
           "Seq2SeqConfig", "Seq2SeqModel", "encode", "greedy_decode"]
