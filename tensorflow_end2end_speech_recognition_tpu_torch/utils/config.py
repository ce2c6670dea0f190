"""Reference-shaped experiment configs -> the port's typed task configs.

A subset of ``tensorflow_end2end_speech_recognition_tpu/utils/config.py``:
``ExperimentConfig`` holds the keys of every config in ``configs/`` (the
CTC, multitask CTC, transducer, attention and joint CTC-attention models,
on the toy corpus, the hard one or an on-disk ``data_root`` corpus), with
the JAX defaults, and builds the
same ``FrontendConfig``, ``EncoderConfig``, ``CTCConfig`` /
``CTCTaskConfig``, ``TransducerConfig`` / ``TransducerTaskConfig`` and
``Seq2SeqConfig`` / ``AttTaskConfig`` values, with ``SpecAugmentConfig``
when ``use_specaugment`` is set. A key the JAX package knows but the port
does not raises ``KeyError`` when it is read; ``check_trainable`` raises
what the JAX ``fit`` raises for the mesh axes (data, tensor, sequence,
expert and pipeline parallelism and ``fsdp``).
``corpus_tokenizer`` gives the units of a config's corpus: the word and BPE
label types learn theirs from its text (a ``data_root`` corpus's train
transcripts).
``yaml`` is imported only when a file is read: ``experiment_from_dict``
builds a config in code where ``yaml`` is missing.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass

from ..data.hard_corpus import hard_tokenizer
from ..data.npy_corpus import corpus_split_names
from ..data.npy_corpus import corpus_tokenizer as npy_corpus_tokenizer
from ..data.tokenizers import Tokenizer, build_tokenizer
from ..data.toy_corpus import learns_units, toy_tokenizer
from ..frontend.augment import SpecAugmentConfig
from ..frontend.features import FrontendConfig
from ..models.attention import AttentionConfig
from ..models.ctc import CTCConfig
from ..models.encoders import CONFORMER_TYPES, EncoderConfig, check_supported
from ..models.seq2seq import Seq2SeqConfig
from ..models.transducer import TransducerConfig
from ..train.att_task import AttTaskConfig
from ..train.ctc_task import CTCTaskConfig
from ..train.transducer_task import TransducerTaskConfig

# reference spellings -> the field they set (None: accepted, has no effect)
ALIASES = {"pretrain_stage": None, "num_classes": None, "dropout_encoder": "dropout",
           "dropout_input": None, "attention_weights_tempareture": "sharpening_factor",
           "logits_tempareture": "logits_temperature"}
ATTENTION_MODEL_TYPES = ("attention", "joint_ctc_attention")
CTC_MODEL_TYPES = ("ctc", "multitask_ctc")
TOY_PROFILES = ("easy", "hard", "harder")


@dataclass
class ExperimentConfig:
    """The CTC, multitask CTC, attention and transducer fields of the JAX
    ``ExperimentConfig``, same names and defaults."""

    model_type: str = "ctc"
    corpus: str = "toy"
    label_type: str = "phone61"
    label_type_sub: str | None = None
    train_data_size: str | None = None
    data_root: str | None = None
    # features
    feature: str = "fbank"
    input_size: int = 40
    use_energy: bool = True
    use_delta: bool = True
    cmvn: str = "utterance"
    num_stack: int = 1
    num_skip: int = 1
    splice: int = 0
    # encoder
    encoder_type: str = "blstm"
    num_units: int = 256
    num_layers: int = 2
    num_proj: int | None = None
    num_layers_sub: int = 1  # multitask: the encoder layer (1-based) the sub head reads
    num_pyramid_levels: int | None = None  # pyramidal 2x reductions (None: all but the last)
    lstm_impl: str | None = None  # accepted for parity; one implementation
    # conformer / transformer encoder
    num_heads: int = 4
    conv_kernel_size: int = 15
    ff_expansion: int = 4
    compute_dtype: str = "float32"
    use_peephole: bool = False
    clip_activation: float | None = None
    parameter_init: float = 0.1
    dropout: float = 1.0  # keep probability
    bottleneck_dim: int | None = None
    main_task_weight: float = 0.8  # multitask: w * main + (1 - w) * sub
    # attention decoder (attention / joint models)
    attention_type: str = "hybrid"
    attention_dim: int = 128
    attention_conv_num_channels: int = 10
    attention_conv_width: int = 101
    decoder_num_units: int = 256
    embedding_dim: int = 128
    scheduled_sampling_prob: float = 0.0
    scheduled_sampling_ramp_max_step: int = 0
    label_smoothing_prob: float = 0.0
    logits_temperature: float = 1.0
    sharpening_factor: float = 1.0
    sigmoid_smoothing: bool = False
    max_decode_length: int = 100
    dropout_decoder: float = 1.0
    dropout_embedding: float = 1.0
    # joint CTC-attention and its training schedules
    ctc_loss_weight: float = 0.0
    guided_attention_weight: float = 0.0
    guided_attention_sigma: float = 0.2
    guided_attention_decay_steps: int = 0
    ctc_loss_weight_init: float | None = None
    ctc_loss_weight_anneal_steps: int = 0
    # transducer (model_type: transducer)
    pred_num_units: int = 256
    pred_num_layers: int = 1
    joint_dim: int = 256
    max_symbols_per_frame: int = 4
    # SpecAugment (frontend/augment.py)
    use_specaugment: bool = False
    freq_mask_width: int = 8
    num_freq_masks: int = 2
    time_mask_frac: float = 0.05
    num_time_masks: int = 2
    # training
    batch_size: int = 32
    num_epoch: int = 20
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    decay_start_epoch: int = 5
    decay_rate: float = 0.9
    decay_patient_epoch: int = 1
    warmup_steps: int = 0
    grad_accum_steps: int = 1
    clip_grad_norm: float = 5.0
    weight_decay: float = 0.0
    sort_utt: bool = True
    sort_stop_epoch: int | None = None
    eval_batch_size: int | None = None
    max_frames_per_batch: int | None = None
    num_devices: int | None = None
    num_model_shards: int | None = None
    num_pipeline_stages: int | None = None
    num_pipeline_microbatches: int | None = None  # default 4 * stages
    num_sequence_shards: int | None = None
    # Mixture-of-Experts FF (conformer / transformer): > 1 experts per block
    moe_num_experts: int | None = None
    moe_top_k: int = 2
    moe_aux_weight: float = 1e-2
    num_expert_shards: int | None = None
    fsdp: bool = False
    # conformer / transformer positions and chunk-causal window
    pos_encoding: str = "absolute"
    left_context: int = -1
    # decode
    beam_width: int = 1
    length_penalty: float = 0.0
    # toy corpus
    toy_profile: str = "easy"  # "hard" / "harder": data/hard_corpus.py; units count words
    toy_num_utts: int = 128
    toy_min_units: int = 3
    toy_max_units: int = 10
    toy_vocab_size: int | None = None
    toy_seed: int = 0
    toy_lexicon_words: int | None = None  # hard corpus lexicon size (None: 50 words)
    max_utt_seconds: float | None = None
    # misc
    seed: int = 0
    save_interval_epochs: int = 1

    @classmethod
    def from_yaml(cls, path) -> "ExperimentConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    @classmethod
    def from_dict(cls, raw: dict) -> "ExperimentConfig":
        fields = {f.name: f for f in dataclasses.fields(cls)}
        # PyYAML reads "3e-3" (no dot) as a string
        float_fields = {n for n, f in fields.items() if f.type in ("float", "float | None")}
        cfg = {}
        for k, v in raw.items():
            if k in ALIASES:
                if ALIASES[k] is None:
                    warnings.warn(f"config key {k!r}={v!r} is accepted for reference parity "
                                  "but has no effect", stacklevel=2)
                    continue
                k = ALIASES[k]
            if k not in fields:
                raise KeyError(f"config key {k!r} is unknown to the port")
            cfg[k] = float(v) if k in float_fields and isinstance(v, str) else v
        return cls(**cfg)

    def to_yaml(self, path) -> None:
        """Write every field as ``key: value`` (JSON scalars are YAML scalars)."""
        with open(path, "w") as f:
            for k, v in dataclasses.asdict(self).items():
                f.write(f"{k}: {json.dumps(v)}\n")

    # ---- derived typed configs ------------------------------------------

    def frontend_config(self) -> FrontendConfig:
        if self.feature == "mfcc":
            # reference MFCC configs: input_size counts cepstra (e.g. 13)
            return FrontendConfig(feature_type="mfcc", num_ceps=self.input_size,
                                  use_energy=self.use_energy, add_deltas=self.use_delta,
                                  cmvn=self.cmvn)
        return FrontendConfig(num_mels=self.input_size, use_energy=self.use_energy,
                              add_deltas=self.use_delta, cmvn=self.cmvn)

    def encoder_config(self) -> EncoderConfig:
        """The JAX ``encoder_config``, its refusals with their texts:
        ``depthwise_impl`` is ``"shifts"`` under model or sequence shards
        (the JAX package's partition-safe form; the same function in the
        port); pipeline stages need a conformer / transformer of divisible
        depth, sequence shards and MoE a conformer / transformer, expert
        shards an expert bank they divide. The encoder carries the pipeline's
        microbatches (``pipeline_microbatches``; the stages are the train
        step's mesh)."""
        sp = self.num_sequence_shards or 1
        depthwise = "shifts" if (self.num_model_shards or 1) > 1 or sp > 1 else "conv"
        pp = self.num_pipeline_stages or 1
        if pp > 1:
            if self.encoder_type not in CONFORMER_TYPES:
                raise ValueError("num_pipeline_stages requires encoder_type conformer/"
                                 f"transformer (uniform blocks), got {self.encoder_type!r}")
            if self.num_layers % pp:
                raise ValueError(f"num_layers {self.num_layers} not divisible by "
                                 f"num_pipeline_stages {pp}")
        if sp > 1 and self.encoder_type not in CONFORMER_TYPES:
            raise ValueError("num_sequence_shards requires encoder_type conformer/"
                             f"transformer (parallel over T), got {self.encoder_type!r}")
        moe = self.moe_num_experts or 0
        if moe > 1:
            if self.encoder_type not in CONFORMER_TYPES:
                raise ValueError("moe_num_experts requires encoder_type conformer/transformer "
                                 f"(MoE feed-forwards), got {self.encoder_type!r}")
            if pp > 1:
                raise ValueError("moe_num_experts with num_pipeline_stages is not supported "
                                 "(the pipelined apply has no MoE FF)")
        ep = self.num_expert_shards or 1
        if ep > 1:
            if moe <= 1:
                raise ValueError("num_expert_shards needs moe_num_experts > 1 (there is no "
                                 "expert bank to shard)")
            if moe % ep:
                raise ValueError(f"moe_num_experts {moe} not divisible by num_expert_shards {ep}")
        cfg = EncoderConfig(
            encoder_type=self.encoder_type,
            num_units=self.num_units,
            num_layers=self.num_layers,
            num_proj=self.num_proj,
            num_layers_sub=self.num_layers_sub,
            num_pyramid_levels=self.num_pyramid_levels,
            input_channels=3 if self.use_delta else 1,
            use_peephole=self.use_peephole,
            clip_activation=self.clip_activation,
            parameter_init=self.parameter_init,
            dropout_keep_prob=self.dropout,
            compute_dtype=self.compute_dtype,
            num_heads=self.num_heads,
            conv_kernel_size=self.conv_kernel_size,
            ff_expansion=self.ff_expansion,
            depthwise_impl=depthwise,
            moe_experts=moe,
            moe_top_k=self.moe_top_k,
            moe_aux_weight=self.moe_aux_weight,
            pos_encoding=self.pos_encoding,
            left_context=self.left_context,
            pipeline_microbatches=self.pipeline_microbatches(),
        )
        check_supported(cfg)
        return cfg

    def spec_augment(self) -> SpecAugmentConfig | None:
        """The tasks' SpecAugment, as ``_specaug`` of the JAX loop builds it."""
        if not self.use_specaugment:
            return None
        return SpecAugmentConfig(freq_mask_width=self.freq_mask_width,
                                 num_freq_masks=self.num_freq_masks,
                                 time_mask_frac=self.time_mask_frac,
                                 num_time_masks=self.num_time_masks)

    def ctc_config(self, num_classes: int, num_classes_sub: int | None = None) -> CTCConfig:
        if self.model_type not in CTC_MODEL_TYPES:
            raise ValueError(f"model_type {self.model_type!r} is not a CTC model")
        return CTCConfig(encoder=self.encoder_config(), num_classes=num_classes,
                         bottleneck_dim=self.bottleneck_dim, num_classes_sub=num_classes_sub)

    def sub_tokenizer(self) -> Tokenizer | None:
        """The multitask sub task's tokenizer (``label_type_sub``), else None."""
        if self.model_type != "multitask_ctc" or not self.label_type_sub:
            return None
        return build_tokenizer(self.label_type_sub)

    def num_classes_sub(self, num_classes: int) -> int | None:
        """The sub head's real units, as ``build_ctc_task`` of the JAX loop
        counts them: ``label_type_sub``'s, or without one the main task's."""
        if self.model_type != "multitask_ctc":
            return None
        sub = self.sub_tokenizer()
        return sub.num_units if sub is not None else num_classes

    def ctc_task(self, num_classes: int) -> CTCTaskConfig:
        """The task ``build_ctc_task`` of the JAX loop builds (waveform mode)."""
        return CTCTaskConfig(
            model=self.ctc_config(num_classes, self.num_classes_sub(num_classes)),
            frontend=self.frontend_config(),
            num_stack=self.num_stack,
            num_skip=self.num_skip,
            splice=self.splice,
            weight_decay=self.weight_decay,
            spec_augment=self.spec_augment(),
            main_task_weight=self.main_task_weight,
        )

    def att_config(self, num_classes: int) -> Seq2SeqConfig:
        """The ``Seq2SeqConfig`` of ``build_att_task`` in the JAX loop."""
        if self.model_type not in ATTENTION_MODEL_TYPES:
            raise ValueError(f"model_type {self.model_type!r} is not an attention model")
        return Seq2SeqConfig(
            encoder=self.encoder_config(),
            attention=AttentionConfig(
                attention_type=self.attention_type,
                attention_dim=self.attention_dim,
                conv_num_channels=self.attention_conv_num_channels,
                conv_width=self.attention_conv_width,
                sharpening_factor=self.sharpening_factor,
                sigmoid_smoothing=self.sigmoid_smoothing,
            ),
            num_classes=num_classes,
            decoder_num_units=self.decoder_num_units,
            embedding_dim=self.embedding_dim,
            logits_temperature=self.logits_temperature,
            scheduled_sampling_prob=self.scheduled_sampling_prob,
            max_decode_length=self.max_decode_length,
            dropout_decoder_keep_prob=self.dropout_decoder,
            dropout_embedding_keep_prob=self.dropout_embedding,
            ctc_loss_weight=(self.ctc_loss_weight if self.model_type == "joint_ctc_attention"
                             else 0.0),
        )

    def att_task(self, num_classes: int) -> AttTaskConfig:
        """The task ``build_att_task`` of the JAX loop builds (waveform mode)."""
        return AttTaskConfig(
            model=self.att_config(num_classes),
            frontend=self.frontend_config(),
            num_stack=self.num_stack,
            num_skip=self.num_skip,
            splice=self.splice,
            weight_decay=self.weight_decay,
            label_smoothing=self.label_smoothing_prob,
            scheduled_sampling_ramp_max_step=self.scheduled_sampling_ramp_max_step,
            spec_augment=self.spec_augment(),
            guided_attention_weight=self.guided_attention_weight,
            guided_attention_sigma=self.guided_attention_sigma,
            guided_attention_decay_steps=self.guided_attention_decay_steps,
            ctc_weight_init=self.ctc_loss_weight_init,
            ctc_weight_anneal_steps=self.ctc_loss_weight_anneal_steps,
        )

    def transducer_config(self, num_classes: int) -> TransducerConfig:
        """The ``TransducerConfig`` of ``build_transducer_task`` in the JAX loop."""
        if self.model_type != "transducer":
            raise ValueError(f"model_type {self.model_type!r} is not a transducer")
        return TransducerConfig(
            encoder=self.encoder_config(),
            num_classes=num_classes,
            pred_num_units=self.pred_num_units,
            pred_num_layers=self.pred_num_layers,
            embedding_dim=self.embedding_dim,
            joint_dim=self.joint_dim,
            parameter_init=self.parameter_init,
            pred_dropout_keep_prob=self.dropout_decoder,
            max_symbols_per_frame=self.max_symbols_per_frame,
        )

    def transducer_task(self, num_classes: int) -> TransducerTaskConfig:
        """The task ``build_transducer_task`` of the JAX loop builds (waveform mode)."""
        return TransducerTaskConfig(
            model=self.transducer_config(num_classes),
            frontend=self.frontend_config(),
            num_stack=self.num_stack,
            num_skip=self.num_skip,
            splice=self.splice,
            weight_decay=self.weight_decay,
            spec_augment=self.spec_augment(),
        )

    def task(self, num_classes: int):
        """``ctc_task``, ``transducer_task`` or ``att_task`` by ``model_type``."""
        if self.model_type in ATTENTION_MODEL_TYPES:
            return self.att_task(num_classes)
        if self.model_type == "transducer":
            return self.transducer_task(num_classes)
        return self.ctc_task(num_classes)

    def pipeline_microbatches(self) -> int:
        """``num_pipeline_microbatches``, by default 4 x the pipeline stages."""
        return self.num_pipeline_microbatches or 4 * (self.num_pipeline_stages or 1)

    def mesh_axes(self) -> dict:
        """``{axis: size}`` of the training mesh, major to minor, as the JAX
        ``fit`` builds it: ``(data, seq, model)`` for model and sequence
        shards together, ``(data, expert)``, ``(data, seq)``, ``(data,
        pipe, model)`` for pipeline stages with model shards, ``(data,
        pipe)``, ``(data, model)``, or ``data`` alone (a rank's index on
        each axis is the JAX device's). ``check_trainable`` validates it."""
        tp, sp = self.num_model_shards or 1, self.num_sequence_shards or 1
        ep, pp = self.num_expert_shards or 1, self.num_pipeline_stages or 1
        if pp > 1:
            total = self.num_devices or (pp * tp)
            return {"data": total // (pp * tp), "pipe": pp} | ({"model": tp} if tp > 1 else {})
        total = self.num_devices or (tp * sp * ep)
        if tp > 1 and sp > 1:
            return {"data": total // (tp * sp), "seq": sp, "model": tp}
        if ep > 1:
            return {"data": total // ep, "expert": ep}
        if sp > 1:
            return {"data": total // sp, "seq": sp}
        if tp > 1:
            return {"data": total // tp, "model": tp}
        return {"data": total}

    def check_trainable(self) -> None:
        """Raise what the JAX ``fit`` raises, with its texts, as
        ``ValueError``: the encoder's refusals (``encoder_config``), a batch
        that ``grad_accum_steps`` does not divide, then the mesh's (expert
        shards exclude the other model axes, pipeline stages exclude
        sequence shards and ``fsdp``, ``fsdp`` needs a data axis to remain,
        the shards must divide ``num_devices`` and the data degree the
        batch; under pipeline stages the microbatches divide the train and
        eval batches, and the data degree their rows). Then the port's own:
        each rank's rows split into ``grad_accum_steps`` microbatches (under
        pipeline stages each of those into the pipeline's microbatches), and
        the data degree divides the eval batch. That the world size is
        ``num_devices`` (or the shards' product) ``parallel.make_grid``
        checks when ``fit`` builds the mesh."""
        n = self.num_devices or 1
        tp, pp = self.num_model_shards or 1, self.num_pipeline_stages or 1
        sp, ep = self.num_sequence_shards or 1, self.num_expert_shards or 1
        self.encoder_config()
        if self.batch_size % self.grad_accum_steps:
            raise ValueError(f"batch_size {self.batch_size} not divisible by "
                             f"grad_accum_steps {self.grad_accum_steps}")
        if ep > 1 and (tp > 1 or pp > 1 or sp > 1):
            raise ValueError("num_expert_shards is mutually exclusive with the other "
                             "model-sharding axes")
        if pp > 1 and sp > 1:
            raise ValueError("num_pipeline_stages and num_sequence_shards are mutually "
                             "exclusive (both shard the encoder activations); "
                             "num_model_shards composes with either")
        if self.fsdp and pp > 1:
            raise ValueError("fsdp cannot combine with pipeline parallelism (stage weights "
                             "live inside shard_map, outside GSPMD placement); tp/sp/ep "
                             "compose fine")
        if self.fsdp and not n > tp * sp * ep:
            raise ValueError("fsdp needs a data-parallel degree > 1 (num_devices, divided by "
                             "any tp/sp/ep shards, must leave a data axis to shard over)")
        total = self.num_devices or (tp * sp * ep)
        if pp > 1:
            self._check_pipeline(pp, tp)
        else:
            if tp > 1 and sp > 1:
                shards, split = tp * sp, f"num_model_shards x num_sequence_shards = {tp}x{sp}"
                degree = "num_devices/(tp*sp)"
            elif ep > 1:
                shards, split = ep, f"num_expert_shards {ep}"
                degree = "num_devices/num_expert_shards"
            elif sp > 1:
                shards, split = sp, f"num_sequence_shards {sp}"
                degree = "num_devices/num_sequence_shards"
            else:
                shards, split = tp, f"num_model_shards {tp}"
                degree = "num_devices/num_model_shards"
            if total > 1 or shards > 1:
                if total % shards:
                    raise ValueError(f"num_devices {total} not divisible by {split}")
                if self.batch_size % (total // shards):
                    raise ValueError(f"batch_size {self.batch_size} not divisible by "
                                     f"data-parallel degree {total // shards} ({degree})")
        dp = self.mesh_axes()["data"]
        a = self.grad_accum_steps
        if self.batch_size % (a * dp):
            raise ValueError(f"batch_size {self.batch_size} not divisible by grad_accum_steps "
                             f"x data-parallel degree = {a}x{dp} (each rank splits its rows "
                             "into grad_accum_steps microbatches)")
        eval_rows = self.eval_batch_size or self.batch_size
        if eval_rows % dp:
            raise ValueError(f"eval batch size {eval_rows} not divisible by data-parallel "
                             f"degree {dp} (each rank decodes its rows of every dev batch)")
        if self.toy_profile not in TOY_PROFILES:
            raise ValueError(f"unknown toy_profile {self.toy_profile!r}")

    def _check_pipeline(self, pp: int, tp: int) -> None:
        """The JAX ``fit``'s checks of pipeline stages, with their texts
        (the stages x model shards divide ``num_devices``, the microbatches
        the train and eval batches, the data degree a microbatch's rows),
        then the port's: each rank's grad_accum_steps microbatches split
        into the pipeline's."""
        total, mb = self.num_devices or (pp * tp), self.pipeline_microbatches()
        if total % (pp * tp):
            raise ValueError(f"num_devices {total} not divisible by num_pipeline_stages x "
                             f"num_model_shards = {pp}x{tp}")
        dp = total // (pp * tp)
        for name, b in (("batch_size", self.batch_size),
                        ("eval_batch_size", self.eval_batch_size or self.batch_size)):
            if b % mb:
                raise ValueError(f"{name} {b} not divisible by num_pipeline_microbatches {mb}")
            if (b // mb) % dp:
                raise ValueError(f"{name} {b} / {mb} microbatches leaves {b // mb} rows, "
                                 f"not divisible by data-parallel degree {dp}")
        a = self.grad_accum_steps
        if self.batch_size % (a * mb * dp):
            raise ValueError(f"batch_size {self.batch_size} not divisible by grad_accum_steps x "
                             f"num_pipeline_microbatches x data-parallel degree = {a}x{mb}x{dp} "
                             "(each rank splits each of its grad_accum_steps microbatches into "
                             "the pipeline's)")


def experiment_from_dict(raw: dict) -> ExperimentConfig:
    """A config dict shaped like the YAML files -> ``ExperimentConfig``."""
    return ExperimentConfig.from_dict(raw)


def corpus_tokenizer(exp: ExperimentConfig) -> Tokenizer:
    """The tokenizer of the config's corpus, without rendering or loading it:
    the word and BPE label types learn their units from the corpus's text
    (the toy corpus's word list, the hard corpus's lexicon or a ``data_root``
    corpus's train transcripts), as ``build_corpus_splits(exp, need=())`` of
    the JAX loop learns them."""
    if exp.data_root is not None:
        train_name = corpus_split_names(exp.data_root, exp.train_data_size)[0]
        return npy_corpus_tokenizer(exp.data_root, exp.label_type, train_name)
    if not learns_units(exp.label_type):
        return build_tokenizer(exp.label_type)
    if exp.toy_profile in ("hard", "harder"):
        return hard_tokenizer(exp.label_type, exp.toy_seed, exp.toy_lexicon_words or 50)
    return toy_tokenizer(exp.label_type)


def task_from_dict(raw: dict):
    """Reference-shaped config dict -> (task config, units, label_type).

    The task is a ``CTCTaskConfig`` (``ctc``, ``multitask_ctc``), for
    ``model_type: transducer`` a ``TransducerTaskConfig``, and for
    ``attention`` and ``joint_ctc_attention`` an ``AttTaskConfig``; the units
    are those of ``corpus_tokenizer``.
    """
    exp = ExperimentConfig.from_dict(raw)
    units = corpus_tokenizer(exp).units
    return exp.task(len(units)), list(units), exp.label_type


def load_task(path):
    """Read a YAML config file; see ``task_from_dict``."""
    import yaml

    with open(path) as f:
        return task_from_dict(yaml.safe_load(f) or {})
