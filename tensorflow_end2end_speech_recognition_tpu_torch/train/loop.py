"""Training loop: epochs, plateau LR, dev eval, best-on-dev checkpoints.

Counterpart of the single-device branches of ``fit`` in
``tensorflow_end2end_speech_recognition_tpu/train/loop.py``; the task module
(``ctc_task``, ``transducer_task`` or, for the attention and joint
CTC-attention models, ``att_task``, whose train step also takes the global
step) is picked by ``model_type`` in ``build_task``, and the dev
eval runs the task's eval step through ``evaluate_ctc`` as the JAX ``fit``
does. The corpus is the toy or hard one, or with ``data_root`` an on-disk
corpus of per-utterance ``.npy`` features (``bin/prepare``), whose task then
takes ``[B, T, D]`` frames without a frontend (``feature_dim_of``). With
``cmvn: speaker`` the speaker statistics of train + dev (``cmvn_stats_for``)
ride every batch; ``grad_accum_steps`` splits each batch into that many
microbatches before the one update. The model dir
gets a config copy, ``metrics.csv``, TensorBoard events, checkpoints kept by
dev error and ``summary.json``. The steps run on ``device`` (the card unless
the caller asks for the CPU); the host moves numpy batches in and fetches
the loss only every ``log_every`` steps, so steps queue on the card without
waiting. A resumed run restores parameters, optimizer state, the dropout
generator, the LR controller, the step counter and the best dev error.
The tasks' SpecAugment comes from the config (``ExperimentConfig.
spec_augment``, the JAX loop's ``_specaug``) and draws from the dropout
generator; a MoE encoder's load-balance term is logged beside the loss
(``train/moe_aux``). ``profile_steps=(a, b)`` traces steps a to b - 1 with
``torch.profiler`` (CPU, and CUDA on a card) into a Chrome trace under
``<model_dir>/trace``. At the end ``fit`` writes the loss and error-rate
curves (``utils/plot.py``; a failure, such as no matplotlib, is printed and
ignored, as the JAX loop does). ``num_devices`` above 1 trains over
``torchrun``'s ranks (``parallel/``): data parallel, with tensor,
sequence or expert shards (``num_model_shards``, ``num_sequence_shards``,
``num_expert_shards``), pipeline stages (``num_pipeline_stages``, alone or
with tensor shards), and ``fsdp`` with ZeRO-3.
"""

from __future__ import annotations

import csv
import json
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import set_full_fp32
from ..data.dataset import Dataset
from ..data.hard_corpus import HardCorpus
from ..data.npy_corpus import corpus_split_names, corpus_tokenizer, load_npy_split
from ..data.prefetch import prefetch
from ..data.tokenizers import CharTokenizer
from ..data.toy_corpus import ToyCorpus
from ..parallel.ep import expert_partition_specs
from ..parallel.fsdp import fsdp_partition_specs, gather_whole, place
from ..parallel.mesh import DATA_AXIS, PIPE_AXIS, make_grid, rank_seed
from ..parallel.multihost import distribute_batch, local_replica
from ..parallel.pp import pipeline_param_specs, pp_stack_tree
from ..parallel.tp import param_partition_specs
from ..utils.config import ATTENTION_MODEL_TYPES, ExperimentConfig
from ..utils.metrics import evaluate_ctc
from ..utils.tb_events import EventWriter
from .checkpoint import CheckpointManager, tree_to
from . import att_task, ctc_task, transducer_task
from .lr_controller import LRController
from .optimizer import build_optimizer


def attach_sub_labels(utts, sub_tok) -> None:
    """Multitask: each utterance's sub-task labels from its transcript
    (``_attach_sub_labels`` of the JAX loop)."""
    for u in utts:
        if isinstance(sub_tok, CharTokenizer):
            u.sub_ids = sub_tok.encode_text(u.text)
        else:
            u.sub_ids = sub_tok.encode([t for t in u.text.split() if t in sub_tok.unit_to_idx])


def build_corpus_splits(exp: ExperimentConfig, need=("train", "dev", "test"),
                        load_features: bool = True):
    """(train, dev, test utterances, tokenizer) as the JAX loop splits them; a
    multitask model's utterances carry their sub labels.

    ``data_root`` set: the on-disk corpus's splits (``corpus_split_names``),
    each a list of [T, D] feature utterances; a split not in ``need`` comes
    back as ``[]``, ``load_features=False`` reads the transcripts only, and
    word and BPE units learn from the train transcripts. Otherwise the toy
    corpus (``toy_profile`` easy) or the hard one (hard, harder), whole."""
    sub_tok = exp.sub_tokenizer()
    if exp.data_root is not None:
        names = dict(zip(("train", "dev", "test"),
                         corpus_split_names(exp.data_root, exp.train_data_size)))
        tokenizer = corpus_tokenizer(exp.data_root, exp.label_type, names["train"])
        splits = [load_npy_split(exp.data_root, names[want], tokenizer, load_features)
                  if want in need else [] for want in ("train", "dev", "test")]
        if sub_tok is not None:
            attach_sub_labels([u for split in splits for u in split], sub_tok)
        return (*splits, tokenizer)
    if exp.toy_profile in ("hard", "harder"):
        # "harder": a smaller within-pair F2 gap, twice the speakers, a lower SNR floor
        harder = exp.toy_profile == "harder"
        corpus = HardCorpus(
            label_type=exp.label_type, num_utts=exp.toy_num_utts,
            min_units=exp.toy_min_units, max_units=exp.toy_max_units,
            vocab_size=exp.toy_vocab_size, seed=exp.toy_seed,
            confusability=0.05 if harder else 0.10, num_speakers=32 if harder else 16,
            snr_db=(3.0, 18.0) if harder else (8.0, 25.0),
            max_utt_seconds=exp.max_utt_seconds,
            **({"num_words": exp.toy_lexicon_words} if exp.toy_lexicon_words else {}))
    elif exp.toy_profile != "easy":
        raise ValueError(f"unknown toy_profile {exp.toy_profile!r}")
    else:
        if exp.max_utt_seconds is not None:
            warnings.warn("max_utt_seconds only applies to toy_profile hard/harder; the easy "
                          "corpus (~2 s utterances) is unaffected")
        corpus = ToyCorpus(label_type=exp.label_type, num_utts=exp.toy_num_utts,
                           min_units=exp.toy_min_units, max_units=exp.toy_max_units,
                           vocab_size=exp.toy_vocab_size, seed=exp.toy_seed)
    utts = corpus.utterances
    n = len(utts)
    n_dev = max(n // 10, 1)
    n_test = max(n // 10, 1)
    if sub_tok is not None:
        attach_sub_labels(utts, sub_tok)
    return (utts[: n - n_dev - n_test], utts[n - n_dev - n_test : n - n_test],
            utts[n - n_test :], corpus.tokenizer)


def feature_dim_of(utts) -> int | None:
    """Per-frame dim for precomputed [T, D] feature corpora, None for waveforms."""
    arr = utts[0].wav
    return int(arr.shape[1]) if arr.ndim == 2 else None


def cmvn_stats_for(exp: ExperimentConfig, task, utts, device="cuda"):
    """Speaker-CMVN stats of these utterances (None unless ``cmvn: speaker``),
    a waveform corpus's features extracted on ``device``. Every ``Dataset`` of
    a speaker-CMVN model must carry them: its frontend normalizes nothing."""
    if exp.cmvn != "speaker":
        return None
    from ..frontend.speaker_cmvn import compute_speaker_stats

    return compute_speaker_stats(utts, task.frontend, exp.eval_batch_size or exp.batch_size,
                                 device)


def build_task(exp: ExperimentConfig, tokenizer, feature_dim: int | None = None):
    """(task config, task module) for the configured ``model_type``: ``att_task``
    for attention and joint CTC-attention, ``transducer_task``, else
    ``ctc_task`` (``ctc`` and ``multitask_ctc``, whose sub head counts the
    units of ``label_type_sub``, or the main task's without one).

    ``feature_dim`` set (``feature_dim_of`` on a precomputed-feature corpus)
    drops the frontend: the task takes [B, T, feature_dim] frames."""
    task = exp.task(tokenizer.num_units)
    if feature_dim is not None:
        task = task._replace(frontend=None, feature_dim=feature_dim)
    if exp.model_type in ATTENTION_MODEL_TYPES:
        return task, att_task
    return task, transducer_task if exp.model_type == "transducer" else ctc_task


def start_profile(device: torch.device):
    """A running ``torch.profiler.profile`` of the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, device: torch.device, path: Path) -> Path:
    """Wait for the traced steps' device work, stop ``prof`` and write its
    Chrome trace to ``path``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def fit(exp: ExperimentConfig, model_dir, log_every: int = 10, print_fn=print,
        profile_steps: tuple | None = None, device="cuda"):
    """Train per the experiment config on ``device``; returns the summary dict.

    ``profile_steps`` ``(a, b)``: the profiler starts before global step a
    and stops after step b - 1, as the JAX loop's trace (``bin/train
    --profile`` traces steps 2-5).

    ``num_devices: N`` above 1 (or model, sequence or expert shards) trains
    over the N ranks of the initialized process group (``torchrun``;
    ``bin/train`` sets it up), each on its own ``device`` (``cuda:LOCAL_RANK``
    for ``"cuda"``), on the mesh of ``ExperimentConfig.mesh_axes`` (the JAX
    ``fit``'s dispatch): every rank takes the rows of its data index of each
    global batch; ``num_model_shards`` splits the conformer's heads and FF
    columns (``parallel/tp.py``), ``num_sequence_shards`` its frames
    (``sp.py``), ``num_expert_shards`` its experts (``ep.py``),
    ``num_pipeline_stages`` its layers into GPipe stages over
    ``num_pipeline_microbatches`` microbatches (``pp.py``; the weights and
    moments held stacked, each rank its stage's), ``fsdp`` shards the
    weights and moments over ``data`` (ZeRO-3, composed with the model and
    expert splits); the steps reduce over the ranks. The ranks of one data
    line draw the same dropout and SpecAugment masks (the pipeline's
    stages each a stream of its own from it).
    The dev eval runs the whole weights over the data line and sums the
    counts, and rank 0 alone prints, writes the model dir's files and
    checkpoints (whole tensors, the one-device layout, which any mesh or
    one process restores). Every rank returns the summary."""
    set_full_fp32()
    exp.check_trainable()
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda') needs a CUDA card; pass device='cpu' for the CPU")
    axes = exp.mesh_axes()
    n_data = axes[DATA_AXIS]
    # the process group's ranks (one rank without a group), checked against the mesh
    mesh = make_grid(axes, device=device)
    device, lead = mesh.device, mesh.is_lead
    say = print_fn if lead else (lambda *a, **k: None)
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    if lead:
        exp.to_yaml(model_dir / "config.yml")

    train_utts, dev_utts, _, tokenizer = build_corpus_splits(exp, need=("train", "dev"))
    task, task_mod = build_task(exp, tokenizer, feature_dim_of(train_utts))
    is_att = task_mod is att_task
    # one sweep for the per-speaker mean and variance; batches carry each row's
    cmvn_stats = cmvn_stats_for(exp, task, train_utts + dev_utts, device)
    # the budget counts frames: a waveform corpus's lengths count samples. The
    # row floor keeps every batch divisible into grad_accum_steps microbatches
    # (each into the pipeline's) on each of the ranks
    piped = PIPE_AXIS in axes
    train_ds = Dataset(
        train_utts, exp.batch_size, sort_utt=exp.sort_utt,
        sort_stop_epoch=exp.sort_stop_epoch, seed=exp.seed, cmvn_stats=cmvn_stats,
        max_frames_per_batch=exp.max_frames_per_batch,
        min_batch_rows=exp.grad_accum_steps * n_data
        * (exp.pipeline_microbatches() if piped else 1),
        samples_per_frame=task.frontend.frame_step if task.frontend is not None else 1,
    )
    dev_ds = Dataset(dev_utts, exp.eval_batch_size or exp.batch_size, sort_utt=True,
                     cmvn_stats=cmvn_stats)
    params = tree_to(task_mod.init_params(task, torch.Generator().manual_seed(exp.seed)), device)
    n_params = sum(v.numel() for v in params.values())
    say(f"model: {exp.model_type}/{exp.encoder_type} params={n_params:,} on {device}")

    opt = build_optimizer(exp.optimizer, exp.clip_grad_norm)
    opt_state = opt.init(params)
    # each leaf's placement: the stacked layers' stage (and Megatron) blocks under
    # pipeline stages, else Megatron or expert blocks, and ZeRO-3's data split
    if piped:
        specs = pipeline_param_specs(pp_stack_tree(params, axes[PIPE_AXIS]), "model" in axes)
    else:
        specs = (param_partition_specs(params) if "model" in axes
                 else expert_partition_specs(params) if "expert" in axes else None)
        if exp.fsdp:
            specs = fsdp_partition_specs(params, n_data, specs)
    train_step = task_mod.make_train_step(task, opt, grad_accum=exp.grad_accum_steps,
                                          mesh=mesh, specs=specs)
    eval_step = task_mod.make_eval_step(task)
    controller = LRController(exp.learning_rate, exp.decay_start_epoch, exp.decay_rate,
                              exp.decay_patient_epoch)
    ckpts = CheckpointManager(model_dir / "checkpoints", mesh=mesh)

    csv_path = model_dir / "metrics.csv"
    if lead:
        with open(csv_path, "w", newline="") as f:
            csv.writer(f).writerow(["epoch", "step", "train_loss", "dev_loss", "dev_error_rate",
                                    "lr", "utts_per_sec"])
    events = EventWriter(model_dir / "events") if lead else None

    # dropout and SpecAugment draws: a stream of each data index's own, which the
    # model, sequence and expert ranks of its line share
    generator = torch.Generator(device=device).manual_seed(
        rank_seed(exp.seed + 1, mesh.coord(DATA_AXIS)))
    lr = controller.lr
    step = 0
    best_dev = float("inf")
    summary = {}
    if (model_dir / "summary.json").exists():
        summary = json.loads((model_dir / "summary.json").read_text())
    start_epoch = 0
    if ckpts.latest_epoch is not None:
        start_epoch, state = ckpts.restore({"params": None, "extra": None},
                                           epoch=ckpts.latest_epoch)
        params = tree_to(state["params"], device)
        extra = state["extra"]
        opt_state = tree_to(extra["opt_state"], device)
        generators = extra.get("generators", [extra["generator"]])
        if len(generators) == mesh.size:
            generator.set_state(generators[mesh.rank])
        elif mesh.is_lead:  # another world size: rank 0 resumes the saved stream
            generator.set_state(extra["generator"])
        controller.load_state_dict(extra["lr_controller"])
        lr = controller.lr
        step = int(extra["step"])
        best_dev = float(extra["best_dev"])
        start_epoch += 1
        say(f"resuming from checkpoint epoch {start_epoch - 1}")
    # after any resume, so restored state is placed too: replicated, or cut
    # into this rank's blocks (pipeline stages: of the stacked layout)
    if piped:
        params, opt_state = pp_stack_tree(params, axes[PIPE_AXIS]), \
            pp_stack_tree(opt_state, axes[PIPE_AXIS])
    params, opt_state, _ = place(mesh, params, opt_state, specs)
    if mesh.group is not None:
        say(mesh_line(axes, exp.fsdp) + " ("
            + (f"{exp.pipeline_microbatches()} microbatches, " if piped else "")
            + f"{mesh.size} process(es), backend {dist.get_backend(mesh.group)})")
    prof = None
    trace = model_dir / "trace" / (f"train_steps_{profile_steps[0]}-{profile_steps[1]}.json"
                                   if profile_steps else "")
    for epoch in range(start_epoch, exp.num_epoch):
        t0 = time.perf_counter()
        losses = []
        n_utts = 0
        nonfinite = torch.zeros((), dtype=torch.int64, device=device)
        for batch in prefetch(train_ds.batches(epoch)):
            if profile_steps and step == profile_steps[0] and lead:
                prof = start_profile(device)
            eff_lr = lr * min(1.0, (step + 1) / exp.warmup_steps) if exp.warmup_steps else lr
            params, opt_state, aux = train_step(params, opt_state, distribute_batch(mesh, batch),
                                                eff_lr, generator,
                                                **({"step": step} if is_att else {}))
            nonfinite += aux["nonfinite"]
            step += 1
            if prof is not None and step == profile_steps[1]:
                stop_profile(prof, device, trace)
                prof = None
                say(f"profiler trace written to {trace}")
            n_utts += sum(1 for n in batch["names"] if n is not None)
            if step % log_every == 0:
                losses.append(float(aux["loss"]))  # the only host sync of a step
                scalars = {"train/loss": losses[-1], "train/lr": eff_lr}
                line = f"epoch {epoch} step {step} loss {losses[-1]:.4f} lr {eff_lr:.2e}"
                if "moe_aux" in aux:  # a MoE encoder's load-balance term, inside the loss
                    scalars["train/moe_aux"] = float(aux["moe_aux"])
                    line += f" moe_aux {scalars['train/moe_aux']:.4f}"
                say(line)
                if events is not None:
                    events.write_scalars(step, scalars)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the epoch's queued steps are done
        epoch_time = time.perf_counter() - t0
        # whole weights and optimizer state (gathered from the blocks, in the
        # one-device layout) for eval and the checkpoint; each data line decodes
        # its rows of every dev batch
        whole = local_replica(params, mesh, specs)
        dev = evaluate_ctc(eval_step, whole, dev_ds, tokenizer, exp.label_type, epoch, device,
                           mesh.along(DATA_AXIS))
        ups = n_utts / epoch_time
        train_loss = float(np.mean(losses)) if losses else float(aux["loss"])
        n_nonfinite = int(nonfinite)
        say(f"epoch {epoch} done: train_loss {train_loss:.4f} "
            f"dev_err {dev['error_rate']:.4f} {ups:.1f} utts/s"
            + (f" ({n_nonfinite} steps skipped: non-finite loss)" if n_nonfinite else ""))
        if lead:
            with open(csv_path, "a", newline="") as f:
                csv.writer(f).writerow([epoch, step, train_loss, dev["loss"], dev["error_rate"],
                                        eff_lr, ups])
            epoch_scalars = {"train/epoch_loss": train_loss, "dev/loss": dev["loss"],
                             "dev/error_rate": dev["error_rate"], "train/utts_per_sec": ups}
            if "wer" in dev:
                epoch_scalars["dev/wer"] = dev["wer"]
            events.write_scalars(step, epoch_scalars)
            events.flush()
        if dev["error_rate"] < best_dev:
            best_dev = dev["error_rate"]
        # the controller advances first, so the checkpoint holds this epoch's decision
        lr = controller.update(epoch, dev["error_rate"])
        ckpts.save(epoch, {
            "params": whole,
            "extra": {
                "opt_state": gather_whole(mesh, opt_state, specs),
                "generator": generator.get_state(),
                "generators": rank_states(mesh, generator),
                "lr_controller": controller.state_dict(),
                "step": step,
                "best_dev": best_dev,
            },
        }, dev["error_rate"])
        del whole
        summary = {
            "epochs": epoch + 1, "steps": step, "train_loss": train_loss,
            "dev_loss": dev["loss"], "dev_error_rate": dev["error_rate"],
            "best_dev_error_rate": best_dev, "utts_per_sec": ups,
            "nonfinite_steps": n_nonfinite,
        }
    if prof is not None:  # the run ended inside the traced steps
        stop_profile(prof, device, trace)
        say(f"profiler trace written to {trace}")
    if not lead:
        return summary
    events.close()
    with open(model_dir / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    try:  # loss and error-rate curve PNGs, as the reference wrote into its model dir
        from ..utils.plot import plot_training_curves

        plot_training_curves(model_dir)
    except Exception as e:  # plotting must never fail a finished run
        print_fn(f"plotting failed: {e}")
    return summary


def mesh_line(axes: dict, fsdp: bool) -> str:
    """The JAX ``fit``'s line for its mesh (the port's for data alone)."""
    dp, sp = axes[DATA_AXIS], axes.get("seq")
    if PIPE_AXIS in axes:
        line = f"mesh: {dp}-way data x {axes[PIPE_AXIS]}-stage pipeline" + (
            f" x {axes['model']}-way tensor parallel" if "model" in axes else "")
    elif "model" in axes:
        line = (f"mesh: {dp}-way data x " + (f"{sp}-shard sequence x " if sp else "")
                + f"{axes['model']}-way tensor parallel")
    elif "expert" in axes:
        line = f"mesh: {dp}-way data x {axes['expert']}-shard expert parallel"
    elif sp:
        line = f"mesh: {dp}-way data x {sp}-shard sequence parallel"
    else:
        line = f"mesh: {dp}-way data parallel"
    return line + (" (fsdp: params+moments sharded)" if fsdp else "")


def rank_states(mesh, generator: torch.Generator) -> list:
    """Every rank's generator state, in rank order, on every rank."""
    if mesh.group is None:
        return [generator.get_state()]
    states = [None] * mesh.size
    dist.all_gather_object(states, generator.get_state(), group=mesh.group)
    return states
