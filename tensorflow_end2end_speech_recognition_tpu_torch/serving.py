"""Inference functions, the port's exported artifacts, and the serving runtimes.

Counterparts of ``build_inference_fn`` (the CTC branch, greedy or prefix
beam; the transducer branch, greedy or beam; the attention branch, greedy
and beam; RNN-LM shallow fusion in every beam), ``export_model`` /
``load_exported``, ``export_streaming_model`` / ``load_streaming``,
``StreamingEngine`` and ``MicroBatcher`` in
``tensorflow_end2end_speech_recognition_tpu/serving.py``.

The JAX package freezes the inference graph into a StableHLO program with
the weights baked in. The port's hand-written kernels are ctypes calls that
no graph export can trace, so its artifact is the model itself: ``<out>``, a
numpy ``.npz`` (no pickle) of the model's weights under their ``state_dict``
names with a ``model/`` prefix (and an RNN-LM's under ``lm/``), and
``<out>.json``, the JAX serving contract (the same keys and meanings) plus
what the loader needs to rebuild the model without the model dir's YAML or
its corpus: the ``experiment`` config, ``num_classes`` (the units are stored
too, so a word or BPE model trained from a ``data_root`` corpus loads with
the corpus gone), the LM's ``lm_config`` and a ``format`` tag. The loaders
rebuild the model and return the same inference and streaming functions
the port serves in process, on the device asked for.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import set_full_fp32
from .decoding.attention_beam import attention_beam_search
from .decoding.ctc_greedy import ctc_greedy_decode
from .decoding.ctc_prefix_beam import ctc_prefix_beam_search
from .decoding.transducer_beam import transducer_beam_search
from .decoding.transducer_greedy import transducer_greedy_decode
from .models.seq2seq import greedy_decode
from .train.ctc_task import CTCTaskConfig, device_pipeline
from .train.transducer_task import TransducerTaskConfig


def build_inference_fn(task, model, beam_width: int = 1, lm=None, lm_weight: float = 0.0):
    """(inputs [B, N], input_len [B]) -> (decoded ids [B, U] int32, lengths [B] int32).

    ``task`` is a ``CTCTaskConfig`` (greedy CTC decoding, or with
    ``beam_width > 1`` the best prefix of the CTC prefix beam, ids [B, T']),
    a ``TransducerTaskConfig`` (greedy transducer decoding, or with
    ``beam_width > 1`` the best hypothesis of the transducer beam; ids
    [B, T' * S]) or an ``AttTaskConfig``: greedy decoding, with every id from the first
    EOS on set to -1, or with ``beam_width > 1`` the best hypothesis of the
    beam search (length penalty 0, as the JAX export stages it). ``lm`` (an
    ``RNNLM`` on the model's device) with a non-zero ``lm_weight`` is fused
    into any of the three beams. Runs on the device of ``model``'s weights; inputs may
    be numpy arrays or tensors. Returns device tensors.

    A task without a frontend (``frontend=None``, a model trained on a
    ``data_root`` corpus) takes feature frames ``[B, T, feature_dim]`` and
    ``input_len`` in frames, and applies no per-speaker statistics, as the
    JAX ``infer`` passes none: a ``cmvn: speaker`` model expects features
    that are normalised already.
    """
    set_full_fp32()
    device = next(model.parameters()).device
    model.eval()
    is_ctc = isinstance(task, CTCTaskConfig)
    is_transducer = isinstance(task, TransducerTaskConfig)
    use_lm = lm is not None and lm_weight and beam_width > 1
    fusion_lm = None
    if use_lm and (is_ctc or is_transducer):  # both class layouts put blank last
        from .models.lm import make_fusion_lm

        fusion_lm = make_fusion_lm(lm, task.model.vocab_with_blank)

    def decode(feats, feat_len):
        if is_ctc:
            out = model(feats, feat_len)
            if beam_width > 1:
                prefixes, lengths, _ = ctc_prefix_beam_search(
                    out.logits, out.logit_len, task.model.blank_id, beam_width=beam_width,
                    fusion_lm=fusion_lm, lm_weight=lm_weight)
                return prefixes[:, 0], lengths[:, 0]
            return ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
        if is_transducer:
            f_proj, enc_len = model.encode(feats, feat_len)
            if beam_width > 1:
                res = transducer_beam_search(model, f_proj, enc_len, beam_width=beam_width,
                                             fusion_lm=fusion_lm, lm_weight=lm_weight)
                return res.tokens[:, 0], res.lengths[:, 0]
            return transducer_greedy_decode(model, f_proj, enc_len)
        if beam_width > 1:
            res = attention_beam_search(model, feats, feat_len, beam_width=beam_width,
                                        lm=lm if use_lm else None,
                                        lm_weight=lm_weight if use_lm else 0.0)
            return res.tokens[:, 0], res.lengths[:, 0]
        preds = greedy_decode(model, feats, feat_len).predicted_ids
        seen = torch.cumsum(preds == task.model.eos_id, dim=1) > 0
        return torch.where(seen, -1, preds), (~seen).sum(dim=1, dtype=torch.int32)

    @torch.inference_mode()
    def infer(inputs, input_len):
        inputs = torch.as_tensor(inputs, dtype=torch.float32).to(device)
        input_len = torch.as_tensor(input_len, dtype=torch.int64).to(device)
        return decode(*device_pipeline(task, {"inputs": inputs, "input_len": input_len}))

    return infer


ARTIFACT_FORMAT = "torch_port_artifact/1"


class _Units(NamedTuple):
    """The one tokenizer field ``train/loop.build_task`` reads."""

    num_units: int


def _contract_path(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".json")


def _write_artifact(out_path, model, lm, meta: dict) -> Path:
    """``<out>``: the weights (``model/``, ``lm/``) as one numpy ``.npz`` written
    through a file handle (numpy would append ``.npz`` to a path); ``<out>.json``:
    ``meta``."""
    out_path = Path(out_path)
    arrays = {f"model/{k}": v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    if lm is not None:
        arrays.update({f"lm/{k}": v.detach().cpu().numpy() for k, v in lm.state_dict().items()})
    with open(out_path, "wb") as f:
        np.savez(f, **arrays)
    _contract_path(out_path).write_text(json.dumps(meta, indent=2))
    return out_path


def _port_meta(task, experiment, units, lm) -> dict:
    """The contract keys the port's loader reads beyond the JAX contract's."""
    import dataclasses

    if experiment is None:
        raise ValueError("export needs the experiment config the model was built from "
                         "(``experiment``): the loader rebuilds the model from it")
    if dataclasses.is_dataclass(experiment):
        experiment = dataclasses.asdict(experiment)
    if units is not None and len(units) != task.model.num_classes:
        raise ValueError(f"{len(units)} units for a model of {task.model.num_classes} classes")
    return {"format": ARTIFACT_FORMAT, "experiment": dict(experiment),
            "num_classes": task.model.num_classes,
            "lm_config": None if lm is None else lm.cfg._asdict()}


def export_model(task, model, out_path, batch_size: int, num_samples: int,
                 beam_width: int = 1, units=None, label_type: str | None = None,
                 experiment=None, feature_dim: int | None = None, platforms=("cuda",),
                 extra_meta: dict | None = None, lm=None, lm_weight: float = 0.0) -> Path:
    """Write the batch artifact of ``model`` (``task``'s); returns ``<out>``.

    ``num_samples``: padded waveform samples, or padded frames when the task
    has no frontend (inputs ``[B, T, feature_dim]``; ``feature_dim`` is the
    task's). ``experiment`` (an ``ExperimentConfig`` or its dict) is what the
    loader rebuilds the task from, with ``num_classes`` and ``feature_dim``;
    ``units`` and ``label_type`` go to the contract for clients to decode
    text. ``lm`` (an ``RNNLM``) with ``lm_weight`` is fused into the beam.
    ``<out>.json`` holds the JAX contract's keys (``batch_size``,
    ``num_samples``, ``input_rank``, ``feature_dim``, ``beam_width``,
    ``lm_weight``, ``platforms``, ``blank_id``, ``units``, then
    ``extra_meta``) and the port's own (``format``, ``experiment``,
    ``num_classes``, ``lm_config``, ``label_type``). ``platforms`` lists the
    device types the artifact may load on (``load_exported`` refuses
    another). The attention beam's length penalty is 0, as the JAX export
    stages it.
    """
    if task.frontend is None:
        if feature_dim is not None and feature_dim != task.feature_dim:
            raise ValueError(f"feature_dim {feature_dim} != the task's {task.feature_dim}")
        feature_dim = task.feature_dim
    elif feature_dim is not None:
        raise ValueError("feature_dim is for a task without a frontend (precomputed features)")
    meta = {
        "batch_size": batch_size,
        "num_samples": num_samples,
        "input_rank": 2 if task.frontend is not None else 3,
        "feature_dim": feature_dim,
        "beam_width": beam_width,
        "lm_weight": lm_weight if lm is not None else 0.0,
        "platforms": list(platforms),
        "blank_id": getattr(task.model, "blank_id", None),
        "units": list(units) if units else None,
        **_port_meta(task, experiment, units, lm),
        "label_type": label_type,
        **(extra_meta or {}),
    }
    return _write_artifact(out_path, model, lm, meta)


def _load_artifact(path, device, streaming: bool):
    """(contract, task, model, lm) of an artifact, on ``device``; refuses a device
    type not in its ``platforms`` and the other kind of artifact."""
    from .models.lm import RNNLM, LMConfig
    from .train.loop import build_task
    from .utils.bridge import check_state_dict
    from .utils.config import ExperimentConfig

    path = Path(path)
    meta = json.loads(_contract_path(path).read_text())
    if meta.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{path} is not an artifact of this port (format "
                         f"{meta.get('format')!r}, expected {ARTIFACT_FORMAT!r})")
    if streaming and not meta.get("streaming"):
        raise ValueError(f"{path} is not a streaming artifact")
    if not streaming and meta.get("streaming"):
        raise ValueError(f"{path} is a streaming artifact: load it with load_streaming")
    device = torch.device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not {device.type}")
    exp = ExperimentConfig.from_dict(meta["experiment"])
    task, task_mod = build_task(exp, _Units(meta["num_classes"]), meta.get("feature_dim"))
    with np.load(path, allow_pickle=False) as z:
        weights = {k: torch.from_numpy(z[k]) for k in z.files}
    model = task_mod.init_model(task)
    lm = None if meta.get("lm_config") is None else RNNLM(LMConfig(**meta["lm_config"]))
    for prefix, module in (("model/", model), ("lm/", lm)):
        if module is not None:
            state = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
            check_state_dict(module, state)
            module.load_state_dict(state)
    unknown = [k for k in weights if not k.startswith(("model/", "lm/") if lm else "model/")]
    if unknown:
        raise KeyError(f"{path}: arrays outside the model and its LM: {unknown[:5]}")
    return (meta, task, model.to(device).eval(),
            None if lm is None else lm.to(device).eval())


def load_exported(path, device="cuda"):
    """Load a batch artifact of ``export_model``; returns ``infer(inputs,
    input_len) -> (ids, lengths)``, the ``build_inference_fn`` of the stored
    model (its ``beam_width``, LM and ``lm_weight``) on ``device``, which
    returns device tensors.

    The task is rebuilt from the contract's ``experiment``, ``num_classes``
    and ``feature_dim``, as ``train/loop.build_task`` builds it; the weights
    are read with ``allow_pickle=False`` and must match the model's names and
    shapes. Raises for a device type the artifact was not exported for, and
    for a streaming artifact (``load_streaming``).
    """
    meta, task, model, lm = _load_artifact(path, device, streaming=False)
    return build_inference_fn(task, model, meta["beam_width"], lm, meta["lm_weight"])


def export_streaming_model(task, model, out_path, batch_size: int, chunk_samples: int,
                           units=None, label_type: str | None = None, experiment=None,
                           platforms=("cuda",), extra_meta: dict | None = None,
                           beam_width: int = 1, top_k_classes: int = 16,
                           max_prefix_len: int = 200, lm=None, lm_weight: float = 0.0) -> Path:
    """Write the streaming artifact of ``model``: its chunk step
    (``streaming.build_streaming_fn``) for ``batch_size`` slots and chunks of
    ``chunk_samples``; returns ``<out>``.

    The weights and the port's own contract keys are as ``export_model``'s.
    The contract's JAX keys: ``streaming``, ``batch_size``,
    ``chunk_samples``, ``frames_per_chunk`` (the step's token width),
    ``beam_width``, ``final_flush`` (a stacked stream ends on a chunk
    boundary with ``chunk_len = -1``), ``platforms``, ``blank_id``,
    ``units``, then ``extra_meta``. The JAX export also writes
    ``state_leaves``, ``state_init``, a ``.state0.npz`` sidecar and a
    ``.final`` program because its loader has no model code to rebuild the
    state and the finalize step from; the port's loader rebuilds both, so
    none of them is written.
    """
    from .streaming import build_streaming_fn

    build_streaming_fn(task, model, chunk_samples, beam_width=beam_width,
                       top_k_classes=top_k_classes, max_prefix_len=max_prefix_len, lm=lm,
                       lm_weight=lm_weight)  # refuses what cannot stream
    stacked = task.num_stack > 1 or task.num_skip > 1
    base_frames = chunk_samples // task.frontend.frame_step
    enc_frames = ((task.num_stack - 1 + base_frames) // task.num_skip + 1 if stacked
                  else base_frames)
    meta = {
        "streaming": True,
        "batch_size": batch_size,
        "chunk_samples": chunk_samples,
        "frames_per_chunk": enc_frames * getattr(task.model, "max_symbols_per_frame", 1),
        "beam_width": beam_width,
        "final_flush": stacked,
        "platforms": list(platforms),
        "blank_id": task.model.blank_id,
        "units": list(units) if units else None,
        **_port_meta(task, experiment, units, lm),
        "label_type": label_type,
        "lm_weight": lm_weight if lm is not None else 0.0,
        "top_k_classes": top_k_classes,
        "max_prefix_len": max_prefix_len,
        **(extra_meta or {}),
    }
    return _write_artifact(out_path, model, lm, meta)


def load_streaming(path, device="cuda"):
    """Load a streaming artifact of ``export_streaming_model``; returns
    ``(state0, step, finalize)`` on ``device``: ``state0 = init_fn(batch_size)``
    and ``step`` of ``streaming.build_streaming_fn`` over the stored model, and
    ``finalize`` its ``finalize_fn`` when ``beam_width > 1``, else None. They
    feed ``StreamingEngine`` as the in-process step does. Raises for a batch
    artifact (the JAX message) and for a device type the artifact was not
    exported for."""
    from .streaming import build_streaming_fn

    meta, task, model, lm = _load_artifact(path, device, streaming=True)
    fns = build_streaming_fn(task, model, meta["chunk_samples"], beam_width=meta["beam_width"],
                             top_k_classes=meta["top_k_classes"],
                             max_prefix_len=meta["max_prefix_len"], lm=lm,
                             lm_weight=meta["lm_weight"])
    return fns[0](meta["batch_size"]), fns[1], fns[2] if meta["beam_width"] > 1 else None


class StreamingEngine:
    """Multiplex independent live audio sessions over the rows of a streaming step.

    ``step`` and ``state0`` come from ``streaming.build_streaming_fn``
    (``step(state, chunk [B, C], chunk_len [B]) -> (state, tokens, tok_len)``
    and ``init_fn(B)``). The step advances all B rows at once and a row with
    ``chunk_len == 0`` keeps its state bit for bit, so each row is a *slot*
    that one session owns. Sessions buffer audio on the host; one worker
    thread steps whenever any slot has a full chunk buffered or is ending,
    and all device work runs on that thread. A new session's slot is reset
    to ``state0`` with ``streaming.reset_rows``. Slots idle past
    ``session_timeout_s`` (a client gone without ``end``) are reclaimed.

    ``finalize`` (a beam stream's ``finalize_fn``) makes ``end`` return the
    stream's whole final beam transcript; ``final_flush`` (stacked streams)
    sends the ``chunk_len = -1`` flush when a stream ends on a chunk
    boundary. ``steps_run`` counts the steps.
    """

    def __init__(self, state0, step, batch_size: int, chunk_samples: int,
                 tick_ms: float = 5.0, session_timeout_s: float = 300.0, finalize=None,
                 final_flush: bool = False):
        self._state0 = state0
        self._state = state0
        self._step = step
        self._b = batch_size
        self._chunk = chunk_samples
        self._tick = tick_ms / 1e3
        self._session_timeout = session_timeout_s
        self._finalize = finalize
        self._final_flush = final_flush
        self._lock = threading.Lock()
        self._slots = [None] * batch_size  # session dicts (or None)
        self._sessions: dict[str, int] = {}
        self._stop = threading.Event()
        self.steps_run = 0  # written by the worker thread only
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- session API (thread-safe) ------------------------------------------

    def start(self) -> str | None:
        """Take a free slot; returns a session id, or None when every slot is busy."""
        import uuid

        with self._lock:
            for i, s in enumerate(self._slots):
                if s is None:
                    sid = uuid.uuid4().hex[:12]
                    self._slots[i] = {
                        "id": sid, "buf": np.zeros((0,), np.float32), "pending": [],
                        "ending": False, "reset": True, "flushed": threading.Event(),
                        "last": time.monotonic(),
                    }
                    self._sessions[sid] = i
                    return sid
        return None

    def feed(self, sid: str, samples) -> list:
        """Append audio; returns the tokens emitted since the last call."""
        samples = np.asarray(samples, np.float32).ravel()
        with self._lock:
            slot = self._slots[self._sessions[sid]]
            if slot.get("error") is not None:
                raise slot["error"]
            if slot["ending"]:
                raise ValueError("session already ended")
            slot["buf"] = np.concatenate([slot["buf"], samples])
            slot["last"] = time.monotonic()
            out, slot["pending"] = slot["pending"], []
        return out

    def end(self, sid: str, timeout: float = 60.0) -> list:
        """Flush the remaining audio; returns the final tokens and frees the slot.

        A greedy engine returns the tokens emitted since the last ``feed``; a
        beam engine (``finalize`` set) the stream's whole final transcript,
        which supersedes the greedy partials delivered live.
        """
        with self._lock:
            i = self._sessions[sid]
            slot = self._slots[i]
            slot["ending"] = True
            ev = slot["flushed"]
        if not ev.wait(timeout):
            # free the slot anyway: a hung step must not hold it forever
            with self._lock:
                if self._sessions.get(sid) == i:
                    self._slots[i] = None
                    del self._sessions[sid]
            raise TimeoutError("stream flush timed out")
        with self._lock:
            out = slot["pending"]
            if self._finalize is not None and slot.get("final") is not None:
                out = slot["final"]
            err = slot.get("error")
            self._slots[i] = None
            del self._sessions[sid]
        if err is not None:
            raise err
        return out

    def stop(self):
        self._stop.set()
        self._worker.join(timeout=5.0)

    # -- worker --------------------------------------------------------------

    def _fail(self, rows, e: Exception) -> None:
        with self._lock:
            for i in rows:
                s = self._slots[i]
                if s is not None:
                    s["error"] = e
                    s["flushed"].set()

    def _run(self):
        from .streaming import reset_rows

        c = self._chunk
        while not self._stop.is_set():
            with self._lock:
                # reclaim slots abandoned without end(), ending ones too: a
                # client that is gone must not hold a slot forever
                now = time.monotonic()
                for i, s in enumerate(self._slots):
                    if s is not None and now - s["last"] > self._session_timeout:
                        del self._sessions[s["id"]]
                        self._slots[i] = None
                resets = [i for i, s in enumerate(self._slots) if s and s["reset"]]
                work = []
                for i, s in enumerate(self._slots):
                    if s is None or s["reset"]:
                        continue
                    if len(s["buf"]) >= c:
                        work.append((i, s["buf"][:c], c))
                        s["buf"] = s["buf"][c:]
                    elif s["ending"] and not s["flushed"].is_set():
                        n = len(s["buf"])
                        # a stacked stream ending on a chunk boundary: -1 flushes
                        work.append((i, s["buf"], -1 if n == 0 and self._final_flush else n))
                        s["buf"] = np.zeros((0,), np.float32)
                for i in resets:
                    self._slots[i]["reset"] = False
            if resets:
                mask = np.zeros((self._b,), bool)
                mask[resets] = True
                self._state = reset_rows(self._state, self._state0, mask)
            if not work:
                time.sleep(self._tick)
                continue
            chunk = np.zeros((self._b, c), np.float32)
            lens = np.zeros((self._b,), np.int32)
            for i, data, n in work:
                chunk[i, : len(data)] = data
                lens[i] = n
            try:
                self._state, toks, nn = self._step(self._state, chunk, lens)
                toks, nn = toks.cpu().numpy(), nn.cpu().numpy()
                self.steps_run += 1
            except Exception as e:  # a device error fails these sessions; the engine stays up
                self._fail([i for i, _, _ in work], e)
                continue
            finished = []
            with self._lock:
                for i, _, n in work:
                    s = self._slots[i]
                    if s is None:
                        continue
                    s["pending"].extend(int(t) for t in toks[i, : nn[i]])
                    # a short (or flush) chunk ends the stream; a stream ending on
                    # a chunk boundary ends with its last full chunk unless a
                    # stacked stream still has to flush its tail windows
                    done = s["ending"] and (n < c or (len(s["buf"]) == 0
                                                      and not self._final_flush))
                    if done:
                        if self._finalize is None:
                            s["flushed"].set()
                        else:
                            finished.append(i)
            if finished:
                # one finalize call gives the finished streams' final beams
                try:
                    pref, flen, _ = self._finalize(self._state)
                    pref, flen = pref.cpu().numpy(), flen.cpu().numpy()
                except Exception as e:  # noqa: BLE001 — fail those sessions
                    self._fail(finished, e)
                    continue
                with self._lock:
                    for i in finished:
                        s = self._slots[i]
                        if s is not None:
                            s["final"] = [int(t) for t in pref[i, 0, : flen[i, 0]]]
                            s["flushed"].set()


class MicroBatcher:
    """Group concurrent single-utterance requests into fixed-shape batches.

    Requests queue until ``batch_size`` are waiting or ``max_wait_ms`` has
    passed since the first one; unused rows are zero-padded, ONE ``infer``
    call runs the batch, and the per-row results go back to the waiters. All
    device work happens on the single worker thread. ``batches_run`` counts
    the ``infer`` calls.
    """

    def __init__(self, infer, batch_size: int, row_shape: tuple,
                 max_wait_ms: float = 10.0):
        self._infer = infer
        self._batch_size = batch_size
        self._row_shape = tuple(row_shape)
        self._max_wait = max_wait_ms / 1e3
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0  # written by the worker thread only
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, inputs: np.ndarray, input_len: int, timeout: float = 60.0):
        """Enqueue one utterance; block until its (ids, length) are ready."""
        inputs = np.asarray(inputs, np.float32)
        if inputs.shape != self._row_shape:
            raise ValueError(
                f"request shape {inputs.shape} != batch row shape {self._row_shape}"
            )
        req = {"inputs": inputs, "len": int(input_len),
               "done": threading.Event(), "result": None, "error": None}
        self._queue.put(req)
        if not req["done"].wait(timeout):
            raise TimeoutError("inference timed out")
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def stop(self):
        self._stop.set()
        self._worker.join(timeout=5.0)

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            reqs = [first]
            deadline = time.monotonic() + self._max_wait
            while len(reqs) < self._batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    reqs.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            batch = np.zeros((self._batch_size,) + self._row_shape, np.float32)
            lens = np.zeros((self._batch_size,), np.int32)
            for i, r in enumerate(reqs):
                batch[i] = r["inputs"]
                lens[i] = r["len"]
            try:
                ids, n = (x.cpu().numpy() for x in self._infer(batch, lens))
                self.batches_run += 1
                for i, r in enumerate(reqs):
                    r["result"] = (ids[i], int(n[i]))
            except Exception as e:  # surface device errors to every waiter
                for r in reqs:
                    r["error"] = e
            for r in reqs:
                r["done"].set()
