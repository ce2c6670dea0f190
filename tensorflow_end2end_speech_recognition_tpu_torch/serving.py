"""In-process inference function and the micro-batching runtime.

Counterparts of ``build_inference_fn`` (the CTC branch, greedy or prefix
beam; the transducer branch, greedy or beam; the attention branch, greedy
and beam; RNN-LM shallow fusion in every beam), ``StreamingEngine`` and
``MicroBatcher`` in ``tensorflow_end2end_speech_recognition_tpu/
serving.py``. The JAX package freezes the inference graph into a StableHLO
artifact; here the model runs eagerly in the serving process, and the
streaming engine takes the step functions of ``streaming.
build_streaming_fn`` directly.
"""

from __future__ import annotations

import queue
import threading
import time

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
