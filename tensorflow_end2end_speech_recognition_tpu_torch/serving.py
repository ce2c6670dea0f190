"""In-process inference function and the micro-batching runtime.

Counterparts of ``build_inference_fn`` (the CTC branch, greedy or prefix
beam; the transducer greedy branch; the attention branch, greedy and beam;
RNN-LM shallow fusion in both beams) and ``MicroBatcher`` in
``tensorflow_end2end_speech_recognition_tpu/serving.py``. The JAX package
freezes the inference graph into a StableHLO artifact; here the model runs
eagerly in the serving process. The transducer beam search is not ported
yet.
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
from .decoding.transducer_greedy import transducer_greedy_decode
from .models.seq2seq import greedy_decode
from .train.ctc_task import CTCTaskConfig, device_pipeline
from .train.transducer_task import TransducerTaskConfig


def build_inference_fn(task, model, beam_width: int = 1, lm=None, lm_weight: float = 0.0):
    """(inputs [B, N], input_len [B]) -> (decoded ids [B, U] int32, lengths [B] int32).

    ``task`` is a ``CTCTaskConfig`` (greedy CTC decoding, or with
    ``beam_width > 1`` the best prefix of the CTC prefix beam, ids [B, T']),
    a ``TransducerTaskConfig`` (greedy transducer decoding, ids [B, T' * S])
    or an ``AttTaskConfig``: greedy decoding, with every id from the first
    EOS on set to -1, or with ``beam_width > 1`` the best hypothesis of the
    beam search (length penalty 0, as the JAX export stages it). ``lm`` (an
    ``RNNLM`` on the model's device) with a non-zero ``lm_weight`` is fused
    into either beam. Runs on the device of ``model``'s weights; inputs may
    be numpy arrays or tensors. Returns device tensors.
    """
    set_full_fp32()
    device = next(model.parameters()).device
    model.eval()
    is_ctc = isinstance(task, CTCTaskConfig)
    is_transducer = isinstance(task, TransducerTaskConfig)
    if is_transducer and beam_width > 1:
        raise NotImplementedError("the transducer beam search is not ported yet")
    use_lm = lm is not None and lm_weight and beam_width > 1
    fusion_lm = None
    if use_lm and is_ctc:
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
            return transducer_greedy_decode(model, *model.encode(feats, feat_len))
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
