"""Serve a CTC, transducer or attention model over HTTP: batches or live streams.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/bin/serve.py``
(the batch API and the streaming session API). Two ways in:

- ``bin/serve ARTIFACT``: an artifact of ``bin/export`` (``ARTIFACT`` and
  ``ARTIFACT.json`` beside it), as the JAX server serves its StableHLO
  artifacts: the contract gives the batch, the padded input (samples, or
  frames of ``feature_dim`` for a model trained on a ``data_root`` corpus),
  the beam and the units, or for a streaming artifact the slots and the
  chunk. The model dir and the corpus are not needed.
- ``bin/serve CONFIG WEIGHTS``: the model built from a reference-shaped YAML
  config plus a weights file written by ``utils/bridge.py`` (``.npz`` or
  ``torch.save``), with ``--batch``, ``--seconds``, ``--beam-width`` and,
  for live sessions, ``--stream``.

Concurrent requests are grouped into fixed batches by
``serving.MicroBatcher``; live sessions are multiplexed over the rows of one
streaming step (``serving.StreamingEngine`` over
``streaming.build_streaming_fn``).

    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.serve \
        /tmp/model.art [--device cuda] [--host 127.0.0.1] [--port 8000]
    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.serve \
        configs/ls100_ctc.yml weights.npz [--device cuda] [--batch 8] \
        [--seconds 12] [--host 127.0.0.1] [--port 8000] [--max-wait-ms 10]
    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.serve \
        configs/ls960_joint.yml weights.npz --beam-width 8
    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.serve \
        configs/ls100_ctc.yml weights.npz --beam-width 20
    python -m tensorflow_end2end_speech_recognition_tpu_torch.bin.serve \
        configs/ls_streaming_ctc.yml weights.npz --stream --chunk-ms 100 \
        [--beam-width 8] [--lm-dir DIR] [--session-timeout-s 300]

``model_type`` in the config picks the model: ``ctc`` decodes greedily, or
with the CTC prefix beam search at ``--beam-width`` above 1; ``attention``
and ``joint_ctc_attention`` decode greedily, or with the attention beam
search at ``--beam-width`` above 1; ``transducer``
(``configs/ls_transducer.yml``) decodes greedily, or with the transducer
beam at ``--beam-width`` above 1. ``--lm-dir`` (``bin/train_lm``) fuses an
RNN-LM into any beam. A model trained from a ``data_root`` corpus took
precomputed features, not audio: its config raises here; export it
(``bin/export``) and serve the artifact.

API:
  GET  /healthz    -> the serving contract (batch size, samples or frames,
                      beam width, blank id (CTC and transducer; null for
                      attention models), units, device; for CONFIG WEIGHTS
                      also the decode: "greedy", "ctc_prefix_beam",
                      "transducer_beam" or "attention_beam")
  POST /recognize  -> body is JSON ``{"audio": [floats...]}`` (or
                      ``{"features": [[...], ...]}``, frames of
                      ``feature_dim``, for an artifact of a features model)
                      or raw little-endian float32 PCM (Content-Type:
                      application/octet-stream). Response ``{"ids": [...],
                      "num_ids": n, "text": "..."}``; ``"truncated": true``
                      flags input longer than the padded capacity (samples
                      or frames), ``"consumed"`` what was kept.

API of a streaming artifact or ``--stream`` (CTC and transducer models with
a causal encoder: ``lstm``, or a conformer / transformer with
``left_context >= 0``):
  POST /stream/start          -> ``{"session": id, "chunk_samples": C}``, or
                                 503 when every slot is busy
  POST /stream/audio?session= -> append audio (JSON ``{"audio": [...]}`` or
                                 raw float32 PCM); ``{"ids", "text"}``: the
                                 tokens decoded since the last post (greedy)
  POST /stream/end?session=   -> flush the rest; ``{"ids", "text"}``, with
                                 ``"final": true`` at ``--beam-width`` above
                                 1: then the ids are the whole final beam
                                 transcript, superseding the live partials

Error statuses: 400 malformed request or unknown session, 503 overload
(slots busy, inference timeout), 500 device failure.
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch


def _decode_text(ids, meta) -> str | None:
    units = meta.get("units")
    if not units:
        return None
    # ids outside the units are skipped: an attention model's sos and eos
    # (num_classes, num_classes + 1)
    toks = [units[i] for i in ids if 0 <= i < len(units)]
    sep = "" if str(meta.get("label_type", "")).startswith("character") else " "
    return sep.join(toks)


class _Handler(BaseHTTPRequestHandler):
    meta: dict = {}
    batcher = None
    request_timeout_s: float = 60.0
    row_shape: tuple = ()  # one request's padded input: (samples,) or (frames, feature_dim)

    def log_message(self, *args):  # quiet; stdout is the server log
        pass

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, e: Exception):
        # 4xx = the caller's fault; 503 = back off and retry; 500 = server
        # or device failure
        if isinstance(e, TimeoutError):
            code = 503
        elif isinstance(e, (ValueError, KeyError, TypeError, json.JSONDecodeError)):
            code = 400
        else:
            code = 500
        self._json(code, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, {"status": "ok", **self.meta})
        else:
            self._json(404, {"error": "unknown path"})

    def _read_audio(self, raw: bytes, json_keys=("audio",), frame: tuple = ()) -> np.ndarray:
        """The request's float32 samples, or its frames of shape ``frame``
        (raw bytes are read as consecutive frames)."""
        ctype = self.headers.get("Content-Type", "application/json")
        if ctype.startswith("application/octet-stream"):
            return np.frombuffer(raw, np.float32).reshape(-1, *frame)
        req = json.loads(raw)
        for k in json_keys:
            if k in req:
                return np.asarray(req[k], np.float32)
        raise ValueError(f"JSON body needs one of {json_keys}")

    def do_POST(self):
        if self.path != "/recognize":
            self._json(404, {"error": "unknown path"})
            return
        try:
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            rank = len(self.row_shape)
            audio = self._read_audio(raw, ("audio",) if rank == 1 else ("audio", "features"),
                                     self.row_shape[1:])
            if audio.ndim != rank:
                raise ValueError(f"input rank {audio.ndim} != the server's rank {rank} "
                                 f"({'samples' if rank == 1 else 'frames x feature_dim'})")
            num = self.row_shape[0]
            n = min(audio.shape[0], num)
            row = np.zeros(self.row_shape, np.float32)
            row[:n] = audio[:n]
            ids, out_len = self.batcher.submit(row, n, timeout=self.request_timeout_s)
            ids = [int(i) for i in ids[:out_len]]
            resp = {"ids": ids, "num_ids": out_len}
            if audio.shape[0] > num:  # input exceeded padded capacity
                resp["truncated"] = True
                resp["consumed"] = n
            text = _decode_text(ids, self.meta)
            if text is not None:
                resp["text"] = text
            self._json(200, resp)
        except Exception as e:  # noqa: BLE001 — mapped to 400/503/500
            self._error(e)


def make_server(task, model, batch_size: int, num_samples: int,
                host: str = "127.0.0.1", port: int = 0, max_wait_ms: float = 10.0,
                request_timeout_s: float = 60.0, warmup: bool = True,
                units: list | None = None, label_type: str | None = None,
                beam_width: int = 1, lm=None, lm_weight: float = 0.3) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server over ``model`` on its device.

    ``.server_address`` has the bound port. The caller runs
    ``serve_forever()`` and, on shutdown, ``shutdown()``, ``server_close()``
    and ``.batcher.stop()``. ``warmup`` runs one zero batch before the server
    accepts traffic, so no request pays the first call's kernel build.
    ``beam_width`` above 1 decodes a CTC model with the prefix beam, a
    transducer with the transducer beam and an attention model with the
    attention beam search; ``lm`` (an ``RNNLM``) is fused into the beam at
    ``lm_weight``.
    """
    from ..serving import MicroBatcher, build_inference_fn
    from ..train.att_task import AttTaskConfig
    from ..train.transducer_task import TransducerTaskConfig

    infer = build_inference_fn(task, model, beam_width, lm=lm, lm_weight=lm_weight)
    if warmup:
        t0 = time.perf_counter()
        _, n = infer(np.zeros((batch_size, num_samples), np.float32),
                     np.zeros((batch_size,), np.int32))
        n.cpu()  # waits for the device
        print(f"warmup: ran in {time.perf_counter() - t0:.1f} s", flush=True)
    batcher = MicroBatcher(infer, batch_size, (num_samples,), max_wait_ms)
    meta = {
        "batch_size": batch_size,
        "num_samples": num_samples,
        "input_rank": 2,
        "beam_width": beam_width,
        "decode": ("greedy" if beam_width <= 1 else "attention_beam"
                   if isinstance(task, AttTaskConfig) else "transducer_beam"
                   if isinstance(task, TransducerTaskConfig) else "ctc_prefix_beam"),
        "blank_id": None if isinstance(task, AttTaskConfig) else task.model.blank_id,
        "device": str(next(model.parameters()).device),
        "units": list(units) if units else None,
        "label_type": label_type,
    }
    return _batch_server(batcher, meta, (num_samples,), host, port, request_timeout_s)


def _batch_server(batcher, meta: dict, row_shape: tuple, host: str, port: int,
                  request_timeout_s: float) -> ThreadingHTTPServer:
    """The ``/recognize`` server over ``batcher``: rows of ``row_shape``."""
    handler = type("Handler", (_Handler,), {
        "meta": meta, "batcher": batcher, "request_timeout_s": request_timeout_s,
        "row_shape": tuple(row_shape),
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.batcher = batcher
    server.meta = meta
    return server


def make_stream_server(task, model, batch_size: int, chunk_ms: float = 100.0,
                       beam_width: int = 1, lm=None, lm_weight: float = 0.3,
                       host: str = "127.0.0.1", port: int = 0, max_wait_ms: float = 10.0,
                       request_timeout_s: float = 60.0, session_timeout_s: float = 300.0,
                       warmup: bool = True, units: list | None = None,
                       label_type: str | None = None) -> ThreadingHTTPServer:
    """Build (but don't start) the streaming session server over ``model`` on its device.

    The counterpart of ``_make_stream_server`` of the JAX server, with the
    step built from the model (``streaming.build_streaming_fn``: ``batch_size``
    slots, chunks of ``chunk_ms``, the CTC prefix beam or the transducer beam
    at ``beam_width`` above 1, ``lm`` (an ``RNNLM``) fused into it). The
    worker steps at most every ``max_wait_ms`` when idle. ``warmup`` runs one
    step and, for a beam stream, one finalize before the server accepts
    traffic. Shut down as ``make_server``'s server (``.batcher.stop()``).
    """
    from ..serving import StreamingEngine
    from ..streaming import build_streaming_fn
    from ..train.transducer_task import TransducerTaskConfig

    chunk = int(round(chunk_ms * task.frontend.sample_rate / 1000.0))
    fns = build_streaming_fn(task, model, chunk, beam_width=beam_width, lm=lm,
                             lm_weight=lm_weight)
    init_fn, step_fn = fns[:2]
    finalize = fns[2] if beam_width > 1 else None
    state0 = init_fn(batch_size)
    if warmup:
        t0 = time.perf_counter()
        state, _, n = step_fn(state0, np.zeros((batch_size, chunk), np.float32),
                              np.zeros((batch_size,), np.int32))
        n.cpu()  # waits for the device
        if finalize is not None:
            finalize(state)[1].cpu()
        print(f"warmup: ran in {time.perf_counter() - t0:.1f} s", flush=True)
    final_flush = task.num_stack > 1 or task.num_skip > 1
    engine = StreamingEngine(state0, step_fn, batch_size, chunk, tick_ms=max_wait_ms,
                             session_timeout_s=session_timeout_s, finalize=finalize,
                             final_flush=final_flush)
    is_transducer = isinstance(task, TransducerTaskConfig)
    meta = {
        "streaming": True,
        "batch_size": batch_size,
        "chunk_samples": chunk,
        "beam_width": beam_width,
        "decode": ("greedy" if beam_width <= 1 else "transducer_beam" if is_transducer
                   else "ctc_prefix_beam"),
        "final_flush": final_flush,
        "blank_id": task.model.blank_id,
        "device": str(next(model.parameters()).device),
        "units": list(units) if units else None,
        "label_type": label_type,
    }
    return _stream_server(engine, meta, host, port, request_timeout_s, finalize is not None)


def _stream_server(engine, meta: dict, host: str, port: int, request_timeout_s: float,
                   final: bool) -> ThreadingHTTPServer:
    """The session API over ``engine`` (a ``StreamingEngine``); ``meta`` is
    ``/healthz``'s body and gives ``chunk_samples``; ``final``: the engine
    finalizes a beam, and ``/stream/end`` says so."""
    chunk = meta["chunk_samples"]

    class Handler(_Handler):
        def _tokens(self, toks, final: bool = False):
            resp = {"ids": [int(t) for t in toks]}
            text = _decode_text(resp["ids"], self.meta)
            if text is not None:
                resp["text"] = text
            if final:
                resp["final"] = True
            return resp

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            try:
                url = urlparse(self.path)
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if url.path == "/stream/start":
                    sid = engine.start()
                    if sid is None:
                        self._json(503, {"error": "all slots busy"})
                    else:
                        self._json(200, {"session": sid, "chunk_samples": chunk})
                    return
                sid = parse_qs(url.query).get("session", [None])[0]
                if url.path not in ("/stream/audio", "/stream/end"):
                    self._json(404, {"error": "unknown path"})
                elif sid is None:
                    raise ValueError("missing ?session= parameter")
                elif url.path == "/stream/audio":
                    audio = self._read_audio(raw)
                    if audio.ndim != 1:
                        raise ValueError(f"audio must be one channel, got rank {audio.ndim}")
                    self._json(200, self._tokens(engine.feed(sid, audio)))
                else:
                    self._json(200, self._tokens(engine.end(sid, request_timeout_s),
                                                 final=final))
            except Exception as e:  # noqa: BLE001 — mapped to 400/503/500
                self._error(e)

    handler = type("StreamHandler", (Handler,), {"meta": meta})
    server = ThreadingHTTPServer((host, port), handler)
    server.batcher = engine  # the shutdown handle, as make_server's
    server.meta = meta
    return server


def make_artifact_server(artifact_path, device="cuda", host: str = "127.0.0.1", port: int = 0,
                         max_wait_ms: float = 10.0, request_timeout_s: float = 60.0,
                         warmup: bool = True,
                         session_timeout_s: float = 300.0) -> ThreadingHTTPServer:
    """Build (but don't start) the server over an artifact of ``bin/export``
    on ``device``, as the JAX ``make_server`` serves its artifacts.

    ``ARTIFACT.json``, the contract, is ``/healthz``'s body (with the
    device). A batch artifact (``serving.load_exported``) answers
    ``/recognize`` with rows of ``num_samples`` samples, or of
    ``num_samples`` frames x ``feature_dim`` when its ``input_rank`` is 3; a
    streaming artifact (``serving.load_streaming``) gets the session API,
    ``batch_size`` slots of ``chunk_samples``. ``warmup`` runs one zero batch
    (or one step and, for a beam stream, one finalize) before the server
    accepts traffic. Shut down as ``make_server``'s server.
    """
    from ..serving import MicroBatcher, StreamingEngine, load_exported, load_streaming

    artifact_path = Path(artifact_path)
    meta = json.loads(artifact_path.with_suffix(artifact_path.suffix + ".json").read_text())
    meta = dict(meta, device=str(torch.device(device)))
    b = meta["batch_size"]
    if meta.get("streaming"):
        state0, step, finalize = load_streaming(artifact_path, device)
        chunk = meta["chunk_samples"]
        if warmup:
            t0 = time.perf_counter()
            state, _, n = step(state0, np.zeros((b, chunk), np.float32),
                               np.zeros((b,), np.int32))
            n.cpu()  # waits for the device
            if finalize is not None:
                finalize(state)[1].cpu()
            print(f"warmup: ran in {time.perf_counter() - t0:.1f} s", flush=True)
        engine = StreamingEngine(state0, step, b, chunk, tick_ms=max_wait_ms,
                                 session_timeout_s=session_timeout_s, finalize=finalize,
                                 final_flush=bool(meta.get("final_flush")))
        return _stream_server(engine, meta, host, port, request_timeout_s,
                              finalize is not None)
    infer = load_exported(artifact_path, device)
    num = meta["num_samples"]
    row_shape = (num,) if meta.get("input_rank", 2) == 2 else (num, meta["feature_dim"])
    if warmup:
        t0 = time.perf_counter()
        _, n = infer(np.zeros((b,) + row_shape, np.float32), np.zeros((b,), np.int32))
        n.cpu()  # waits for the device
        print(f"warmup: ran in {time.perf_counter() - t0:.1f} s", flush=True)
    batcher = MicroBatcher(infer, b, row_shape, max_wait_ms)
    return _batch_server(batcher, meta, row_shape, host, port, request_timeout_s)


def load_model(config_path, weights_path, device):
    """YAML config + bridged weights -> (task, model on ``device``, units, label_type).

    The config's ``model_type`` picks the model: a CTC model, a transducer,
    or an attention / joint CTC-attention seq2seq model. A ``data_root``
    config raises ``NotImplementedError``: no waveform frontend is built for
    a model trained on precomputed features; its artifact
    (``bin/export``) is served with ``bin/serve ARTIFACT``.
    """
    from ..train import att_task, ctc_task, transducer_task
    from ..utils.bridge import load_weights
    from ..utils.config import ExperimentConfig, load_task

    if ExperimentConfig.from_yaml(config_path).data_root is not None:
        raise NotImplementedError(
            f"{config_path} trains on a data_root corpus of precomputed features: export the "
            "model dir with bin/export MODEL_DIR OUT, then serve the artifact with "
            "bin/serve OUT")
    task, units, label_type = load_task(config_path)
    task_mod = {ctc_task.CTCTaskConfig: ctc_task, att_task.AttTaskConfig: att_task,
                transducer_task.TransducerTaskConfig: transducer_task}[type(task)]
    model = load_weights(weights_path, task_mod.init_model(task))
    return task, model.to(device), units, label_type


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="an artifact of bin/export (with ARTIFACT.json beside "
                    "it), or a reference-shaped YAML (configs/ls100_ctc.yml) followed by WEIGHTS")
    ap.add_argument("weights", nargs="?", default=None,
                    help=".npz or torch.save weights (utils/bridge.py) for the CONFIG")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=12.0,
                    help="padded audio seconds per utterance")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--beam-width", type=int, default=1,
                    help="CTC models: prefix beam search above 1; attention models: "
                         "attention beam search above 1; transducer models: the "
                         "transducer beam above 1 (greedy at 1)")
    ap.add_argument("--lm-dir", default=None,
                    help="RNN-LM dir from bin.train_lm: shallow fusion in the beam")
    ap.add_argument("--lm-weight", type=float, default=0.3)
    ap.add_argument("--stream", action="store_true",
                    help="serve live sessions (/stream/start, /stream/audio, /stream/end) "
                         "over --batch slots")
    ap.add_argument("--chunk-ms", type=float, default=100.0,
                    help="--stream: audio per streaming step (a multiple of the 10 ms hop)")
    ap.add_argument("--session-timeout-s", type=float, default=300.0,
                    help="--stream: reclaim slots abandoned without /stream/end")
    ap.add_argument("--request-timeout-s", type=float, default=60.0)
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if args.weights is None:  # bin/serve ARTIFACT
        server = make_artifact_server(args.config, device, args.host, args.port,
                                      args.max_wait_ms, args.request_timeout_s,
                                      warmup=not args.no_warmup,
                                      session_timeout_s=args.session_timeout_s)
        m = server.meta
        kind = (f"streaming, {m['batch_size']} slots, chunk {m['chunk_samples']} samples"
                if m.get("streaming") else f"batch {m['batch_size']}, beam {m['beam_width']}")
        host, port = server.server_address[:2]
        print(f"serving {args.config} on http://{host}:{port} ({kind}, platforms "
              f"{m['platforms']}, {args.device})", flush=True)
        _serve(server)
        return
    task, model, units, label_type = load_model(args.config, args.weights, device)
    lm = None
    if args.lm_dir:
        from .train_lm import load_lm

        lm = load_lm(args.lm_dir, device)
    if args.stream:
        server = make_stream_server(task, model, args.batch, args.chunk_ms, args.beam_width,
                                    lm, args.lm_weight, args.host, args.port, args.max_wait_ms,
                                    args.request_timeout_s, args.session_timeout_s,
                                    warmup=not args.no_warmup, units=units,
                                    label_type=label_type)
        what = f"{args.batch} stream slots, chunk {server.meta['chunk_samples']} samples"
    else:
        num_samples = int(args.seconds * task.frontend.sample_rate)
        server = make_server(task, model, args.batch, num_samples, args.host, args.port,
                             args.max_wait_ms, args.request_timeout_s,
                             warmup=not args.no_warmup, units=units, label_type=label_type,
                             beam_width=args.beam_width, lm=lm, lm_weight=args.lm_weight)
        what = f"batch {args.batch}, {num_samples} samples"
    host, port = server.server_address[:2]
    print(f"serving {args.config} on http://{host}:{port} ({what}, beam {args.beam_width}, "
          f"{args.device})", flush=True)
    _serve(server)


def _serve(server) -> None:
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.batcher.stop()


if __name__ == "__main__":
    main()
