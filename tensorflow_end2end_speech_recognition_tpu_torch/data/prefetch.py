"""Background batch prefetching: overlap host batch assembly with device work.

A copy of ``tensorflow_end2end_speech_recognition_tpu/data/prefetch.py``:
batches are assembled on a daemon thread ``depth`` batches ahead while the
previous train step runs on the card; exceptions from the producer re-raise
at the consumer, and a consumer that stops early stops the producer.
"""

from __future__ import annotations

import queue
import threading

_SENTINEL = object()


def prefetch(iterable, depth: int = 2):
    """Iterate ``iterable`` with up to ``depth`` items prepared ahead."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    errors: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer is gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            errors.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
        # drain so a worker blocked between the stop check and a full queue
        # can finish its final put and exit
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
