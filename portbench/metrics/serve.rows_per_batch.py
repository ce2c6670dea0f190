"""Requests answered in the window per batch the micro-batcher ran
(``serving.MicroBatcher.batches_run``): the serving front's batching."""


def read(rec: dict):
    if not rec.get("batches_run"):
        return None
    return rec["completed"] / rec["batches_run"]
