"""Mean host time of one call of the inference function the batcher wraps
(``serving.build_inference_fn``), up to its results on the host."""


def read(rec: dict):
    calls = rec.get("infer_calls")
    if not calls:
        return None
    return 1e3 * sum(s for s, _ in calls) / len(calls)
