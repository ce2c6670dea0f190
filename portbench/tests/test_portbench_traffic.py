"""The generator: a seed fixes the inputs; every seed gets the same sizes."""

import numpy as np
import pytest
import torch

from portbench import traffic

MIX = {"rows": 8, "base_seconds": [1.0, 2.0], "distinct_batches": 3, "row_spread_seconds": 0.5}
SERVE = {"rate_per_s": 50.0, "lengths": {"median_seconds": 6.0, "sigma": 0.65,
                                         "min_seconds": 1.5, "max_seconds": 20.0},
         "audio_pool_seconds": 30.0, "row_seconds": 20.0}
CPU = torch.device("cpu")


def test_same_seed_same_batches():
    a = traffic.train_batches(MIX, 28, 15.0, 2**31 + 11, CPU)
    b = traffic.train_batches(MIX, 28, 15.0, 2**31 + 11, CPU)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_seeds_share_the_sizes():
    a = traffic.train_batches(MIX, 28, 15.0, 1, CPU)
    b = traffic.train_batches(MIX, 28, 15.0, 2**33 + 7, CPU)
    sizes = lambda bs: sorted(sorted(x["input_len"].tolist()) for x in bs)  # noqa: E731
    assert sizes(a) == sizes(b)
    assert not torch.equal(a[0]["inputs"][:, :100], b[0]["inputs"][:, :100])
    for batch in a:
        n = batch["input_len"]
        assert batch["inputs"].shape[1] == int(n.max())
        assert (n.max() - n.min()) / 16000 < 0.5
        assert torch.equal(batch["label_len"],
                           torch.tensor([traffic.labels_for(int(x), 15.0) for x in n],
                                        dtype=torch.int32))
        for row, m in zip(batch["inputs"], n):
            assert not row[int(m):].any()


def test_requests_same_set_other_order():
    a = traffic.Requests(SERVE, 5, 4.0)
    b = traffic.Requests(SERVE, 2**32 + 5, 4.0)
    assert len(a) == len(b) == 200
    assert sorted(a.samples) == sorted(b.samples)
    gaps = np.round(traffic.arrival_gaps(50.0, 200), 9)
    for r in (a, b):
        assert set(np.round(np.diff(r.due), 9)) <= set(gaps)
    assert not np.array_equal(a.samples, b.samples)
    assert np.all(np.diff(a.due) > 0) and a.due[0] == pytest.approx(0.0)
    assert 1.5 * 16000 <= a.samples.min() and a.samples.max() <= 20 * 16000
    row = a.row(3)
    assert row.shape == (320000,) and not row[a.samples[3]:].any()
    again = traffic.Requests(SERVE, 5, 4.0)
    assert np.array_equal(again.row(3), row)


def test_sample_keeps_the_longest():
    r = traffic.Requests(SERVE, 9, 4.0)
    pick = r.sample(9, 10, range(len(r)))
    assert len(pick) == 10 and int(np.argmax(r.samples)) in pick
    assert pick == r.sample(9, 10, range(len(r)))
