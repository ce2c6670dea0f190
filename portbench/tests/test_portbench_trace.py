"""The traced window's arithmetic on a made-up timeline."""

import pytest

from portbench import trace

RECORD = {
    "window_ns": (0, 1000),
    # two overlapping kernels, a copy beside the second, one past the window
    "kernels": [("fwd_walk<...>", 100, 200), ("bwd_walk<...>", 250, 150),
                ("Memcpy HtoD (Pinned -> Device)", 300, 100), ("nccl AllReduce", 900, 300)],
    "spans": [("train_step", 60, 600), ("h2d", 600, 700), ("train_step", 700, 950)],
}


def test_busy_is_the_union_of_intervals():
    on, window = trace.busy(RECORD)
    assert window == pytest.approx(1e-6)
    assert on == pytest.approx((400 - 100 + 1000 - 900) / 1e9)


def test_launches_leave_out_copies():
    assert trace.launches(RECORD) == 3
    assert trace.kernel_seconds(RECORD, "walk") == pytest.approx(350 / 1e9)


def test_idle_gaps_are_named_by_the_innermost_span():
    out = trace.breakdown(RECORD)
    assert out["device_ops"][0] == ["nccl AllReduce", 300 / 1e9]
    gaps = {name: s for name, s in out["idle_gaps"]}
    assert out["idle_gaps"][0] == ["h2d", 500 / 1e9]  # 400..900: the host was copying at 650
    assert gaps["outside the benchmark's spans"] == pytest.approx(100 / 1e9)  # 0..100


def test_readers_on_a_made_up_run():
    from portbench import readers, run

    exp = {"encoder_type": "blstm", "num_units": 512, "num_layers": 5, "num_stack": 3,
           "num_skip": 3, "input_size": 40, "use_energy": False, "use_delta": True,
           "compute_dtype": "bfloat16", "model_type": "ctc"}
    rec = {"trace": RECORD, "ran": [0, 0], "batches": [[[192240] * 4, [60] * 4]], "exp": exp,
           "num_classes": 28, "elapsed_s": 1.0, "world": 1}
    assert readers.launches_per_step(rec) == 1.5
    assert readers.idle_share(rec) == pytest.approx(60.0)  # busy 100..400 and 900..1000
    ops = 2 * readers.work.walk_work(exp, [192240] * 4, backward=False)[0]  # two steps
    assert readers.fwd_walk_roofline(rec) == pytest.approx(
        100 * ops / readers.work.PEAK_TF32_FLOPS / 200e-9)  # fwd_walk ran 200 ns
    assert run.load_reader("train_mfu").read(rec) == pytest.approx(readers.train_mfu(rec))
    assert readers.fwd_walk_roofline({"trace": None}) is None
    serving = {"trace": RECORD, "serving": True, "infer_calls": [(0.04, [192240])], "exp": exp}
    assert readers.fwd_walk_roofline(serving) > 0
