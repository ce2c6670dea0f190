"""The yardstick's arithmetic on known shapes."""

import pytest

from portbench import work

LS100 = {"encoder_type": "blstm", "num_units": 512, "num_layers": 5, "num_stack": 3,
         "num_skip": 3, "input_size": 40, "use_energy": False, "use_delta": True,
         "compute_dtype": "bfloat16"}


def samples_for(frames_out: int, skip: int = 3) -> int:
    return 400 + (frames_out * skip - 1) * 160


def test_walk_flops_b128_t400_h512():
    exp = dict(LS100, num_layers=1)
    ops, nbytes = work.walk_work(exp, [samples_for(400)] * 128, backward=False)
    assert ops == pytest.approx(214.7e9, rel=1e-3)
    assert ops == 2 * 512 * 2048 * 400 * 128 * 2
    # bytes: bf16 xproj read, ys and cs written, both directions, and Wh once
    assert nbytes == (4 * 512 + 512 + 512) * 2 * 400 * 128 * 2 + 2 * 512 * 2048 * 4


def test_backward_walk_has_the_forward_product():
    exp = dict(LS100, num_layers=1)
    fwd, _ = work.walk_work(exp, [samples_for(400)] * 128, backward=False)
    bwd, _ = work.walk_work(exp, [samples_for(400)] * 128, backward=True)
    assert bwd == fwd


def test_frames_and_pyramid():
    assert work.frames(400) == 1 and work.frames(399) == 0 and work.frames(16000) == 98
    joint = dict(LS100, encoder_type="pyramidal_blstm", num_pyramid_levels=2)
    assert work.layer_frames(joint, samples_for(433)) == [433, 217, 109, 109, 109, 109]
    assert work.layer_frames(LS100, samples_for(433)) == [433] * 6


def test_roofline_takes_the_larger_bound():
    assert work.roofline_share(495e12, 0.0, 2.0, work.PEAK_TF32_FLOPS) == pytest.approx(50.0)
    assert work.roofline_share(0.0, 3.35e12, 4.0, work.PEAK_TF32_FLOPS) == pytest.approx(25.0)


def test_train_step_ops_count_the_backward_twice():
    exp = dict(LS100, model_type="ctc")
    n = samples_for(400)
    front = work.frontend_ops(exp, n)
    step = work.train_step_ops(exp, 28, [n], [60])
    fwd = work.encoder_forward_ops(exp, n) + 2.0 * 400 * 1024 * 29
    assert step == pytest.approx(front + 3 * fwd)
