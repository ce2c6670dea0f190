"""The check fails what it must: the control (the reference one precision
down, in the program's place) and each fault a cell can have, planted in
the timed path of a whole toy run on the CPU."""

import pytest
import torch

from portbench import correct, run, traffic
from portbench.drivers import serve, train
from portbench.reference import full_fp32
from portbench.tests import toy

CPU = torch.device("cpu")
TRAIN = "ls100_ctc_bf16.train_b128"
JOINT = "ls960_joint_bpe_bf16.train_b128"
SERVE = "ls100_ctc_bf16.serve_greedy"
DP = "ls100_ctc_bf16.train_dp4"


@pytest.mark.parametrize("name,fault,mix", [
    (TRAIN, "frozen", {}), (TRAIN, "half_batch", {}),
    (JOINT, "frozen", {}), (JOINT, "half_batch", {}),
    (SERVE, "altered_token", {}),
    (DP, "no_exchange", {"ranks": 2}), (DP, "frozen", {"ranks": 2}),
    (DP, "half_batch", {"ranks": 2}),
])
def test_fault_comes_out_incorrect(name, fault, mix):
    cell = toy.cell(name, **mix)
    out = run.execute(cell, 2**31 + 17, 1.0, False, CPU, faults=(fault,),
                      log=lambda *a, **k: None)
    line = run.result_line(cell, out, False, {})
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", [TRAIN, JOINT])
def test_training_control_fails_the_limits(name):
    cell = toy.cell(name)
    seed = 2**31 + 29
    batches = train.batches_of(cell, seed, CPU)
    ref = train.reference_readings(cell, seed, batches, CPU)
    ctl = train.reference_readings(cell, seed, batches, CPU, kind="float8")
    gaps = correct.train_gaps(ctl, ref)
    assert any(gaps[k] > cell.limits[k] for k in gaps), gaps


def test_serving_control_fails_the_limit():
    cell = toy.cell(SERVE)
    seed = 2**31 + 31
    reqs = traffic.Requests(cell.mix, seed, 2.0)
    idx = reqs.sample(seed, cell.mix["check_requests"], range(len(reqs)))
    low, low_len = serve.reference_logits(cell, seed, reqs, idx, CPU, kind="float8")
    ctl = [serve.greedy(x, n, cell.config["num_classes"]) for x, n in zip(low, low_len)]
    gaps = serve.served_gaps(cell, seed, reqs, idx, ctl, CPU)
    assert max(gaps) > cell.limits["token_gap"], gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", [TRAIN, JOINT])
def test_training_control_fails_at_the_cells_size(card, name):
    cell = run.Cell(name)
    seed = 2**31 + 37
    batches = train.batches_of(cell, seed, card)
    with full_fp32():
        ref = train.reference_readings(cell, seed, batches, card)
        ctl = train.reference_readings(cell, seed, batches, card, kind="float8")
    gaps = correct.train_gaps(ctl, ref)
    assert any(gaps[k] > cell.limits[k] for k in gaps), gaps


def test_served_gap_is_zero_on_the_greedy_path_and_large_off_it():
    logits = torch.tensor([[0.0, 5.0, 1.0], [0.0, 1.0, 5.0], [4.0, 0.0, 1.0],
                           [0.0, 0.0, 6.0]]).numpy()
    assert correct.served_gap(logits, 4, [1, 0], blank=2) == 0.0
    assert correct.served_gap(logits, 4, [1, 1], blank=2) == pytest.approx(4.0)
    assert correct.served_gap(logits, 4, [0, 1, 0, 1, 0], blank=2) == float("inf")
