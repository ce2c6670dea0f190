"""The plain reference against the port at toy sizes on the CPU, and the
harness's whole run of each toy cell coming out correct."""

import pytest
import torch

from portbench import run, traffic, weights
from portbench.reference import blstm, ctc_model, frontend, quant
from portbench.tests import toy

CPU = torch.device("cpu")


def port_ctc(cell):
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

    exp = experiment_from_dict(cell.exp)
    return ctc_task, exp.task(cell.config["num_classes"])


@pytest.fixture
def batch():
    mix = {"rows": 3, "base_seconds": [1.2, 1.4], "distinct_batches": 1,
           "row_spread_seconds": 0.5}
    return traffic.train_batches(mix, 28, 15.0, 123, CPU)[0]


def test_frontend_matches_the_port(batch):
    cell = toy.cell("ls100_ctc_bf16.train_b128")
    ctc_task, task = port_ctc(cell)
    want, want_len = ctc_task.device_pipeline(task, batch)
    got, got_len = frontend.features(batch["inputs"], batch["input_len"], cell.exp)
    assert torch.equal(got_len, want_len.long())
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_model_loss_and_gradients_match_the_port(batch, dtype, atol):
    cell = toy.cell("ls100_ctc_bf16.train_b128")
    cell.exp["compute_dtype"] = dtype
    ctc_task, task = port_ctc(cell)
    p = weights.make(weights.shapes(ctc_task, task), 0.1, 5, CPU)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    want, _ = ctc_task.forward_loss(leaves, task, batch, train=False)
    want_g = torch.autograd.grad(want, list(leaves.values()))
    mine = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    got = (ctc_model.row_sum(mine, cell.exp, batch, quant.Quant(dtype)) / 3
           + ctc_model.weight_decay(mine, cell.exp["weight_decay"]))
    got_g = torch.autograd.grad(got, list(mine.values()))
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-5 if dtype == "float32" else 1e-3)
    for k, a, b in zip(p, got_g, want_g):
        assert torch.allclose(a, b, atol=atol * float(b.abs().max()), rtol=0), k


def test_flip_valid_reverses_each_prefix():
    x = torch.arange(8.0).reshape(2, 4, 1)
    got = blstm.flip_valid(x, torch.tensor([2, 4]))[..., 0]
    assert got.tolist() == [[1, 0, 2, 3], [7, 6, 5, 4]]


def test_float8_rounds_coarser_than_bf16():
    x = torch.linspace(-3, 3, 1001)
    b16, f8 = quant.Quant("bfloat16").value(x), quant.Quant("float8").value(x)
    assert (b16 - x).abs().max() < (f8 - x).abs().max() < 0.2
    g = torch.ones_like(x, requires_grad=True)
    quant.Quant("bfloat16")(g).backward(torch.full_like(x, 1.001))
    assert torch.equal(g.grad, torch.ones_like(x))  # the cotangent rounds to bf16 too


@pytest.mark.parametrize("name", ["ls100_ctc_bf16.train_b128",
                                  "ls960_joint_bpe_bf16.train_b128",
                                  "ls100_ctc_bf16.serve_greedy"])
def test_toy_cell_runs_correct(name):
    cell = toy.cell(name)
    out = run.execute(cell, 2**31 + 3, 1.5, False, CPU, log=lambda *a, **k: None)
    line = run.result_line(cell, out, False, {})
    assert line["correct"], line["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
