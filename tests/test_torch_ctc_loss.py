"""The port's CTC loss (``ops/ctc.py``) vs the JAX package on the CPU.

``ctc_loss_plain`` (the plain version of the fused loss + gradient kernel)
is held against ``ops.ctc.ctc_loss(impl="scan")`` with its ``jax.grad`` and
against the Pallas kernel ``_ctc_fwd_impl`` in interpret mode;
``ctc_loss_fwd_only_plain`` against ``ctc_loss_pallas_fwd_only`` in
interpret mode. Tolerances in float32: 1e-4 absolute on losses of a few tens
(a sum of T log terms), 1e-5 on gradients (probabilities in [-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.ops import ctc as jctc
from tensorflow_end2end_speech_recognition_tpu.ops.pallas.ctc_kernel import (
    _ctc_fwd_impl,
    ctc_loss_pallas_fwd_only,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_loss,
    ctc_loss_fwd_bwd,
    ctc_loss_fwd_only,
    ctc_loss_fwd_only_plain,
    ctc_loss_plain,
)

torch.set_num_threads(1)

LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
B, T, C = 5, 12, 6
BLANK = C - 1


def _case(seed=0, impossible=False):
    """Repeated labels, an empty label row and ragged logit lengths."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, C) * 2.0).astype(np.float32)
    labels = np.asarray([[1, 1, 2, -1], [-1, -1, -1, -1], [3, 4, 0, 2],
                         [0, 0, 0, 0], [2, -1, -1, -1]], np.int32)
    label_len = np.asarray([3, 0, 4, 4, 1], np.int32)
    logit_len = np.asarray([T, 7, 9, T - 1, 1], np.int32)
    if impossible:  # four repeats need 7 frames; row 3 gets 5
        logit_len[3] = 5
    return logits, logit_len, labels, label_len


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_plain_matches_scan_and_its_grad():
    arrays = _case(seed=1)
    j = list(map(jnp.asarray, arrays))
    want_loss = jctc.ctc_loss(*j, blank_id=BLANK, impl="scan")
    want_grad = jax.grad(lambda x: jnp.sum(jctc.ctc_loss(x, *j[1:], blank_id=BLANK,
                                                         impl="scan")))(j[0])
    loss, grad = ctc_loss_plain(*_torch(arrays), BLANK)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **LOSS_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **GRAD_TOL)


@pytest.mark.parametrize("impossible", [False, True])
def test_plain_matches_pallas_kernels(impossible):
    arrays = _case(seed=2, impossible=impossible)
    j = list(map(jnp.asarray, arrays))
    want_loss, want_grad = _ctc_fwd_impl(*j, BLANK, interpret=True)
    want_fwd = ctc_loss_pallas_fwd_only(*j, BLANK, interpret=True)
    loss, grad = ctc_loss_plain(*_torch(arrays), BLANK)
    fwd = ctc_loss_fwd_only_plain(*_torch(arrays), BLANK)
    if impossible:  # a finite loss >= 1e20 on both sides, the others as before
        for x in (want_loss, want_fwd, loss.numpy(), fwd.numpy()):
            assert np.isfinite(x).all() and x[3] >= 1e20
        feasible = [0, 1, 2, 4]
        np.testing.assert_allclose(loss.numpy()[feasible], np.asarray(want_loss)[feasible],
                                   **LOSS_TOL)
        np.testing.assert_allclose(fwd.numpy()[feasible], np.asarray(want_fwd)[feasible],
                                   **LOSS_TOL)
        np.testing.assert_allclose(grad.numpy()[feasible], np.asarray(want_grad)[feasible],
                                   **GRAD_TOL)
        return
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **LOSS_TOL)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want_fwd), **LOSS_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **GRAD_TOL)
    assert not np.any(grad.numpy()[4, 1:])  # pad frames get no gradient


def test_ctc_loss_autograd_and_counters():
    arrays = _case(seed=3)
    logits, logit_len, labels, label_len = _torch(arrays)
    counts = (ctc_loss_fwd_bwd.launches, ctc_loss_fwd_only.launches)
    x = logits.clone().requires_grad_(True)
    g = torch.linspace(0.5, 2.0, B)
    (ctc_loss(x, logit_len, labels, label_len) * g).sum().backward()  # blank defaults to C-1
    _, grad = ctc_loss_plain(logits, logit_len, labels, label_len, BLANK)
    torch.testing.assert_close(x.grad, g[:, None, None] * grad, atol=0, rtol=0)
    nll = ctc_loss(logits, logit_len, labels, label_len, BLANK, need_grad=False)
    torch.testing.assert_close(nll, ctc_loss_fwd_only_plain(logits, logit_len, labels,
                                                            label_len, BLANK), atol=0, rtol=0)
    assert (ctc_loss_fwd_bwd.launches, ctc_loss_fwd_only.launches) == counts  # CPU: no kernel


def test_need_grad_false_cannot_be_differentiated():
    logits, logit_len, labels, label_len = _torch(_case(seed=4))
    x = logits.clone().requires_grad_(True)
    nll = ctc_loss(x, logit_len, labels, label_len, BLANK, need_grad=False)
    with pytest.raises(RuntimeError, match="need_grad=False"):
        nll.sum().backward()


def test_unported_impls_and_bad_inputs_raise():
    logits, logit_len, labels, label_len = _torch(_case(seed=5))
    for impl in ("scan", "optax", "pallas"):
        with pytest.raises(NotImplementedError):
            ctc_loss(logits, logit_len, labels, label_len, BLANK, impl=impl)
    # bf16 logits are cast to float32 before the kernel, as ctc_loss_pallas casts them
    low = logits.bfloat16()
    torch.testing.assert_close(ctc_loss(low, logit_len, labels, label_len, BLANK),
                               ctc_loss(low.float(), logit_len, labels, label_len, BLANK),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ctc_loss(logits.half(), logit_len, labels, label_len, BLANK)
    with pytest.raises(ValueError, match="blank_id"):
        ctc_loss(logits, logit_len, labels, label_len, C)
    with pytest.raises(ValueError, match="integer"):
        ctc_loss(logits, logit_len.float(), labels, label_len, BLANK)
    with pytest.raises(ValueError, match="contiguous"):
        ctc_loss(logits.transpose(0, 1).contiguous().transpose(0, 1), logit_len, labels,
                 label_len, BLANK)
