"""The yardstick: frames, operations and bytes from shapes, and the card's peaks.

Everything here is computed from the configuration and the generated
inputs, never read from the program, so a change to how the program
computes a layer leaves the work it is held to where it was.

- A recurrent walk's work is its recurrent product, ``h @ Wh``: 2·H·4H
  floating-point operations per valid row, frame and direction, the same
  for the forward walk and for the backward walk's ``dgates @ Wh^T``. Its
  bytes are each stream read once and each stream written once, over valid
  frames only. ``Wh`` and the carried ``h`` are float32 in every compute
  type, so the product is held to the TF32 dense peak whatever implements
  it.
- Model operations count the forward once and the backward twice, nothing
  recomputed; the frontend has no parameters and counts once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

SAMPLE_RATE = 16000
FRAME_LENGTH = 400  # 25 ms
FRAME_STEP = 160  # 10 ms
FFT_BINS = 257  # 512-point real DFT


def frames(samples: int) -> int:
    """10 ms frames of 25 ms in ``samples`` valid samples."""
    return max(0, 1 + (samples - FRAME_LENGTH) // FRAME_STEP)


def stacked(n: int, num_skip: int) -> int:
    return -(-n // num_skip)


def reduces_after(exp: dict, layer: int) -> bool:
    """Whether the pyramid halves T after ``layer``: after each of its first
    ``num_pyramid_levels`` layers, by default all but the last."""
    if exp["encoder_type"] not in ("pyramidal_blstm", "pblstm"):
        return False
    levels = exp.get("num_pyramid_levels")
    return layer < (exp["num_layers"] - 1 if levels is None else levels)


def layer_frames(exp: dict, samples: int) -> list:
    """Valid frames of one row at each encoder layer, then at the encoder's
    output (the last entry): after the stacking's skip, halved (ceil) after
    each of the pyramid's levels."""
    t = stacked(frames(samples), exp.get("num_skip", 1))
    out = []
    for layer in range(exp["num_layers"]):
        out.append(t)
        if reduces_after(exp, layer):
            t = -(-t // 2)
    return out + [t]


def encoder_out_frames(exp: dict, samples: int) -> int:
    return layer_frames(exp, samples)[-1]


def stream_bytes(exp: dict) -> int:
    return 2 if exp.get("compute_dtype") == "bfloat16" else 4


def walk_work(exp: dict, rows_samples, backward: bool, training: bool = True) -> tuple:
    """(operations, bytes) of every walk of one batch through the encoder:
    the forward walks (#1), or with ``backward`` the backward walks (#2).

    Forward bytes: xproj (4H) read, ys (H) written, and in training the
    cell-state stream cs (H) written, per valid row, frame and direction;
    ``Wh`` read once per layer and direction. Backward bytes: xproj (4H),
    ys (H), cs (H) and the cotangent of ys (H) read, dxproj (4H) written."""
    h = exp["num_units"]
    s = stream_bytes(exp)
    dirs = 2
    valid = [0] * exp["num_layers"]
    for n in rows_samples:
        for i, t in enumerate(layer_frames(exp, n)[:-1]):
            valid[i] += t
    frames_total = sum(valid)
    ops = 2.0 * h * 4 * h * frames_total * dirs
    if backward:
        per = (4 * h + h + h + h) * s + 4 * h * s
    else:
        per = (4 * h + h) * s + (h * s if training else 0)
    weights = exp["num_layers"] * dirs * h * 4 * h * 4
    return ops, float(per * frames_total * dirs + weights)


def roofline_share(ops: float, nbytes: float, seconds: float, peak_flops: float) -> float:
    """Per cent of the time the card would need at its peaks, the larger of
    the two bounds, over the measured kernel time."""
    return 100.0 * max(ops / peak_flops, nbytes / PEAK_HBM_BYTES) / seconds


def frontend_ops(exp: dict, samples: int) -> float:
    """The two windowed real DFTs as products, the power, and the mel bank."""
    n = frames(samples)
    mels = exp.get("input_size", 40)
    return n * (2 * 2.0 * FRAME_LENGTH * FFT_BINS + 3 * FFT_BINS + 2.0 * FFT_BINS * mels)


def input_dim(exp: dict) -> int:
    base = exp.get("input_size", 40) + (1 if exp.get("use_energy", True) else 0)
    base *= 3 if exp.get("use_delta", True) else 1
    return base * exp.get("num_stack", 1) * (2 * exp.get("splice", 0) + 1)


def encoder_forward_ops(exp: dict, samples: int) -> float:
    """One row's encoder forward: each layer's input projection and its
    recurrent product, both directions, over valid frames."""
    h = exp["num_units"]
    d = input_dim(exp)
    ops = 0.0
    for i, t in enumerate(layer_frames(exp, samples)[:-1]):
        ops += 2 * t * (2.0 * d * 4 * h + 2.0 * h * 4 * h)
        d = 2 * h * (2 if reduces_after(exp, i) else 1)
    return ops


def decoder_forward_ops(exp: dict, num_classes: int, t_enc: int, labels: int) -> float:
    """One row's attention decoder over ``labels + 1`` steps: the hoisted
    keys, and per step the LSTM cell, the hybrid location read (query,
    the convolution over the last alignment and its projection, the
    energies and the context) and the output projection."""
    he = 2 * exp["num_units"]
    hd = exp["decoder_num_units"]
    e = exp["embedding_dim"]
    a = exp["attention_dim"]
    ch = exp.get("attention_conv_num_channels", 10)
    w = exp.get("attention_conv_width", 101)
    v = num_classes + 2
    steps = labels + 1
    keys = 2.0 * t_enc * he * a
    per_step = (2.0 * (e + he) * 4 * hd + 2.0 * hd * 4 * hd + 2.0 * hd * a
                + t_enc * (2.0 * w * ch + 2.0 * ch * a + 2.0 * a + 2.0 * he)
                + 2.0 * (hd + he) * v)
    return keys + steps * per_step


def train_step_ops(exp: dict, num_classes: int, rows_samples, rows_labels) -> float:
    """Model operations of one train step over the batch: the frontend once,
    the encoder, heads and decoder three times (forward, and the backward's
    two products)."""
    he = 2 * exp["num_units"]
    joint = exp.get("model_type") in ("attention", "joint_ctc_attention")
    fwd = front = 0.0
    for n, u in zip(rows_samples, rows_labels):
        front += frontend_ops(exp, n)
        fwd += encoder_forward_ops(exp, n)
        t_enc = encoder_out_frames(exp, n)
        if joint:
            fwd += decoder_forward_ops(exp, num_classes, t_enc, u)
            if exp.get("model_type") == "joint_ctc_attention":
                fwd += 2.0 * t_enc * he * (num_classes + 1)
        else:
            fwd += 2.0 * t_enc * he * (num_classes + 1)
    return front + 3.0 * fwd


def mfu(ops: float, seconds: float, chips: int = 1) -> float:
    return 100.0 * ops / (seconds * chips * PEAK_BF16_FLOPS)
