#!/usr/bin/env python3
"""How far the VGG stack's convolutions on the card are from float64.

    python3 probes/vgg_conv_precision.py      # on a machine with a CUDA card

For each of the four 3x3 SAME convolutions of the VGG encoder at a 1 s
utterance's shapes (3 -> 64 and 64 -> 64 channels over 98 x 41, 64 -> 128
and 128 -> 128 over 49 x 21; a batch of 2), computes the output and the
gradients of the input and the weight for a random output gradient in
float64 on the CPU, and prints the largest error, relative to the largest
entry, of float32 on the CPU, of cuDNN on the card (as the port runs it:
TF32 off), of cuDNN restricted to deterministic algorithms, and of
PyTorch's convolution without cuDNN. Imports no JAX.
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

SHAPES = ((3, 64, 98, 41), (64, 64, 98, 41), (64, 128, 49, 21), (128, 128, 49, 21))
VARIANTS = (("cpu float32", "cpu", {}), ("cuda cuDNN", "cuda", {}),
            ("cuda cuDNN deterministic", "cuda", {"deterministic": True}),
            ("cuda without cuDNN", "cuda", {"enabled": False}))


def conv_and_grads(x, w, gy, device, dtype, **cudnn_flags):
    """(y, dx, dw) of a SAME 3x3 convolution, as float64 on the CPU."""
    old = {k: getattr(torch.backends.cudnn, k) for k in cudnn_flags}
    for k, v in cudnn_flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        xx = x.to(device, dtype).requires_grad_(True)
        ww = w.to(device, dtype).requires_grad_(True)
        y = F.conv2d(xx, ww, padding=1)
        dx, dw = torch.autograd.grad(y, (xx, ww), gy.to(device, dtype))
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)
    return [t.detach().double().cpu() for t in (y, dx, dw)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("vgg_conv_precision: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    for cin, cout, t, f in SHAPES:
        x = torch.relu(torch.randn(2, cin, t, f, generator=g))
        w = torch.randn(cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5
        gy = torch.randn(2, cout, t, f, generator=g)
        exact = conv_and_grads(x, w, gy, "cpu", torch.float64)
        for name, device, flags in VARIANTS:
            got = conv_and_grads(x, w, gy, device, torch.float32, **flags)
            errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, exact)]
            print(f"conv {cin}->{cout} [{t}x{f}] {name}: rel err y {errs[0]:.2e} dx "
                  f"{errs[1]:.2e} dw {errs[2]:.2e}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
