#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phases 71-73 (the model axes and pipeline stages)
alone on the card, for the jobs of ``AXES_JOBS`` named on the command line.

    python3 probes/model_axes.py "73 pp2" "73 pp4" "73 dp2 x pp2" "73 pp2 x tp2"

Builds the kernels, then calls ``chip_smoke.run_model_axes`` with
``AXES_JOBS`` narrowed to the named jobs (the spawned ranks get the same
list); the two fits of phases 72-73 and ``bin/eval`` of their checkpoints
always run. On a machine with four or more cards the nccl jobs of phase
72-73 run too, one rank per card. Prints the phases' lines and the launch
counts. Imports no JAX.
"""

import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    import chip_smoke as cs
    from tensorflow_end2end_speech_recognition_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build()
    build.load_library()
    cs.set_full_fp32()
    gpu = cs.gpu_name_and_power()
    print(gpu, flush=True)
    only = tuple(sys.argv[1:])
    cs.AXES_JOBS = tuple(j for j in cs.AXES_JOBS if j[0] in only)
    with tempfile.TemporaryDirectory() as work:
        counts, numbers = cs.run_model_axes(torch.device("cuda", 0), gpu, Path(work), t0,
                                            {"AXES_JOBS": cs.AXES_JOBS})
    print("counts", counts)
    print("total", time.perf_counter() - t0)
