#!/usr/bin/env python3
"""Compares the clip's global norm under data parallelism and under ZeRO-3, bit for bit.

    python3 probes/clip_norm_bits.py [--trees N]

Starts a world of 2 ``gloo`` ranks on the CPU. On N seeded gradient trees
with the leaves of a 5 x BLSTM-320 CTC model (ls100_ctc's encoder, 29
classes), each leaf normal values at a scale of its own in 1e-6 .. 1e2, it
computes the float32 norm twice: over the whole tree, as a data-parallel
step does, and over each rank's ZeRO-3 blocks (``fsdp_partition_specs``)
summed over the ranks, as a sharded step does. It does so with the
package's ``train/optimizer.global_norm`` (squares summed in float64) and
with float32 sums in the same orders, and prints for each how many trees
give two different float32 norms, with the bits of the first few. A norm
that differs between the two placements clips the same gradients by
different factors, and Adam's first steps carry a last-bit difference into
the weights whose gradients are near its epsilon. CPU only; imports no JAX.
"""

from __future__ import annotations

import os
import struct
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = str(Path(__file__).resolve().parents[1])


def norm_float32(tree: dict, mesh=None, specs=None) -> torch.Tensor:
    """``global_norm`` with float32 sums: whole leaves in tree order, or each
    split group's blocks summed on the rank, then over the ranks."""
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.mesh import all_reduce_flat

    if mesh is None:
        return torch.sqrt(sum(x.square().sum() for x in tree.values()))
    zero = torch.zeros((), dtype=torch.float32)
    parts = {}
    for k, x in tree.items():
        axes = mesh.split_axes(a for a in specs[k] if a is not None)
        parts[axes] = parts.get(axes, zero) + x.square().sum()
    total = zero
    for axes in sorted(parts):
        (part,) = all_reduce_flat(mesh.along(*axes), [parts[axes]])
        total = total + part
    return torch.sqrt(total)


def bits(x: torch.Tensor) -> str:
    return f"{struct.unpack('<I', struct.pack('<f', float(x)))[0]:#010x}"


def run(rank: int, store: str, trees: int, out: str) -> None:
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
    from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
        fsdp_partition_specs,
        make_grid,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.fsdp import shard_tree
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import global_norm

    mesh = make_grid({"data": 2}, device="cpu")
    task = ctc_task.CTCTaskConfig(model=CTCConfig(
        encoder=EncoderConfig(encoder_type="blstm", num_units=320, num_layers=5),
        num_classes=29))
    params = ctc_task.init_params(task, torch.Generator().manual_seed(0))
    specs = fsdp_partition_specs(params, 2)
    rows = []
    for seed in range(trees):
        g = torch.Generator().manual_seed(seed)
        tree = {k: torch.randn(v.shape, generator=g)
                * 10.0 ** float(torch.rand((), generator=g) * 8 - 6) for k, v in params.items()}
        shards = shard_tree(mesh, tree, specs)
        rows.append((seed, norm_float32(tree), norm_float32(shards, mesh, specs),
                     global_norm(tree), global_norm(shards, mesh, specs)))
    if rank == 0:
        split = sum(1 for s in specs.values() if any(a is not None for a in s))
        lines = [f"{len(params)} leaves, {split} split over the 2 ranks; {trees} trees"]
        for name, i in (("float32 sums", 1), ("global_norm (float64 sums)", 3)):
            differ = [r for r in rows if not torch.equal(r[i], r[i + 1])]
            lines.append(f"{name}: the data-parallel and ZeRO-3 norms differ on "
                         f"{len(differ)} of {trees} trees"
                         + "".join(f"; seed {r[0]} {bits(r[i])} / {bits(r[i + 1])}"
                                   for r in differ[:4]))
        Path(out).write_text("\n".join(lines) + "\n")
    dist.destroy_process_group()


def main() -> int:
    trees = int(sys.argv[sys.argv.index("--trees") + 1]) if "--trees" in sys.argv else 200
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.txt")
        mp.start_processes(run, args=(os.path.join(tmp, "store"), trees, out), nprocs=2,
                           start_method="spawn")
        print(Path(out).read_text(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
