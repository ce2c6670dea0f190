"""Run one cell of the port's benchmark and print its result as the last line.

    python3 -m portbench.run --workload ls100_ctc_bf16.train_b128 --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``tensorflow_end2end_speech_recognition_tpu_torch``). The cell's
entry in ``BENCHMARK.json`` names its configuration
(``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``, whose ``driver`` names the module
of ``portbench/drivers`` that runs it) and its chips; its limits for
``correct`` are in ``portbench/workloads/<cell>.json``; each per-layer
metric's reader is ``portbench/metrics/<metric>.py``. A cell, a mix, a
configuration or a metric is added by adding files and entries.

A run makes its weights and inputs from ``--seed``, warms the cell's shapes
(set-up), measures for ``--seconds``, then checks what the timed path
produced against the plain reference (``portbench/reference``). With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a profiled window. It exits non-zero and prints
no result without the cards the cell asks for, or when the process holds
JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorflow_end2end_speech_recognition_tpu")


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.chips = name, entry["chips"]
        self.config = json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text())
        self.mix = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
        self.limits = json.loads((BENCH / "workloads" / f"{name}.json").read_text())["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in reported else [])]

    @property
    def exp(self) -> dict:
        return self.config["experiment"]


def load_reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), BENCH / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernels into its own ``_build/``)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


class CardLine:
    """The cards' names and power limits from ``nvidia-smi``, asked at once
    and read later, so that the query overlaps the set-up."""

    def __init__(self):
        try:
            self._proc = subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                           "--format=csv,noheader"], stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)
        except OSError as e:
            self._proc, self._error = None, e

    def read(self) -> str:
        if self._proc is None:
            return f"nvidia-smi failed: {self._error}"
        try:
            out, err = self._proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.communicate()
            return "nvidia-smi timed out"
        return out.strip().replace("\n", "; ") or err.strip()



def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite(x: float) -> float:
    """JSON has no infinity: a missing answer's latency, or a gap with no
    alignment, is written as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def result_line(cell: Cell, out: dict, trace: bool, device: dict) -> dict:
    """The result printed as the run's last line, from the cell's outcome."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"]).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": finite(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": finite(out["end_to_end"][m["name"]]),
                                  "unit": m["unit"]}
    checks = {k: {"value": finite(c["value"]), "limit": c["limit"]}
              for k, c in out["checks"].items()}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": device}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, faults=(),
            log=print) -> dict:
    """Set-up, window and check of one run on ``device`` (or on the mix's
    ``ranks``, one process each); the cell's outcome."""
    from portbench.trace import Trace

    if cell.mix.get("ranks", 1) > 1:
        return execute_ranks(cell, seed, seconds, trace, device.type, faults, log)
    driver = load_driver(cell.mix["driver"])
    return driver.run(cell, seed=seed, seconds=seconds, trace=Trace(trace), device=device,
                      start=START, faults=set(faults), log=log)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, cell: Cell, seed: int, seconds: float,
              trace: bool, device_type: str, faults, start: float, results) -> None:
    """One rank of a multi-card run: its own process and card, a process group
    over ``tcp://localhost:<port>`` (nccl on cards, gloo on the CPU), the
    port's data mesh, the traffic's module; its outcome goes back on ``results``."""
    import torch
    import torch.distributed as dist

    from portbench.trace import Trace

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            device_id=device if device_type == "cuda" else None)
    try:
        from tensorflow_end2end_speech_recognition_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(world, device)
        out = load_driver(cell.mix["driver"]).run(
            cell, seed=seed, seconds=seconds, trace=Trace(trace), device=device, start=start,
            faults=set(faults), log=print if rank == 0 else (lambda *a, **k: None), mesh=mesh)
        if rank:
            out["record"].pop("trace", None)
        out["forbidden"] = loaded_forbidden()
        out["kind"] = torch.cuda.get_device_name(device) if device_type == "cuda" else "cpu"
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def execute_ranks(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str,
                  faults, log) -> dict:
    """Start the mix's ranks, wait for each to end, and merge their outcomes:
    rank 0's numbers and checks, the fullest card's peak, the mean busy time."""
    import torch.multiprocessing as mp

    world = cell.mix["ranks"]
    os.environ["NCCL_SHM_DISABLE"] = "1"  # no files of the run's own in /dev/shm
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, cell, seed, seconds, trace,
                                                 device_type, tuple(faults), START, results))
             for r in range(world)]
    for p in procs:
        p.start()
    outs = {}
    try:
        while len(outs) < world:
            if not any(p.is_alive() for p in procs) and results.empty():
                break
            try:
                rank, out = results.get(timeout=5.0)
                outs[rank] = out
            except queue.Empty:  # look again whether the ranks still live
                continue
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    if len(outs) < world:
        raise RuntimeError(f"{world - len(outs)} rank(s) ended without an outcome "
                           f"(exit codes {[p.exitcode for p in procs]})")
    out = outs[0]
    peaks = [o["memory_peak_bytes"] for o in outs.values()]
    out["memory_peak_bytes"] = max(peaks)
    out["end_to_end"]["train_peak_gib"] = max(peaks) / 2**30
    if "busy_s" in out:
        out["busy_s"] = sum(o["busy_s"] for o in outs.values()) / world
    out["forbidden"] = sorted({m for o in outs.values() for m in o["forbidden"]})
    log(f"ranks: peaks {peaks} B, busy {[o.get('busy_s') for o in outs.values()]} s",
        flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    set_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = CardLine()
    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    print(f"card: {card.read()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    found = sorted(set(loaded_forbidden()) | set(out.get("forbidden", ())))
    if found:
        print(f"the run loaded {found}: the port and the benchmark must not import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": out.get("kind") or torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
    line = result_line(cell, out, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
