"""Readings for setting a cell's limits for ``correct``, on the card.

    python3 -m portbench.calibrate --workload CELL --seeds 1,2,3 --control-seeds 4,5,6
    python3 -m portbench.calibrate --workload SERVING_CELL --rates 300,600 --seconds 10

Prints one JSON line per seed: the program's numbers (the run's checks)
and, on the control seeds, the control's numbers (the reference computed
one precision below the configuration's) and each fault's that is read
from the reference. With ``--rates``, a serving cell's latency at each
offered rate instead (the sweep that fixes the cell's rate). Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cell = run.Cell(args.workload)
    run.set_caches()
    import torch

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    print(f"card: {run.CardLine().read()}", flush=True)
    driver = run.load_driver(cell.mix["driver"])
    if args.rates:
        rates = [float(r) for r in args.rates.split(",")]
        driver.sweep(cell, seeds[0] if seeds else 1, rates, args.seconds, torch.device("cuda", 0))
    else:
        driver.calibrate(cell, seeds, control, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
