"""Toy copies of the benchmark's cells, for CPU runs of the whole harness."""

import copy
import json

from portbench import run

# cells whose files are in portbench/ but not yet in BENCHMARK.json: (config, traffic, chips)
PENDING = {"ls100_ctc_bf16.serve_greedy": ("ls100_ctc_bf16", "serve_greedy", 1),
           "ls100_ctc_bf16.train_dp4": ("ls100_ctc_bf16", "train_dp4", 4)}
NARROW = {"num_units": 16, "attention_dim": 8, "decoder_num_units": 16, "embedding_dim": 8}


def cell(name: str, **mix) -> run.Cell:
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    if name in PENDING and all(w["name"] != name for w in bench["workloads"]):
        config, traffic, chips = PENDING[name]
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": chips})
    c = run.Cell(name, bench)
    c.config = copy.deepcopy(c.config)
    exp = c.config["experiment"]
    exp.update({k: v for k, v in NARROW.items() if k in exp})
    exp["num_layers"] = 3 if exp["model_type"] != "ctc" else 2
    if c.config["num_classes"] > 100:
        c.config["num_classes"] = 20
    if c.mix["driver"] == "serve":
        exp["parameter_init"] = 0.5  # logits as far apart as the full-width model's
        c.mix = dict(c.mix, rate_per_s=20, batch_size=4, row_seconds=3.0, check_requests=8,
                     callers=16, lengths=dict(c.mix["lengths"], median_seconds=1.5,
                                              min_seconds=0.5, max_seconds=3.0))
    else:
        c.mix = dict(c.mix, rows=4 * c.mix.get("ranks", 1), base_seconds=[1.0, 1.6],
                     distinct_batches=4)
    c.mix.update(mix)
    return c
