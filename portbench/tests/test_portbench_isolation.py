"""What the harness loads, and that it is driven by data."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "tensorflow_end2end_speech_recognition_tpu"}


def python(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, env=env, timeout=300)


def test_harness_and_drivers_load_no_jax():
    code = ("import sys, json\n"
            "import portbench.run, portbench.calibrate, portbench.drivers.train, "
            "portbench.drivers.serve\n"
            "from portbench.reference import att_model, ctc_model, train\n"
            "from portbench.drivers.train import program\n"
            "import tensorflow_end2end_speech_recognition_tpu_torch.serving\n"
            "from tensorflow_end2end_speech_recognition_tpu_torch.parallel import mesh\n"
            "for name in ('ls100_ctc_bf16.train_b128', 'ls960_joint_bpe_bf16.train_b128'):\n"
            "    program(portbench.run.Cell(name))\n"
            "for m in json.load(open('BENCHMARK.json'))['per_layer']:\n"
            "    portbench.run.load_reader(m['name'])\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = python(code, ROOT)
    assert out.returncode == 0, out.stderr
    assert not set(json.loads(out.stdout.splitlines()[-1])) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        text = f.read_text()
        assert "tensorflow_end2end_speech_recognition_tpu" not in text, f
        assert "import jax" not in text, f


def test_a_new_cell_is_data_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    mix = json.loads((tmp_path / "portbench/traffic/train_b128.json").read_text())
    (tmp_path / "portbench/traffic/train_b64_short.json").write_text(
        json.dumps(dict(mix, rows=64, base_seconds=[2.0, 4.0])))
    name = "ls100_ctc_bf16.train_b64_short"
    (tmp_path / f"portbench/workloads/{name}.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}}))
    bench["workloads"].append({"name": name, "config": "ls100_ctc_bf16",
                               "traffic": "train_b64_short", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ls100_ctc_bf16.train_b128" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json\nfrom portbench import run\n"
            f"c = run.Cell({name!r})\n"
            "print(json.dumps([c.mix['rows'], sorted(m['name'] for m in c.end_to_end), "
            "sorted(m['name'] for m in c.per_layer)]))\n")
    out = python(code, tmp_path)
    assert out.returncode == 0, out.stderr
    rows, e2e, per_layer = json.loads(out.stdout.splitlines()[-1])
    assert rows == 64 and "train_audio_s_per_s" in e2e and "train_mfu" in per_layer


def test_run_refuses_without_the_port_or_a_card(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "ls100_ctc_bf16.train_b128", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip().endswith("}")
