"""The harness finds cells, configurations, traffic mixes and metric
readers by the names in BENCHMARK.json, and a new one is added by new
files and manifest entries alone."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.harness import BENCH, ROOT


def test_every_name_resolves():
    man = harness.manifest()
    configs = {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
    for w in man["workloads"]:
        assert w["config"] in configs
        cell, cfg, tr = harness.load_cell(w["name"], man)
        assert harness.driver(tr).run
        assert set(tr["limits"])
        e2e = harness.cell_metrics(man, w["name"], 0)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(man, w["name"], 1)
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_per_layer_metrics_move_a_metric_their_cells_report():
    man = harness.manifest()
    for m in man["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  harness.cell_metrics(man, w, 0)}


DUMMY_READER = '''"""Weight steps of the window (a test's dummy metric)."""


def read(rec):
    return rec.counts.get("weight_steps")
'''

PROBE = """
import json, sys, torch
torch.set_num_threads(1)
from benchmark import harness
man = harness.manifest()
cell, cfg, tr = harness.load_cell("dummy.search", man)
out = {}
for trace in (0, 1):
    run = harness.run_on("cpu", cell, cfg, tr, 11, 0.2, trace)
    out[trace] = harness.read_metrics(man, cell["name"], trace, run.rec)
    out["correct%d" % trace] = harness.verdict(run.checks)
print(json.dumps(out))
"""


def test_a_cell_config_traffic_and_metric_added_by_files(tmp_path):
    ignore = shutil.ignore_patterns("__pycache__", ".data", ".cache")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=ignore)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    # the new files
    cfg = json.loads((BENCH / "tests" / "data" / "tiny_search.json")
                     .read_text())
    (bench / "configs" / "dummy_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy.search.json").write_text(json.dumps({
        "driver": "search", "epoch": 10, "train_batches": 2,
        "val_batches": 1, "trace_steps": 2,
        "limits": {"pick_mismatch": 0, "grad_diff.weights": 1e-4,
                   "update_diff.log_alphas": 1e-4}}))
    (bench / "metrics" / "dummy_steps.search.py").write_text(DUMMY_READER)
    # the new manifest entries
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_tiny", "source": "test",
                           "file": "benchmark/configs/dummy_tiny.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy.search", "config": "dummy_tiny",
                             "traffic": "dummy.search", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "search_img_per_s":
            m["workloads"].append("dummy.search")
    man["per_layer"].append({
        "name": "dummy_steps.search", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "search steps",
        "moves": "search_img_per_s", "workloads": ["dummy.search"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct0"] and got["correct1"]
    assert set(got["0"]) == {"search_img_per_s", "setup_s"}
    assert got["1"]["dummy_steps.search"]["value"] > 0
    # every file the benchmark had is as it was
    cmp = filecmp.dircmp(BENCH, bench, ignore=["__pycache__", ".data",
                                               ".cache"])
    stack = [cmp]
    while stack:
        d = stack.pop()
        assert not d.diff_files and not d.left_only, (d.left,
                                                      d.diff_files)
        stack += d.subdirs.values()
