"""The benchmark's core: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration and a traffic mix in BENCHMARK.json. The
configuration's file holds its sizes; the traffic file
(benchmark/traffic/<traffic>.json) names the driver
(benchmark/drivers/<driver>.py) that runs it, its parameters and the
limits of the numbers its correctness check compares. Each metric is
read by its own reader, benchmark/metrics/<metric name>.py, from the
run's record. A run sets up, measures for --seconds, checks what the
timed path produced against the plain reference (benchmark/reference/),
and prints one JSON line last on standard output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tfnas_tpu")


def parse(argv):
    p = argparse.ArgumentParser("the port's benchmark: one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def subseed(seed, k):
    """A seed for the k-th stream of draws of a run (any size of --seed)."""
    return (int(seed) * 1_000_003 + 7919 * int(k)) % (2 ** 63 - 1)


def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name, man=None):
    """(cell, configuration, traffic) dicts of a cell of BENCHMARK.json."""
    man = man or manifest()
    cell = _entry(man["workloads"], name, "workload")
    conf = _entry(man["configs"], cell["config"], "configuration")
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(man, cell_name, trace):
    """The metric entries a run of the cell reports: its end-to-end
    metrics with --trace 0, its per-layer metrics with --trace 1."""
    if not trace:
        return [m for m in man["end_to_end"]
                if cell_name in m.get("workloads", [cell_name])]
    e2e = {m["name"] for m in cell_metrics(man, cell_name, 0)}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            or ("workloads" not in m and m["moves"] in e2e)]


def reader(name):
    """The read(record) function of benchmark/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(traffic):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def set_cache_env():
    """Build and kernel caches of the program inside the checkout, at
    fixed paths; no library loads JAX behind the port's back."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a driver gets: the cell, its configuration and traffic, the
    run's arguments and device, and the record it fills for the
    readers."""

    def __init__(self, args, cell, config, traffic, t0, device):
        self.args, self.cell, self.config = args, cell, config
        self.traffic, self.t0, self.device = traffic, t0, device
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.rec = types.SimpleNamespace(
            setup_s=None, window_s=None, counts={}, latencies_ms=[],
            cuda_ms={}, host_ms={}, flops=None, trace=None, bounds={},
            chips=cell.get("chips", 1), peaks=peaks(device))
        self.checks = []  # (name, value, limit)
        self.memory_peak = 0

    def generator(self, k):
        import torch
        return torch.Generator(self.device).manual_seed(
            subseed(self.seed, k))

    def np_seed(self, k):
        return subseed(self.seed, k)

    def check(self, name, value):
        """Record a compared number against its limit in the traffic
        file; a number that is not finite fails."""
        self.checks.append((name, float(value),
                            float(self.traffic["limits"][name])))


def peaks(device):
    """The peak rates of the run's device (benchmark/peaks.json, by the
    first name fragment that the device's name holds)."""
    with open(BENCH / "peaks.json") as f:
        table = json.load(f)
    name = "cpu"
    if getattr(device, "type", None) == "cuda":
        import torch
        name = torch.cuda.get_device_name(device)
    for frag, row in table.items():
        if frag in name:
            return dict(row, matched=frag)
    return {}


def device_info(run):
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.rec.chips, "memory_peak_bytes": int(run.memory_peak)}
    if run.trace and run.rec.trace is not None:
        info["busy_s"] = run.rec.trace["busy_s"]
        info["window_s"] = run.rec.trace["window_s"]
    return info


def power_limit():
    """The card's name and power limit from nvidia-smi, for stderr."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def read_metrics(man, cell_name, trace, rec):
    out = {}
    for m in cell_metrics(man, cell_name, trace):
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def verdict(checks):
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def run_on(device, cell, config, traffic, seed, seconds, trace=0):
    """One run of a cell given as dicts on `device`, without the look for
    the cell's cards: the harness's run for the CPU tests. Returns the
    Run, its metrics and its verdict."""
    import torch
    args = argparse.Namespace(workload=cell["name"], seed=seed,
                              seconds=seconds, trace=trace)
    run = Run(args, cell, config, traffic, time.perf_counter(),
              torch.device(device))
    driver(traffic).run(run)
    return run


def main(argv, t0):
    args = parse(argv)
    man = manifest()
    cell, config, traffic = load_cell(args.workload, man)
    set_cache_env()
    import torch
    torch.set_num_threads(1)  # the port's work is on the card
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"device: {power_limit()} x {cell['chips']}", file=sys.stderr)
    run = Run(args, cell, config, traffic, t0, device)
    driver(traffic).run(run)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the JAX side were loaded: {bad}", file=sys.stderr)
        return 3
    metrics = read_metrics(man, cell["name"], args.trace, run.rec)
    correct = verdict(run.checks)
    line = {
        "correct": correct,
        "attempted": run.rec.counts.get("attempted", 0),
        "failed": run.rec.counts.get("failed", 0),
        "metrics": metrics,
        "device": device_info(run),
    }
    if args.trace and run.rec.trace is not None:
        line["breakdown"] = run.rec.trace["breakdown"]
    line["compared"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in run.checks}
    if not correct and getattr(run, "detail", None) is not None:
        print(f"detail: {json.dumps(run.detail)}", file=sys.stderr)
    for n, v, lim in run.checks:
        print(f"compared {n}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
