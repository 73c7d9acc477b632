"""Readings of a cell's compared numbers over many seeds in one process,
for setting and checking the limits of its correctness check:

    python3 benchmark/sweep.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--mode program|float8|half_batch|float64]

mode program runs the cell as benchmark/run.py does (set-up, a window of
--seconds, the check) and prints its compared numbers and metrics, with
--fault <name> a fault of benchmark/tests/faults.py planted underneath;
float8 puts the reference computed in float8 in the program's place (the
control), half_batch the reference on half of each batch (a fault); both
print the numbers the check would compare. float64 (the search) puts the
float32 reference in the program's place against the reference in
float64. One JSON line per seed.
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import json  # noqa: E402

import pytest  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.tests import faults  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--mode", default="program")
    p.add_argument("--fault", default="",
                   help="with --mode program: plant this fault of "
                        "benchmark/tests/faults.py underneath the run")
    p.add_argument("--set", action="append", default=[],
                   help="key=JSON value: a traffic parameter changed for "
                        "this sweep (a look, not a cell)")
    a = p.parse_args(argv)
    man = harness.manifest()
    cell, config, traffic = harness.load_cell(a.workload, man)
    for kv in a.set:
        k, v = kv.split("=", 1)
        traffic[k] = json.loads(v)
    harness.set_cache_env()
    import torch
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    drv = harness.driver(traffic)
    print(f"device: {harness.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        if a.mode == "program":
            with pytest.MonkeyPatch.context() as mp:
                if a.fault:
                    getattr(faults, a.fault)(mp)
                run = harness.run_on(dev, cell, config, traffic, seed,
                                     a.seconds, a.trace)
            out = getattr(run, "readings", None) or {
                n: v for n, v, _ in run.checks}
            line = {"seed": seed, "mode": a.mode, "fault": a.fault,
                    "readings": out,
                    "correct": harness.verdict(run.checks),
                    "metrics": harness.read_metrics(man, cell["name"],
                                                    a.trace, run.rec),
                    "memory_peak_bytes": run.memory_peak}
        else:
            args = argparse.Namespace(workload=a.workload, seed=seed,
                                      seconds=a.seconds, trace=0)
            run = harness.Run(args, cell, config, traffic,
                              time.perf_counter(), dev)
            line = {"seed": seed, "mode": a.mode,
                    "readings": drv.control(run, a.mode)}
        line["seconds"] = time.perf_counter() - t
        line["detail"] = getattr(run, "detail", None)
        line["leaf_gaps"] = getattr(run, "leaf_gaps", None)
        print(json.dumps(line), flush=True)
        del run
        import gc
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
