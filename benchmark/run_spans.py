"""One --trace 1 run of a cell with the program's own spans kept, and the
readers of benchmark/spans.py's PROGRAM_METRICS over them:

    python3 benchmark/run_spans.py --workload <cell> --seed <n> \
        --seconds <s>

See benchmark/spans.py. Prints the harness's line, then one line of the
program's metrics.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import spans  # noqa: E402

if __name__ == "__main__":
    sys.exit(spans.main(sys.argv[1:], T0))
