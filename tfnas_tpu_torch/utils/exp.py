"""Experiment/run management: timestamped dirs + stdout/file logging
(train_search.py:68-76, train_eval.py:61-69)."""

from __future__ import annotations

import logging
import os
import sys
import time


def setup_experiment(save_root, prefix, note):
    """Create `<save_root>/<prefix>-<time>-<note>` and attach file+stdout
    logging. Returns the run dir."""
    run_dir = os.path.join(
        save_root, "{}-{}-{}".format(prefix, time.strftime("%Y%m%d-%H%M%S"), note))
    os.makedirs(run_dir, exist_ok=True)
    print(f"Experiment dir : {run_dir}")

    log_format = "%(asctime)s %(message)s"
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format=log_format, datefmt="%m/%d %I:%M:%S %p",
                        force=True)
    fh = logging.FileHandler(os.path.join(run_dir, "log.txt"))
    fh.setFormatter(logging.Formatter(log_format))
    logging.getLogger().addHandler(fh)
    return run_dir


def setup_rank_logging(rank):
    """Logging of a process that is not rank 0: stdout only, each line
    prefixed by the rank; it writes no file."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format=f"[rank {rank}] %(message)s", force=True)
