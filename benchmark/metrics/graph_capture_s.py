"""Seconds of the program's CUDA-graph captures in the run (warm-up,
capture and instantiation of each graph: its `tfnas.graph.capture` span,
`GraphedFn.build_s`), all made in set-up: the total the program keeps in
search/compiled.py `captures`."""

from benchmark import spans


def read(rec):
    return spans.capture_s()
