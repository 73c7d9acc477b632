"""Seconds from the process start to the first timed step: imports,
the CUDA context, the build or load of the port's libraries, weights and
inputs made from the seed, captures, warm-up, the JPEG set where a cell
needs one."""


def read(rec):
    return rec.setup_s
