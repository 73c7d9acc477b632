"""Percent of the traced window in which the device is idle while the
host is inside the train step's phases (idle gaps that begin inside a
`tfnas.train.*` range): the part of idle_share.train that the step's own
dispatch leaves."""

from benchmark import spans


def read(rec):
    return spans.idle_share_in(rec, "tfnas.train.")
