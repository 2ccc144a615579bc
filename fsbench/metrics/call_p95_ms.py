"""The 95th percentile of the wall of every call in the window, each from
its start to the entry's return with the device synchronised."""

from fsbench.stats import percentile

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    walls = [(c["end"] - c["start"]) * 1e3 for c in run.calls]
    return percentile(walls, 95) if walls else None
