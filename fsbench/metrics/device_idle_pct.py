"""The share of the traced window in which no operation ran on the
device: 100 x (1 - merged device-activity time / window)."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "images_per_s"


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
