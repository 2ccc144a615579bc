"""512x512 images whose results the entry returned, over the window: whole
calls, divided by the time from the window's start to the end of the last
call counted."""

UNIT = "images/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    done = [c for c in run.calls if c["ok"]]
    if not done:
        return None
    return sum(c["images"] for c in done) / (run.calls[-1]["end"] -
                                             run.window_start)
