"""The port's host-clock stage ``api/run_experiment/track+photometry`` (``Pipeline(profile=True)``),
its total over the window per call."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"
STAGE = "api/run_experiment/track+photometry"


def read(run):
    total = (run.stages or {}).get(STAGE)
    if total is None or not run.calls:
        return None
    return 1e3 * total / len(run.calls)
