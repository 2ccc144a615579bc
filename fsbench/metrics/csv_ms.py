"""The port's host-clock stage ``api/run_experiment/csv`` (``Pipeline(profile=True)``),
its total over the window per call."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "rows and CSVs: fast_experiment.write_track_rows_csv, experiment.write_category_counts_csv"
MOVES = "images_per_s"
STAGE = "api/run_experiment/csv"


def read(run):
    total = (run.stages or {}).get(STAGE)
    if total is None or not run.calls:
        return None
    return 1e3 * total / len(run.calls)
