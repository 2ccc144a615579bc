"""Metric readers: ``metrics/<name>.py`` reads metric ``name`` from a
finished run (``fsbench.run.Run``) and returns its value, or None where
the run holds nothing to read."""
