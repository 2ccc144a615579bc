"""Entry drivers: one per front door of the port that a cell times."""
