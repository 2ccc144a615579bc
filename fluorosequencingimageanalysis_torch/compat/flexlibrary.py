"""The reference's ``flexlibrary`` module (flexlibrary.py), on the port's
object layer (pipeline/spots.py, pipeline/experiment.py,
pipeline/traces.py)."""

from ..pipeline import (  # noqa
    Spot, Image, Trace, SimpleTrace, PhotometryTrace, PlateauTrace,
    Experiment, SequenceExperiment, MultichannelSequenceExperiment,
    MultifieldMultichannelSequenceExperiment, TimetraceExperiment)
from ..pipeline.experiment import (  # noqa
    MultifieldSequenceExperiment)
