from .spots import Spot, Image
from .traces import Trace, SimpleTrace, PhotometryTrace, PlateauTrace
from .experiment import (Experiment, SequenceExperiment,
                         MultichannelSequenceExperiment,
                         MultifieldMultichannelSequenceExperiment,
                         TimetraceExperiment)

__all__ = [
    "Spot", "Image", "Trace", "SimpleTrace", "PhotometryTrace",
    "PlateauTrace", "Experiment", "SequenceExperiment",
    "MultichannelSequenceExperiment",
    "MultifieldMultichannelSequenceExperiment", "TimetraceExperiment",
]
