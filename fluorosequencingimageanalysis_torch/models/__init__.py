from .detect import detect_and_fit, find_peptides, SpotFindResult

__all__ = ["detect_and_fit", "find_peptides", "SpotFindResult"]
