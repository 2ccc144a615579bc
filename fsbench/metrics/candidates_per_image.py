"""The port's counters ``detect/candidates`` over ``detect/images``: the
candidates an image brought to the fits (each image's count capped at the
bucket), counted by the front door from the fetched ``cand_count``."""

from fsbench import program_registry

UNIT = "candidates"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "candidates: ops/candidates.py::find_candidates_batch -> csrc/candidate_map.cu"
MOVES = "images_per_s"

CANDIDATES = "detect/candidates"
IMAGES = "detect/images"


def read(run):
    images = program_registry.counter(IMAGES)
    candidates = program_registry.counter(CANDIDATES)
    if not images or candidates is None:
        return None
    return candidates / images
