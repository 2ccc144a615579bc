from .hashing import epoch_to_hash, hash_to_epoch, psfs_filename
from .rounding import py2_round

__all__ = ["epoch_to_hash", "hash_to_epoch", "psfs_filename", "py2_round"]
