from .._device import make_mesh
from .mesh import shard_fields, experiment_step_sharded

__all__ = ["make_mesh", "shard_fields", "experiment_step_sharded"]
