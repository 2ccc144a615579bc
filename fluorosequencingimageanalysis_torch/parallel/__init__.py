from .mesh import make_mesh, shard_fields, experiment_step_sharded

__all__ = ["make_mesh", "shard_fields", "experiment_step_sharded"]
