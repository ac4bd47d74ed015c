from .mesh import default_mesh, fit_sharded, shard_arrays
