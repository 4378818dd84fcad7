"""Parallelism across processes (the counterpart of `stt_tpu.parallel`):
`distributed` joins the process group, merges what the ranks compute and
holds the model axis's collectives, `mesh` lays the ranks out on the
('data', 'model') mesh and shards the parameters, `tp` is the
tensor-parallel forward."""

from stt_tpu_torch.parallel.mesh import Mesh, gather_params, make_mesh, model_partition_spec, shard_params

__all__ = ["Mesh", "gather_params", "make_mesh", "model_partition_spec", "shard_params"]
