"""The ('data', 'model') mesh over the ranks of the process group (the
counterpart of `stt_tpu.parallel.mesh`).

Rank r is (data index d, model index m) = (r // n_model, r % n_model),
the order of `np.asarray(devices).reshape(n_data, n_model)`. The model
ranks of one data index feed the same rows of every global batch and hold
one shard each of the tensor-parallel parameters; the data ranks of one
model index hold the same shard and feed different rows. With a model
axis the mesh has one process group per data index (its model ranks) and
one per model index (its data ranks), made with `dist.new_group` by every
rank in the same order, including the groups a rank is not in.

`model_partition_spec` is stt_tpu's sharding rule, on a shape: a matrix
shards its last (output) dimension over 'model' when that divides evenly,
a vector its length when that divides and is at least n_model; anything
else is replicated (so n_out 29 stays whole). `shard_params` cuts the full
parameters into this rank's shards, `gather_params` puts them back
together (an all-gather over the model group).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from stt_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int  # ranks on the data axis
    n_model: int  # ranks on the model axis
    rank: int  # this process's rank in the group
    model_group: Optional[object] = None  # this rank's model ranks (None: no model axis)
    data_group: Optional[object] = None  # this rank's data ranks (None: all ranks)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def rows(self, global_batch_size: int) -> Tuple[int, int]:
        """[start, end) of the global batch that this rank's data index feeds."""
        if global_batch_size % self.n_data:
            raise ValueError(f"--train_batch_size {global_batch_size} must be divisible by the "
                             f"{self.n_data}-rank data axis (--num_processes / --n_model_parallel)")
        per_rank = global_batch_size // self.n_data
        return self.data_index * per_rank, (self.data_index + 1) * per_rank


def make_mesh(n_data: int = 0, n_model: int = 1) -> Mesh:
    """The mesh over the process group's ranks (n_data 0: all ranks over
    n_model). A collective when n_model > 1: every rank makes every group."""
    rank, count = distributed.process_index(), distributed.process_count()
    if n_model < 1 or count % n_model:
        raise ValueError(f"--num_processes {count} must be divisible by --n_model_parallel "
                         f"{n_model}")
    if n_data and n_data * n_model != count:
        raise ValueError(f"the data axis spans the {count // n_model} ranks, not {n_data}")
    n_data = count // n_model
    if n_model == 1:
        return Mesh(n_data, 1, rank)
    model_group = data_group = None
    for d in range(n_data):
        group = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == rank // n_model:
            model_group = group
    for m in range(n_model):
        group = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == rank % n_model:
            data_group = group
    return Mesh(n_data, n_model, rank, model_group, data_group)


def model_partition_spec(shape: Sequence[int], n_model: int) -> tuple:
    """stt_tpu's PartitionSpec of a leaf of this shape, as a tuple:
    (None, "model"), ("model",) or () (replicated)."""
    if len(shape) == 2 and shape[1] % n_model == 0:
        return (None, "model")
    if len(shape) == 1 and shape[0] % n_model == 0 and shape[0] >= n_model:
        return ("model",)
    return ()


def shard_dim(shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dimension a leaf of this (full) shape shards over 'model', or None."""
    spec = model_partition_spec(shape, n_model)
    return spec.index("model") if spec else None


def shard(full: torch.Tensor, n_model: int, model_index: int) -> torch.Tensor:
    """Model rank model_index's shard of a full leaf (a copy; the leaf itself
    when it is replicated)."""
    dim = shard_dim(full.shape, n_model)
    if dim is None:
        return full
    return full.chunk(n_model, dim)[model_index].contiguous()


def join_shards(shards: List[torch.Tensor], full_shape: Sequence[int]) -> torch.Tensor:
    """The full leaf from the model ranks' shards, in rank order."""
    dim = shard_dim(full_shape, len(shards))
    return shards[0] if dim is None else torch.cat(shards, dim)


def shard_params(full: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of the full flat parameters (or of any leaves of
    their shapes, such as Adam's moments)."""
    return {name: shard(value, mesh.n_model, mesh.model_index) for name, value in full.items()}


def gather_params(local: Dict[str, torch.Tensor], mesh: Mesh,
                  full_shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """The full leaves from every model rank's shards: an all-gather over the
    model group for each sharded leaf. Replicated leaves are this rank's."""
    full = {}
    for name, value in local.items():
        if shard_dim(full_shapes[name], mesh.n_model) is None:
            full[name] = value
        else:
            full[name] = join_shards(
                distributed.all_gather_list(value.detach(), mesh.model_group), full_shapes[name])
    return full
