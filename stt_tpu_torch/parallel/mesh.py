"""The data axis of stt_tpu's ('data', 'model') mesh: the ranks of the
process group, each holding a replica of the parameters and its rows of
every global batch. The model axis (tensor parallelism,
`param_sharding` and `model_partition_spec`) is not ported yet
(ROADMAP.md, M13)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from stt_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class DataMesh:
    n_data: int  # ranks on the data axis
    rank: int  # this process's place on it

    def rows(self, global_batch_size: int) -> Tuple[int, int]:
        """[start, end) of the global batch that this rank feeds."""
        if global_batch_size % self.n_data:
            raise ValueError(f"--train_batch_size {global_batch_size} must be divisible by the "
                             f"{self.n_data}-rank data axis (--num_processes)")
        per_rank = global_batch_size // self.n_data
        return self.rank * per_rank, (self.rank + 1) * per_rank


def make_mesh(n_data: int = 0, n_model: int = 1) -> DataMesh:
    """The data axis over the process group's ranks (n_data 0: all of
    them); n_model above 1 is tensor parallelism, not ported yet."""
    if n_model != 1:
        raise NotImplementedError(
            "a model axis is not ported to stt_tpu_torch yet (ROADMAP.md: M13, tensor parallelism)")
    rank, count = distributed.process_index(), distributed.process_count()
    if n_data and n_data != count:
        raise ValueError(f"the data axis spans the {count} ranks, not {n_data}")
    return DataMesh(count, rank)
