"""Several processes on torch.distributed (the counterpart of
`stt_tpu.parallel.distributed`).

- `initialize` joins the process group over tcp://coordinator_address
  with world size num_processes and rank process_id. The collectives'
  backend follows the ranks' device, gloo for the CPU and NCCL for CUDA;
  `backend` lets a caller choose (gloo for two ranks on one card, which
  NCCL refuses).
- each rank feeds only its rows of every global batch (`host_batch_bounds`,
  `create_batches(row_range=...)`), re-padded to the global batch's time
  and label lengths (`agree_global_padding`); the train step all-reduces
  the loss's terms and the gradients (`train.step`).
- host-side statistics (WER counters, dev losses) merge with
  `allreduce_sum_across_hosts`.

Gloo takes CUDA tensors for all-reduce but not for all-gather, so the
gathers here run on CPU tensors under gloo and on the rank's card under
NCCL.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)  # a collective waiting on a rank that is gone


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> Tuple[int, int]:
    """Join the process group when num_processes > 1, or when a backend is
    named and num_processes is 1 (a group of one rank, in which the
    collectives run on that backend: how a one-card host checks NCCL).
    Nothing otherwise. Returns (process_index, process_count)."""
    join = num_processes is not None and (num_processes > 1
                                          or (num_processes == 1 and backend is not None))
    if join and not dist.is_initialized():
        if not coordinator_address or process_id is None:
            raise ValueError("several processes need --coordinator_address host:port and "
                             "--process_id (or RANK)")
        if backend is None:
            backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(local_device(device, process_id))
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return process_index(), process_count()


def active() -> bool:
    """Whether a process group is joined (the collectives then run, even in
    a group of one rank)."""
    return dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The card a rank runs on: "cuda" without an index is card rank %
    cards (every rank on card 0 of a one-card host); anything else as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def _collective_device() -> torch.device:
    """Where the gathers' tensors lie: the rank's card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_batch_bounds(global_batch_size: int) -> Tuple[int, int]:
    """[start, end) rows of the global batch this rank must produce."""
    per_host = global_batch_size // process_count()
    start = process_index() * per_host
    return start, start + per_host


def agree_global_padding(features: torch.Tensor, labels: torch.Tensor):
    """Re-pad this rank's rows so that every rank's arrays have the global
    (largest) time and label lengths: one all-gather of two ints a batch.
    The padding is masked by the lengths, as within one process. Returns
    (features, labels)."""
    if not active():
        return features, labels
    local = torch.tensor([features.shape[1], labels.shape[1]], dtype=torch.int64,
                         device=_collective_device())
    gathered = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(gathered, local)
    t_max, l_max = (int(v) for v in torch.stack(gathered).max(dim=0).values.tolist())
    if t_max > features.shape[1]:
        pad = features.new_zeros((features.shape[0], t_max - features.shape[1],
                                  *features.shape[2:]))
        features = torch.cat([features, pad], dim=1)
    if l_max > labels.shape[1]:
        labels = torch.cat([labels, labels.new_zeros((labels.shape[0], l_max - labels.shape[1]))],
                           dim=1)
    return features, labels


def allreduce_sum_across_hosts(values) -> np.ndarray:
    """Sum host-side statistics (WER counters, loss sums) over the ranks,
    in float64. One process: the values as they are."""
    values = np.asarray(values)
    if not active():
        return values
    t = torch.as_tensor(values, dtype=torch.float64, device=_collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def allreduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum a tensor over the ranks in place, where it lies (gloo takes CUDA
    tensors for all-reduce); nothing without a process group."""
    if active():
        dist.all_reduce(tensor)
    return tensor


def merge_wer_counters(word_errors: float, n_words: int, char_errors: float,
                       n_chars: int) -> Tuple[float, float]:
    """The corpus WER and CER over every rank's edit-distance counters."""
    sums = allreduce_sum_across_hosts(
        np.asarray([word_errors, n_words, char_errors, n_chars], np.float64))
    return float(sums[0] / max(sums[1], 1.0)), float(sums[2] / max(sums[3], 1.0))


def barrier() -> None:
    if active():
        dist.barrier()
