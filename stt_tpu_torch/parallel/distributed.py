"""Several processes on torch.distributed (the counterpart of
`stt_tpu.parallel.distributed`).

- `initialize` joins the process group over tcp://coordinator_address
  with world size num_processes and rank process_id. The collectives'
  backend follows the ranks' device, gloo for the CPU and NCCL for CUDA;
  `backend`, or for a command line the environment variable
  STT_TORCH_DIST_BACKEND, lets a caller choose (gloo for two ranks on one
  card, which NCCL refuses).
- each rank feeds only its rows of every global batch (`host_batch_bounds`,
  `create_batches(row_range=...)`), re-padded to the global batch's time
  and label lengths (`agree_global_padding`); the train step all-reduces
  the loss's terms and the gradients (`train.step`).
- host-side statistics (WER counters, dev losses) merge with
  `allreduce_sum_across_hosts`.
- the model axis's collectives (`parallel.tp`) over a subgroup, as
  autograd functions: `all_gather` along a dimension, whose backward is a
  sum-scatter (JAX's transpose of all_gather, psum_scatter), and the tiled
  `all_to_all`, whose backward is the inverse all_to_all.

Where the gathers' and the model axis's tensors lie is the backend's
choice, made in one place (`_collective_device`): on the rank's card under
NCCL, on the CPU under gloo, through which they are staged explicitly
(`staged_bytes` counts the bytes copied between the card and the host).
All-reduces take the tensor where it lies under either backend.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)  # a collective waiting on a rank that is gone
BACKEND_ENV = "STT_TORCH_DIST_BACKEND"  # the backend of a group the caller names none for


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
            backend = os.environ.get(BACKEND_ENV) or (
                "nccl" if torch.device(device).type == "cuda" else "gloo")
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


def _staged(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor where the backend's collectives take it (see
    `_collective_device`), counting the bytes that cross to the host."""
    target = _collective_device()
    if tensor.device != target and tensor.device.type == "cuda":
        staged_bytes[0] += tensor.numel() * tensor.element_size()
    return tensor.to(target).contiguous()


def _back(tensor: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if tensor.device != like.device and like.device.type == "cuda":
        staged_bytes[0] += tensor.numel() * tensor.element_size()
    return tensor.to(like.device)


staged_bytes = [0]  # bytes copied between the card and the host for gloo's collectives


def group_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def all_gather_list(tensor: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's tensor of the group (all the same shape), in rank order,
    on the tensor's device."""
    staged = _staged(tensor)
    out = [torch.empty_like(staged) for _ in range(group_size(group))]
    dist.all_gather(out, staged, group=group)
    return [_back(t, tensor) for t in out]


def _gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return torch.cat(all_gather_list(x, group), dim)


def _sum_scatter_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of x, cut in group-size pieces along dim: this
    rank's piece."""
    pieces = [_staged(p) for p in x.chunk(group_size(group), dim)]
    out = torch.empty_like(pieces[0])
    dist.reduce_scatter(out, pieces, group=group)
    return _back(out, x)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """Piece j of x along split_dim goes to rank j; the pieces received,
    in rank order, are joined along concat_dim."""
    k = group_size(group)
    send = _staged(torch.stack(x.chunk(k, split_dim)))
    received = torch.empty_like(send)
    dist.all_to_all_single(received, send, group=group)
    return torch.cat(_back(received, x).unbind(0), concat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum_scatter_along(grad.contiguous(), ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(grad.contiguous(), concat_dim, split_dim, ctx.group), None, None, None


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's x joined along dim in rank order (tiled), differentiable:
    the backward sums the cotangents over the group and gives each rank its
    piece."""
    return _AllGather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group=None) -> torch.Tensor:
    """Tiled all_to_all: x cut in group-size pieces along split_dim, piece j
    to rank j, the received pieces joined along concat_dim in rank order.
    Differentiable: the backward is the inverse all_to_all."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


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


def allreduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum a tensor over the ranks (of `group`, else all) in place, where it
    lies (gloo takes CUDA tensors for all-reduce); nothing without a process
    group."""
    if active():
        dist.all_reduce(tensor, group=group)
    return tensor


def broadcast_flag(flag: bool) -> bool:
    """Rank 0's flag on every rank."""
    if not active():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64, device=_collective_device())
    dist.broadcast(t, 0)
    return bool(t.item())


def merge_wer_counters(word_errors: float, n_words: int, char_errors: float,
                       n_chars: int) -> Tuple[float, float]:
    """The corpus WER and CER over every rank's edit-distance counters."""
    sums = allreduce_sum_across_hosts(
        np.asarray([word_errors, n_words, char_errors, n_chars], np.float64))
    return float(sums[0] / max(sums[1], 1.0)), float(sums[2] / max(sums[3], 1.0))


def barrier() -> None:
    if active():
        dist.barrier()
