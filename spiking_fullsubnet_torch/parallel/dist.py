"""Process-group coordination on ``torch.distributed`` (counterpart of
``spiking_fullsubnet_tpu/parallel/dist.py``; the reference's Accelerate
process utilities).

One process drives one card, as under the reference's DDP. Mapping:
    accelerator.gather_for_metrics -> ``gather_for_metrics``
    accelerator.reduce(early_stop) -> ``reduce_scalar_sum``
    wait_for_everyone              -> ``wait_for_everyone``
    set_seed(device_specific=True) -> ``device_specific_seed``, ``set_seed``
    LR * sqrt(num_processes)       -> ``scale_lr``
    DDP's gradient all-reduce      -> ``average_gradients``
    DDP's broadcast_buffers        -> ``broadcast_tensors``

Without a process group every function is the one-process identity. With
one, every collective runs, at world size 1 too. Under NCCL the scalars and
metric rows travel as tensors on the rank's own card (NCCL refuses CPU
tensors); under gloo they travel on the host, and gradients and buffers
stay where they are (gloo reduces and broadcasts CUDA tensors too).
"""

from __future__ import annotations

import math
import os
import random
from datetime import timedelta
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

#: how long a collective or the rendezvous waits for the other ranks
DEFAULT_TIMEOUT = timedelta(seconds=300)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _local_card() -> torch.device:
    """``cuda:{LOCAL_RANK}`` (0 without it); raises where the machine lacks
    that card."""
    index, count = int(os.environ.get("LOCAL_RANK", 0)), torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(f"LOCAL_RANK {index} asks for cuda:{index}, but the machine has "
                           f"{count} CUDA device(s); start at most {count} ranks a node")
    return torch.device("cuda", index)


def rank_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device of this rank: ``None`` or ``"cuda"`` is ``cuda`` without a
    process group and ``cuda:{LOCAL_RANK}`` with one; any other device as
    given. A ``cuda:{LOCAL_RANK}`` the machine lacks raises: no rank is moved
    to another card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and _group():
        return _local_card()
    return dev


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           timeout: timedelta = DEFAULT_TIMEOUT,
                           device: Union[str, torch.device, None] = None) -> bool:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    A no-op without ``RANK`` and ``WORLD_SIZE`` (one process, as JAX's
    ``initialize_distributed``) and once a group exists. ``backend=None`` is
    ``nccl`` when ``device`` is CUDA (``None`` means CUDA, the entry points'
    default) and ``gloo`` on the CPU; a caller may name ``gloo`` for CUDA
    tensors. ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); ``file://<path>`` meets through a file. A rank whose
    peers do not come or do not answer fails after ``timeout``. Returns
    whether this call made the group."""
    if _group() or not {"RANK", "WORLD_SIZE"} & set(os.environ):
        return False
    need = ("RANK", "WORLD_SIZE") + (() if init_method else ("MASTER_ADDR", "MASTER_PORT"))
    missing = [v for v in need if v not in os.environ]
    if missing:
        raise RuntimeError(f"torch.distributed: {missing} unset; launch with torchrun or set "
                           + ", ".join(need))
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        # NCCL's collectives run on the current device: the rank's own card
        torch.cuda.set_device(dev if dev.index is not None else _local_card())
    dist.init_process_group(backend=backend, init_method=init_method, timeout=timeout,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def shutdown() -> None:
    """Leave the process group, when there is one, after freeing the band
    groups' exchange buffers (``mesh.release_band_exchanges``)."""
    if _group():
        from .mesh import release_band_exchanges

        release_band_exchanges()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if _group() else 1


def process_index() -> int:
    return dist.get_rank() if _group() else 0


def is_main_process() -> bool:
    return process_index() == 0


def device_specific_seed(seed: int) -> int:
    """Per-process seed (reference: ``set_seed(seed, device_specific=True)``)."""
    return int(seed) + process_index()


def set_seed(seed: int) -> None:
    """Seed python's, numpy's and torch's global generators (the datasets'
    random crops and offsets draw from numpy's)."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)


def scale_lr(lr: float, world: Optional[int] = None) -> float:
    """The LR x sqrt(world) rule (reference recipe run.py:31). ``world``
    defaults to the group's size: one process a card, so it is the
    data-parallel degree, as the JAX package's global device count is."""
    if world is None:
        world = process_count()
    return lr * math.sqrt(world)


def _comm_device() -> torch.device:
    """Where a collective's host values travel: the rank's card under NCCL,
    the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def wait_for_everyone(tag: str = "barrier") -> None:
    """A barrier over the group (``tag`` names it in a failure's message)."""
    if not _group():
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed on rank {process_index()}: {e}") from e


def broadcast_from_main(value) -> float:
    """Rank 0's scalar on every rank, in float64 (``None`` is 0.0): the
    validation score that only rank 0 computes, so that every rank runs the
    early-stop and best-checkpoint bookkeeping with the same state."""
    if not _group():
        return float(value)
    t = torch.tensor([0.0 if value is None else float(value)], dtype=torch.float64,
                     device=_comm_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def reduce_scalar_sum(value: float) -> float:
    """A python scalar summed over the ranks (the early-stop mark,
    reference trainer.py:460-468)."""
    if not _group():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t)
    return float(t.item())


def reduce_mean(values: Dict[str, float]) -> Dict[str, float]:
    """Each value's mean over the ranks, every rank giving the same keys."""
    if not _group() or not values:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                     device=_comm_device())
    dist.all_reduce(t)
    t /= process_count()
    mean = dict(zip(keys, t.tolist()))
    return {k: mean[k] for k in values}


def gather_for_metrics(step_output: List[Dict[str, float]]) -> List[Dict[str, float]]:
    """Every rank's metric rows, on every rank: rank 0's rows, then rank
    1's, and so on (trainer.py:511). Every row of every rank has the same
    keys (the same recipe runs on each); the values travel as float64."""
    if not _group():
        return step_output
    keys = sorted(step_output[0]) if step_output else []
    if not keys or any(sorted(row) != keys for row in step_output):
        raise ValueError(f"gather_for_metrics: no rows, or rows with keys other than {keys}")
    dev, world = _comm_device(), process_count()
    n = torch.tensor([len(step_output), len(keys)], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(sizes, n)
    sizes = [tuple(s.tolist()) for s in sizes]
    if any(k != len(keys) for _, k in sizes):
        raise ValueError(f"gather_for_metrics: ranks give rows of other widths ({sizes})")
    local = torch.zeros((max(r for r, _ in sizes), len(keys)), dtype=torch.float64)
    local[: len(step_output)] = torch.tensor([[float(row[k]) for k in keys]
                                              for row in step_output], dtype=torch.float64)
    local = local.to(dev)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    return [dict(zip(keys, row)) for p, (r, _) in enumerate(sizes) for row in parts[p][:r].tolist()]


def _buckets(tensors: Iterable[torch.Tensor]) -> Dict[tuple, List[torch.Tensor]]:
    """The tensors grouped by (dtype, device), in their order."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


def average_gradients(weights: Iterable[torch.Tensor]) -> int:
    """Every weight's ``.grad`` averaged over the ranks, in place: the
    counterpart of the gradient all-reduce that XLA inserts in the JAX
    package's sharded step, and of DDP's. One flat bucket a dtype, one
    ``all_reduce`` a bucket, then divided by the world size. Weights
    without a gradient are left out (every rank runs the same model, so
    every rank leaves out the same ones). Returns the number of
    ``all_reduce`` calls (0 without a group)."""
    if not _group():
        return 0
    world = process_count()
    calls = 0
    for grads in _buckets(w.grad for w in weights if w.grad is not None).values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()
        calls += 1
    return calls


def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0) -> int:
    """Rank ``src``'s values in every rank's ``tensors``, in place (DDP's
    ``broadcast_buffers``: the BN running statistics; the weights once before
    training). One flat bucket a dtype. Returns the number of broadcasts."""
    if not _group():
        return 0
    calls = 0
    with torch.no_grad():
        for group in _buckets(tensors).values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src)
            offset = 0
            for t in group:
                t.copy_(flat[offset: offset + t.numel()].view_as(t))
                offset += t.numel()
            calls += 1
    return calls
