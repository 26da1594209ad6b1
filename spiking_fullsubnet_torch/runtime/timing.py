"""Device timing by differencing chain lengths (counterpart of
``spiking_fullsubnet_tpu/runtime/timing.py``).

The protocol is the JAX module's: warm up, then run a chain of ``n1`` calls
and a chain of ``n2`` calls back to back, each ended by a scalar checksum
that consumes every output element, and take

    per_iter = (t(n2) - t(n1)) / (n2 - n1)

best of ``reps``, so the fixed cost of starting a chain and reading its
result cancels.

On the card each chain is timed with two ``torch.cuda.Event``s recorded on
the current stream around the calls and the checksum; on the CPU with
``time.perf_counter``. JAX's ``lax.optimization_barrier`` chaining has no
counterpart: kernels on one stream run in the order they were launched and
none is dropped, so the calls of a chain already run back to back. The JAX
module's account of its TPU transport does not apply to a card attached to
its host.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

import torch

from .device import resolve_device


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def checksum(tree: Any) -> torch.Tensor:
    """A float32 scalar that consumes every element of every tensor leaf:
    the sum of ``|x|`` over the floating (and complex) leaves, each in
    float32, plus the sum of the integer and boolean leaves (the JAX
    module's ``checksum``)."""
    total = None
    for leaf in _leaves(tree):
        if leaf.is_floating_point() or leaf.is_complex():
            part = leaf.abs().sum().to(torch.float32)
        else:
            part = leaf.sum().to(torch.float32)
        total = part if total is None else total + part
    return torch.zeros((), dtype=torch.float32) if total is None else total


def fetch(x: torch.Tensor) -> float:
    """The value of a scalar tensor on the host (a sync point)."""
    return float(x.item())


def _device_of(tree: Any) -> Optional[torch.device]:
    for leaf in _leaves(tree):
        return leaf.device
    return None


def _chain(fn: Callable, args: Tuple, n: int) -> torch.Tensor:
    out = None
    for _ in range(n):
        out = fn(*args)
    return checksum(out)


def _chain_seconds(fn: Callable, args: Tuple, n: int, dev: Optional[torch.device]) -> float:
    """Seconds of one chain of ``n`` calls and its checksum: CUDA events on
    the card, the host clock on the CPU."""
    if dev is not None and dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _chain(fn, args, n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fetch(_chain(fn, args, n))
    return time.perf_counter() - t0


def time_fn_per_iter(fn: Callable, args: Tuple, iters: Tuple[int, int] = (2, 8),
                     reps: int = 3) -> float:
    """Best-of-``reps`` seconds per call of ``fn(*args)`` on the device of
    ``args``' first tensor, the fixed cost of a chain removed by
    differencing chain lengths ``iters[0]`` and ``iters[1]``."""
    n1, n2 = iters
    if not n2 > n1 >= 1:
        raise ValueError(f"iters {iters}: need n2 > n1 >= 1")
    dev = _device_of(args)
    fetch(_chain(fn, args, n1))  # warm-up: builds, allocator, caches
    fetch(_chain(fn, args, n2))
    t1 = min(_chain_seconds(fn, args, n1, dev) for _ in range(reps))
    t2 = min(_chain_seconds(fn, args, n2, dev) for _ in range(reps))
    return max((t2 - t1) / (n2 - n1), 1e-12)


def time_fn_total(fn: Callable, args: Tuple, reps: int = 3) -> float:
    """Best-of-``reps`` seconds of one call and the fetch of its checksum on
    the host clock (one host round trip included): a latency, where
    ``time_fn_per_iter`` is a throughput."""
    fetch(checksum(fn(*args)))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fetch(checksum(fn(*args)))
        best = min(best, time.perf_counter() - t0)
    return best


def host_roundtrip_seconds(reps: int = 5, device=None) -> float:
    """The least seconds of one tiny operation on ``device`` (``cuda``
    unless ``cpu`` is asked for) and the fetch of its result: the floor of
    ``time_fn_total``."""
    x = torch.zeros(1, dtype=torch.float32, device=resolve_device(device))
    fetch(x + 1.0)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fetch(x + 1.0)
        best = min(best, time.perf_counter() - t0)
    return best
