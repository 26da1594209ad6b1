"""DataLoader for one process: shuffling, batching, threaded prefetch
(counterpart of ``spiking_fullsubnet_tpu/data/loader.py`` without its
per-process sharding, which comes back on ``torch.distributed``).

Semantics kept from the JAX loader, batch for batch:
- a per-epoch shuffle, ``np.random.default_rng(seed + epoch).permutation``;
- drop_last;
- numpy collation: arrays stacked, scalars to arrays, strings to lists.

Batches are numpy; the trainer moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples into batch arrays (tuple/dict aware)."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, str):
        return list(samples)
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(samples)
    return list(samples)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        collate_fn: Optional[Callable] = None,
        seed: int = 0,
        prefetch: int = 2,
        **_ignored,  # torch-only kwargs in reference TOMLs (pin_memory, ...)
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self.epoch = 0
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> List[int]:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n).tolist()
        return list(range(n))

    def __iter__(self) -> Iterator[Any]:
        indices = self._indices()
        batches = [indices[i: i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers <= 0:
            for b in batches:
                yield self.collate_fn([self.dataset[i] for i in b])
            return

        yield from self._threaded_iter(batches)

    def _threaded_iter(self, batches: List[List[int]]):
        """Decode in a pool of ``num_workers`` threads, ``prefetch`` batches
        ahead; a worker's exception is raised in the consumer."""
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stopped early reads no more: never block on it
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in batches:
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        if not put(("ok", self.collate_fn(samples))):
                            return
                put(("done", None))
            except Exception as e:  # surfaced to the consumer, which raises it
                put(("err", e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            t.join()
