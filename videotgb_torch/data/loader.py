"""Threaded prefetching data loader (the port's copy of
``videotgb_tpu/data/loader.py``: the same batches in the same order).

Replaces torch DataLoader workers (reference datamodules' num_workers +
pin_memory, src/data/videoinstruct_datamodule.py:154-194) with a
thread-pool sample fetcher + a bounded prefetch queue: video decode is
GIL-releasing (cv2/numpy), so threads overlap decode with the device's
steps — the decode-bound reference pipeline (19.3 s/video, BASELINE.md) is
the motivation for prefetch depth > 1.

In a data-parallel run each rank passes its ``(rank, world)``: the global
batches keep the order the seed gives them at every world size, each of
``batch_size`` rows (the global batch, as the JAX CLI's ``data.batch_size``
is), and a rank loads and yields its contiguous ``batch_size / world`` rows
of each, the placement of ``parallel.sharding.shard_batch``. ``len()`` is
the number of global batches, the same on every rank.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch


class PrefetchLoader:
    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        collate_fn: Callable[[list], dict],
        shuffle: bool = True,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world or not 0 <= rank < world:
            raise ValueError(f"a global batch of {batch_size} rows does not "
                             f"split over {world} ranks (rank {rank})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.rank, self.world = rank, world
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> list[list[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        cut = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)
        idx = idx[:cut]
        rows = self.batch_size // self.world
        lo = self.rank * rows
        return [idx[i : i + self.batch_size][lo : lo + rows].tolist()
                for i in range(0, len(idx), self.batch_size)]

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        batches = self._batches()
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # consumer gone: abandon without blocking

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(self.dataset.__getitem__, batch_idx))
                        if not put(self.collate_fn(samples)):
                            return
                put(sentinel)
            except BaseException as e:  # noqa: BLE001 — surface in consumer:
                put(e)  # a dead producer must not hang out.get() forever

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # early break / generator close (trainer max_steps, early stop,
            # sweep trials): unblock and retire the producer instead of
            # leaking a thread + its worker pool per abandoned epoch
            stop.set()
            try:
                while True:
                    out.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)


def device_batch(batch: dict, device=None) -> dict:
    """Strip host-only keys (leading underscore); numpy arrays become
    tensors, on ``device`` when one is given."""
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in batch.items() if not k.startswith("_")}
