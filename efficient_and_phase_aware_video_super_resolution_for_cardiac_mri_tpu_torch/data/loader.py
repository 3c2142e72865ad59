"""Host data loader: deterministic, threaded, prefetching.

Items are fetched by a thread pool (gzip inflate and numpy slicing release the
GIL) with bounded in-order prefetch.  ``set_epoch(seed)`` fixes the shuffle
order and the per-item augmentation Generators.  Batches are dicts of stacked
numpy arrays, e.g. ``lr_imgs: (B, T, H, W, C)``; the predictor moves them to
the device.

Under a data mesh (``set_mesh``) every rank walks the same order and loads
only its contiguous slice of each global batch (``parallel.batch_slice``;
the whole batch when the data size does not divide it, and then
``sharded`` is False).  Each item draws from its own Generator, a function
of (epoch seed, index), so a rank's slice holds exactly the items the
single-process loader would put there.  ``set_item_shard(i, n)`` instead
deals whole items round-robin (the predictors' split of the sequences).
"""
from __future__ import annotations

import inspect
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..config import DATALOADERS
from ..parallel.mesh import batch_slice, is_sharded
from ..utils.seeding import item_rng


def default_collate(items: list[dict]) -> dict:
    batch: dict = {}
    for key in items[0]:
        values = [item[key] for item in items]
        if isinstance(values[0], np.ndarray):
            batch[key] = np.stack(values)
        else:
            batch[key] = np.asarray(values)
    return batch


@DATALOADERS.register()
class Dataloader:
    """Iterable over collated batches with threaded prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 0,
        drop_last: bool = False,
        collate_fn=None,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch_seed = 0
        self.mesh = None
        self._item_shard = (0, 1)
        #: whether the last batch yielded is a slice of its global batch
        self.sharded = False
        self._getitem_takes_rng = "rng" in inspect.signature(type(dataset).__getitem__).parameters

    def set_epoch(self, seed: int) -> None:
        """Fix the epoch's shuffle order + augmentation randomness."""
        self.epoch_seed = int(seed)

    def set_mesh(self, mesh) -> None:
        """Yield this rank's slice of every global batch of ``mesh``'s data axis."""
        self.mesh = mesh

    def set_item_shard(self, index: int, count: int) -> None:
        """Walk only the items ``index``, ``index + count``, … of the order."""
        self._item_shard = (int(index), int(count))

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.epoch_seed).shuffle(order)
        index, count = self._item_shard
        return order[index::count]

    def _fetch(self, index: int) -> dict:
        if self._getitem_takes_rng:
            return self.dataset.__getitem__(int(index), rng=item_rng(self.epoch_seed, int(index)))
        return self.dataset[int(index)]

    def _batches(self, order: np.ndarray):
        n = len(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, limit, self.batch_size):
            idxs = order[start : start + self.batch_size]
            yield idxs[batch_slice(len(idxs), self.mesh)], is_sharded(len(idxs), self.mesh)

    def __iter__(self):
        order = self._order()
        if self.num_workers == 0:
            for idxs, self.sharded in self._batches(order):
                yield self.collate_fn([self._fetch(i) for i in idxs])
            return

        # per-item futures: all workers load items of the next batches
        # concurrently; batches are assembled and yielded strictly in order
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            batches = self._batches(order)

            def submit_next():
                idxs, sharded = next(batches)
                pending.append((sharded, [pool.submit(self._fetch, i) for i in idxs]))

            try:
                for _ in range(self.prefetch_batches + 1):
                    submit_next()
            except StopIteration:
                pass
            while pending:
                sharded, futures = pending.pop(0)
                batch = self.collate_fn([f.result() for f in futures])
                try:
                    submit_next()
                except StopIteration:
                    pass
                self.sharded = sharded
                yield batch
