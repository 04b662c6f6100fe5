"""paddle.io (paddle_tpu/io/__init__.py): datasets, samplers,
BatchSampler, DistributedBatchSampler, default_collate_fn and DataLoader.

Batches are made on the host (numpy) and become Tensors on the default
place as they are collated, so a model on the card is fed from host data.
DataLoader runs in process with ``num_workers=0`` and on a pool of threads
otherwise (batches in order, at most ``num_workers * prefetch_factor`` in
flight). The reference's shared-memory worker processes need its native
ring (utils/native.py, csrc/pt_runtime.cpp), which the port has not yet
(ROADMAP.md, queue 1, item 10d); where that ring is missing the reference
takes the thread route, and so does the port. RandomSampler is unseeded,
as the reference's; DistributedBatchSampler shuffles from its epoch.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.tensor import Tensor
from ..framework.random import default_seed

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "DataLoader",
           "get_worker_info", "SubsetRandomSampler", "ConcatDataset",
           "default_collate_fn"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * f)) for f in lengths]
        lengths[-1] += n - sum(lengths)
    total = sum(lengths)
    perm = np.random.RandomState(default_seed() % (2 ** 31)).permutation(
        total)
    out = []
    offset = 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self._epoch = 0

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState()
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(
            weights.numpy() if isinstance(weights, Tensor) else weights,
            np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards indices across data-parallel ranks (reference:
    python/paddle/io/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        from ..distributed import get_rank, get_world_size

        self.nranks = num_replicas if num_replicas is not None \
            else get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def get_worker_info():
    """None: thread workers share the process (the reference sets it only
    in its shared-memory worker processes)."""
    return None


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (Tensor,)):
        return Tensor(np.stack([np.asarray(s.numpy()) for s in batch]))
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return Tensor(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return Tensor(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return tuple(default_collate_fn(list(col)) for col in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


class DataLoader:
    """Host data pipeline: in process with ``num_workers=0``, else a pool
    of ``num_workers`` threads fetching ahead of the step loop (numpy
    decoding releases the GIL for the common image and tokenize cases).
    ``use_shared_memory`` is taken and not used (see the module's
    docstring)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.timeout = timeout
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self._iterable = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable:
            raise RuntimeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self._iterable:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        yield from self._iter_workers()

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield self.collate_fn(batch)

    def _iter_workers(self):
        import concurrent.futures

        from ..core.place import get_device, set_device

        max_in_flight = self.num_workers * self.prefetch_factor
        # the default place is per thread: the workers collate onto the
        # caller's
        with concurrent.futures.ThreadPoolExecutor(
                self.num_workers, initializer=set_device,
                initargs=(get_device(),)) as ex:
            pending = {}
            it = iter(self.batch_sampler)
            next_submit = 0
            next_yield = 0
            exhausted = False
            while True:
                while not exhausted and len(pending) < max_in_flight:
                    try:
                        indices = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending[next_submit] = ex.submit(self._fetch, indices)
                    next_submit += 1
                if next_yield not in pending:
                    if exhausted:
                        return
                    continue
                fut = pending.pop(next_yield)
                next_yield += 1
                yield fut.result(timeout=self.timeout or None)


class SubsetRandomSampler(Sampler):
    """Sample the given indices in random order (reference
    io/sampler.py SubsetRandomSampler)."""

    def __init__(self, indices, generator=None):
        if len(indices) == 0:
            raise ValueError("indices must not be empty")
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        perm = np.random.permutation(len(self.indices))
        return iter([self.indices[i] for i in perm])

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    """Concatenation of map-style datasets (reference io/dataset.py
    ConcatDataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets should not be an empty iterable")
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            if idx < -len(self):
                raise ValueError("index out of range")
            idx += len(self)
        import bisect

        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds - 1] if ds > 0 else 0
        return self.datasets[ds][idx - prev]
