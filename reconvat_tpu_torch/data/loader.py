"""Batching, background assembly and device prefetch (the port's
counterpart of `reconvat_tpu/data/loader.py`).

A host-side numpy batcher whose assembly (crops, label masks, stacking)
runs in a background thread, so it overlaps the device's steps, and
`prefetch_to_device`, which keeps the next batches' host-to-device copies
in flight on a side stream while the current step runs. The batch order
and contents for a seed are the JAX package's.
"""
from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

BATCH_KEYS = ("audio", "onset", "offset", "frame", "velocity")


def collate(items):
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if key in BATCH_KEYS:
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals if len(vals) > 1 else vals[0]
    return batch


def device_batch(batch):
    """The batch's arrays without its metadata (paths, crop offsets)."""
    return {k: v for k, v in batch.items() if k in BATCH_KEYS}


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, drop_last=False,
                 seed=0, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def __iter__(self):
        if self.prefetch <= 0:
            for idx in self._index_batches():
                yield collate([self.dataset[j] for j in idx])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        end = object()
        failure = []

        def producer():
            try:
                for idx in self._index_batches():
                    q.put(collate([self.dataset[j] for j in idx]))
            except BaseException as e:   # re-raised in the consumer
                failure.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]


def cycle(loader):
    """Endless re-iteration (reference `helper_functions.cycle`); raises
    when the loader yields no batch, where the reference spins forever."""
    if len(loader) == 0:
        raise ValueError(
            f"DataLoader yields 0 batches: dataset has {len(loader.dataset)}"
            f" item(s) < batch_size={loader.batch_size} with drop_last —"
            " lower the batch size or provide more files")
    while True:
        yield from loader


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the iterator's batches with their arrays as tensors on
    `device`, keeping `size` batches' copies in flight ahead of the
    consumer (the copy of batch i+1 overlaps the step on batch i).

    On CUDA each array is staged in pinned host memory and copied with
    `non_blocking=True` on a side stream; the consumer's stream waits on
    that copy's event before it gets the batch, and each device tensor is
    recorded on the consumer's stream, so the allocator does not hand its
    memory to a later copy while a step still reads it. The pinned staging
    tensors are held until their batch is yielded, after which PyTorch's
    pinned allocator reuses one only once the copy that reads it has
    completed. Metadata (paths, crop offsets) passes through as it is."""
    device = torch.device(device)
    pending = collections.deque()
    if device.type != "cuda":
        for batch in iterator:
            yield {k: (torch.from_numpy(np.asarray(v)).to(device)
                       if k in BATCH_KEYS else v) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items() if k in BATCH_KEYS}
        with torch.cuda.stream(stream):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return {**batch, **dev}, host, done

    def take():
        batch, _host, done = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for k in BATCH_KEYS:
            if k in batch:
                batch[k].record_stream(consumer)
        return batch

    for batch in iterator:
        pending.append(put(batch))
        if len(pending) >= size:
            yield take()
    while pending:
        yield take()


class MappedLoader:
    """A sized loader whose batches pass through `fn` (the data-parallel
    full-epoch sweep's `parallel.mesh.shard_batch`, train/driver.py)."""

    def __init__(self, loader, fn):
        self.loader = loader
        self.fn = fn

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield self.fn(batch)
