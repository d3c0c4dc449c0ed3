"""Batched host data pipeline with background prefetch.

Replaces the reference's torch DataLoader + DistributedSampler.  Decode and
resize run on a thread pool (PIL releases the GIL in both), batches are
assembled as contiguous NHWC numpy arrays, and a bounded queue keeps
``prefetch`` batches ready ahead of the consumer.  Per-process sharding for
data-parallel training and validation gives each process its rows of every
global batch of the one-process order (where the JAX package's loader takes
DistributedSampler's stripe of the epoch permutation: the port's ranks are
the devices of JAX's one-host data mesh, which split each global batch).
The port's own copy of the JAX package's data/loader.py; ``device_prefetch``
moves each batch to the trainer's device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


class BatchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_threads: int = 4,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1, native_decode: bool = False,
                 microbatches: int = 1):
        """With process_count > 1, batch b of every process holds its rows
        (``parallel.mesh.local_batch_rows`` with ``microbatches``) of batch
        b of a one-process loader of batch ``batch_size * process_count``,
        so that the data-parallel ranks together run the one-process
        batches, and a train step with ``microbatches`` accumulation steps
        sees JAX's microbatches.  A partial last batch (drop_last False) is
        padded by repeating its own last sample, marked ``is_pad``: a
        duplicate of a row of the same batch moves no batch-global
        statistic, and the scores count each sample once."""
        self.dataset = dataset
        self.batch_size = batch_size
        # native batched JPEG decode (io/native_loader) replaces PIL per-item
        # when the dataset exposes image_path()/meta() and the .so builds
        self.native_decode = native_decode and hasattr(dataset, "image_path")
        if self.native_decode:
            from vision_transformer_cam_tpu_torch.io import native_loader
            self.native_decode = native_loader.available()
            self._native = native_loader
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.process_index = process_index
        self.process_count = process_count
        self.microbatches = microbatches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """DistributedSampler.set_epoch equivalent: reshuffle per epoch."""
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        return self._epoch_indices_with_pad()[0]

    def _epoch_indices_with_pad(self):
        """(indices, is_pad): this process's rows of the epoch permutation,
        global batch after global batch, so that every process runs the
        same number of steps (required for the collective train step)."""
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.process_count > 1:
            return self._global_stripe(idx)
        return idx, np.zeros(n, bool)

    def _global_stripe(self, idx):
        from vision_transformer_cam_tpu_torch.parallel.mesh import (
            local_batch_rows)
        pc, mbs = self.process_count, self.microbatches
        g = self.batch_size * pc
        parts, pads = [], []
        for lo in range(0, len(idx), g):
            rows = idx[lo:lo + g]
            pad = np.zeros(len(rows), bool)
            if len(rows) < g:
                if self.drop_last:
                    break
                full = -(-len(rows) // (pc * mbs)) * pc * mbs
                pad = np.arange(full) >= len(rows)
                rows = np.concatenate(
                    [rows, np.full(full - len(rows), rows[-1])])
            take = local_batch_rows(len(rows), pc, self.process_index, mbs)
            parts.append(rows[take])
            pads.append(pad[take])
        if not parts:
            return idx[:0], np.zeros(0, bool)
        return np.concatenate(parts), np.concatenate(pads)

    def __len__(self):
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idx, is_pad = self._epoch_indices_with_pad()
        # batch count from the indices just built (len(self) would redo the
        # permutation+stripe work and could silently drift from idx)
        nb = len(idx) // self.batch_size if self.drop_last \
            else -(-len(idx) // self.batch_size)
        emit_pad = self.process_count > 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def collate(items):
            batch = {"name": [it["name"] for it in items],
                     "image": np.stack([it["image"] for it in items])}
            if "label" in items[0]:
                batch["label"] = np.stack([it["label"] for it in items])
            if "seg_label" in items[0]:
                # seg labels keep native size; batch=1 paths use them directly
                segs = [it["seg_label"] for it in items]
                batch["seg_label"] = np.stack(segs) if len(
                    {s.shape for s in segs}) == 1 else segs
            return batch

        def native_batch(sl):
            ds = self.dataset
            try:
                imgs = self._native.decode_batch(
                    [ds.image_path(i) for i in sl], ds.img_size,
                    tuple(ds.mean), tuple(ds.std), self.num_threads)
            except ValueError:
                # libjpeg rejects files PIL would accept (CMYK JPEGs, a PNG
                # with a .jpg extension): fall back to the per-item PIL path
                # for this batch instead of aborting the run
                return collate([ds[i] for i in sl])
            items = [dict(ds.meta(i), image=imgs[j])
                     for j, i in enumerate(sl)]
            return collate(items)

        def offer(item) -> bool:
            """Bounded put that keeps checking `stop`: a plain q.put would
            block forever if the consumer abandons iteration while the queue
            is full."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        error: list = []

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        lo, hi = b * self.batch_size, (b + 1) * self.batch_size
                        sl = idx[lo:hi]
                        if self.native_decode:
                            batch = native_batch(sl)
                        else:
                            batch = collate(list(pool.map(
                                self.dataset.__getitem__, sl)))
                        if emit_pad:
                            batch["is_pad"] = is_pad[lo:hi].copy()
                        if not offer(batch):
                            return
            except Exception as e:  # surface decode errors to the consumer
                error.append(e)
            offer(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if error:
                        raise error[0]
                    return
                yield batch
        finally:
            stop.set()


def device_prefetch(iterator, device, size: int = 2):
    """Move each batch's ``image`` and ``label`` arrays to ``device`` as
    tensors, keeping ``size`` batches in flight so that the copy to the
    device overlaps the step before it (the copies are asynchronous from
    pinned memory on a CUDA device)."""
    import collections

    import torch

    device = torch.device(device)

    def put(batch):
        out = dict(batch)
        for k in ("image", "label"):
            if isinstance(out.get(k), np.ndarray):
                t = torch.from_numpy(out[k])
                if device.type == "cuda":
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=True)
        return out

    buf = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
