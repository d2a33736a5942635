"""Host-side input pipeline (counterpart of footprints_tpu/data/loader.py):
a threaded prefetching batch loader, a background writer, and a device
prefetcher that copies batches to the card on a side CUDA stream.

Samples are numpy arrays made by PIL, cv2 and numpy code that releases the
GIL, so a thread pool feeding a bounded window overlaps loading without
worker processes.  The shuffle is the JAX package's: one
``np.random.default_rng(seed)`` permutes the indices each epoch, so one seed
gives the same batches.
"""

import queue
import threading
from collections import deque

import numpy as np
import torch

from .. import telemetry


def collate(samples):
    """Stack a list of dict-of-array samples into a dict of batched arrays."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if np.isscalar(vals[0]) or np.asarray(vals[0]).ndim == 0:
            out[key] = np.asarray(vals)
        else:
            out[key] = np.stack(vals)
    return out


class DataLoader:
    """Iterates batches of collated numpy arrays with background threads.

    Optional shuffle per epoch; drop_last (the default when shuffling)
    keeps every batch the same shape.  Workers run at most
    ``prefetch_batches`` positions ahead of the consumer.

    ``shard=(rank, world)`` (data parallelism) keeps ``batch_size`` the
    global batch and yields only rows ``[rank*B/W, (rank+1)*B/W)`` of each
    global batch of the shared seeded permutation, so the ranks' rows
    together are world 1's batch.
    """

    def __init__(self, dataset, batch_size, *, shuffle=False, num_workers=4,
                 drop_last=None, seed=0, prefetch_batches=4, shard=(0, 1)):
        rank, world = shard
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} must divide over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch_batches = prefetch_batches
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_batches(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        rank, world = self.shard
        per = self.batch_size // world
        for b in range(len(self)):
            start = b * self.batch_size + rank * per
            yield indices[start:min(start + per, (b + 1) * self.batch_size)]

    def __iter__(self):
        batch_indices = list(self._epoch_batches())
        if not batch_indices:
            return
        n = len(batch_indices)
        cond = threading.Condition()
        results = {}  # pos -> ready batch; bounded by the prefetch window
        state = {"next_task": 0, "next_pos": 0, "error": None, "stop": False}

        def worker():
            while True:
                with cond:
                    while (not state["stop"] and state["error"] is None
                           and state["next_task"] < n
                           and state["next_task"]
                           >= state["next_pos"] + self.prefetch_batches):
                        cond.wait()
                    if state["stop"] or state["error"] or state["next_task"] >= n:
                        return
                    pos = state["next_task"]
                    state["next_task"] += 1
                try:
                    batch = collate([self.dataset[int(i)] for i in batch_indices[pos]])
                except Exception as e:  # surface promptly, not at pos's turn
                    with cond:
                        if state["error"] is None:
                            state["error"] = e
                        cond.notify_all()
                    return
                with cond:
                    results[pos] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for pos in range(n):
                with cond:
                    while pos not in results and state["error"] is None:
                        cond.wait()
                    if state["error"] is not None:
                        raise state["error"]
                    batch = results.pop(pos)
                    state["next_pos"] = pos + 1
                    cond.notify_all()  # reopen the prefetch window
                yield batch
        finally:
            with cond:
                state["stop"] = True
                cond.notify_all()


class BackgroundWriter:
    """One background thread draining a bounded queue of save thunks, so
    file writes overlap device work.  A thunk's error surfaces on the next
    submit() or on close().  Each thunk runs in a ``writer.write`` span
    (telemetry.py) with the unit of the span that submitted it, and
    close() waits for the last in ``writer.flush``."""

    def __init__(self, max_pending=64):
        self._q = queue.Queue(maxsize=max_pending)
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is None:  # after an error, drain without running
                unit, fn, args, kwargs = item
                try:
                    with telemetry.span("writer.write", unit=unit):
                        fn(*args, **kwargs)
                except Exception as e:
                    self._err = e

    def submit(self, fn, *args, **kwargs):
        if self._err is not None:
            raise self._err
        self._q.put((telemetry.current_unit(), fn, args, kwargs))

    def close(self):
        """Flush the queue, join the thread, re-raise any thunk error."""
        with telemetry.span("writer.flush"):
            self._q.put(None)
            self._t.join()
        if self._err is not None:
            raise self._err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            self.close()
        else:  # don't mask the in-flight exception; just stop the thread
            self._err = self._err or RuntimeError("aborted")
            self._q.put(None)
            self._t.join()


class DevicePrefetcher:
    """Wrap an iterator of host batches (dicts of numpy arrays) and keep
    ``depth`` batches already on ``device``, so the host->device copy
    overlaps the running step.  Each batch is yielded after ``decode``
    (run on the consumer's stream; identity by default).

    On CUDA each batch is copied from pinned host memory with
    ``non_blocking=True`` on a side stream.  On the CPU the arrays are
    wrapped without a copy.
    """

    def __init__(self, iterator, device, depth=2, decode=None):
        self.iterator = iter(iterator)
        self.device = torch.device(device)
        self.depth = depth
        self.decode = decode if decode is not None else (lambda b: b)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _put(self, host):
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in host.items()}
        if self._stream is None:
            return tensors, None
        pinned = {k: t.pin_memory() for k, t in tensors.items()}
        with torch.cuda.stream(self._stream):
            batch = {k: t.to(self.device, non_blocking=True)
                     for k, t in pinned.items()}
            copied = self._stream.record_event()
        # `pinned` rides along until the consumer has waited on `copied`:
        # a pinned buffer freed and reused while its copy is still in flight
        # would ship another batch's bytes
        return batch, (copied, pinned)

    def _take(self, entry):
        batch, pending = entry
        if pending is not None:
            copied, _ = pending
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(copied)
            # the tensors were allocated on the side stream: record their use
            # on the consumer stream, or the caching allocator may hand their
            # memory to the next batch's copy while the step still reads them
            for t in batch.values():
                t.record_stream(consumer)
        return self.decode(batch)

    def __iter__(self):
        buf = deque()
        for host in self.iterator:
            buf.append(self._put(host))
            if len(buf) > self.depth:
                yield self._take(buf.popleft())
        while buf:
            yield self._take(buf.popleft())
