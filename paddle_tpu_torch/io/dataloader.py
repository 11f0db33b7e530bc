"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``).

- ``num_workers=0``: samples are read and collated in the caller's
  thread.
- ``num_workers > 0`` (shared memory, the default): forked worker
  processes, each writing its batches to its own shared-memory ring
  (``shm_ring``; the C++ ring builds at first use, and a failed build
  raises).  A worker collates to numpy when the loader collates by
  default, so a child never touches torch; the parent reads the rings
  round robin (map-style order is kept), makes the tensors on the current
  device (the card unless the caller chose the CPU) and counts the frames
  and their bytes (``ring_frames``, ``ring_bytes``).  A watchdog raises
  when a worker dies; an error in a worker is raised here.
- ``num_workers > 0`` with ``use_shared_memory=False``: worker threads
  feeding a bounded prefetch queue.

Nothing falls back from one path to another.  The wait for each batch is
observed in the ``dataloader_queue_wait_seconds`` histogram, and
``state_dict``/``set_state_dict`` resume an epoch where it stopped.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..core.tensor import Tensor
from .dataset import IterableDataset
from .sampler import BatchSampler


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    dataset: Any


_worker_info: Optional[WorkerInfo] = None


def get_worker_info():
    return _worker_info


def _queue_wait_histogram():
    """The consumer's wait for the next batch: about 0 while the loader
    keeps ahead of the device; a fat tail means the data path is the
    bottleneck."""
    from ..observability.metrics import histogram
    return histogram(
        "dataloader_queue_wait_seconds",
        "time the consumer blocked waiting on the prefetch queue/ring")


def collate_numpy(batch):
    """``default_collate_fn`` before the tensors: arrays stacked, ints
    int64, floats float32, sequences and dicts collated field by field,
    strings kept as lists."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return [collate_numpy(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: collate_numpy([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    return batch


def to_tensors(tree):
    """Every numpy array of ``tree`` as a Tensor on the current device."""
    if isinstance(tree, np.ndarray):
        return Tensor(tree)
    if isinstance(tree, list):
        return [to_tensors(x) for x in tree]
    if isinstance(tree, dict):
        return {k: to_tensors(v) for k, v in tree.items()}
    return tree


def default_collate_fn(batch):
    """Stack samples into batch tensors."""
    return to_tensors(collate_numpy(batch))


class DataLoader:
    """``paddle.io.DataLoader`` (the module's notes)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self._default_collate = collate_fn is None
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(2, int(prefetch_factor))
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        # resumable-iterator state (fault-tolerant training): position
        # within the CURRENT epoch, and a pending fast-forward request
        self._batches_yielded = 0
        self._resume_skip = 0
        # frames (and their bytes) read from the workers' rings
        self.ring_frames = 0
        self.ring_bytes = 0
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle,
                batch_size=batch_size if batch_size is not None else 1,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()

    # -- resumable-iterator state ---------------------------------------
    def state_dict(self):
        """Position of the live iterator within its epoch — checkpoint
        this and feed it back through :meth:`set_state_dict` to resume
        mid-epoch.  (A consumer that prefetches ahead of its compute
        should instead record its own completed-step count and pass that
        to set_state_dict.)"""
        return {"batches_yielded": int(self._batches_yielded)}

    def set_state_dict(self, state):
        """Arm the NEXT ``iter()`` to fast-forward ``batches_yielded``
        batches.  Map-style single-process loading skips by advancing
        the sampler only (no sample is decoded); prefetch/worker paths
        decode-and-discard.  Deterministic resume additionally needs a
        deterministic sampler order (shuffle=False, or a seeded
        sampler)."""
        self._resume_skip = max(0, int(state.get("batches_yielded", 0)))

    def __iter__(self):
        skip, self._resume_skip = self._resume_skip, 0
        # position set EAGERLY: state_dict() between iter() and the
        # first next() must already report the fast-forwarded position,
        # not 0 (a preemption landing there would otherwise rewind the
        # whole epoch prefix on the following resume)
        self._batches_yielded = skip
        if self.num_workers > 0:
            gen = self._iter_multiprocess() if self.use_shared_memory \
                else self._iter_iterable() if self._iterable \
                else self._iter_prefetch()
            return self._count(self._discard(gen, skip))
        if self._iterable:
            return self._count(self._discard(self._iter_iterable(), skip))
        return self._count(self._iter_single(skip))

    def _count(self, gen):
        for item in gen:
            # count BEFORE handing the batch out: a consumer that
            # checkpoints state_dict() after training on batch k must
            # see position k+1, not k (or resume would replay a batch)
            self._batches_yielded += 1
            yield item

    @staticmethod
    def _discard(gen, skip):
        """Lazily drop the first ``skip`` batches (the generic resume
        path for worker-backed iterators, where batch k's bytes only
        exist by producing batches 0..k-1)."""
        for i, item in enumerate(gen):
            if i >= skip:
                yield item

    # -- multi-process workers over native shm rings --------------------------
    def _iter_multiprocess(self):
        """Worker processes over the shared-memory rings (the module's
        notes)."""
        import multiprocessing as mp
        import pickle
        import uuid

        from .shm_ring import ShmRing, decode_batch
        from .worker import COLLATED, ERROR, worker_loop

        W = self.num_workers
        capacity = int(os.environ.get("FLAGS_dataloader_ring_bytes",
                                      str(64 << 20)))
        prefix = f"ptt-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        rings = [ShmRing(f"/{prefix}-{w}", capacity, owner=True)
                 for w in range(W)]
        if self._iterable:
            shards = [None] * W
        else:
            batches = list(self.batch_sampler)
            shards = [batches[w::W] for w in range(W)]
        ctx = mp.get_context("fork")
        procs = []
        try:
            for w in range(W):
                p = ctx.Process(
                    target=worker_loop,
                    args=(self.dataset, shards[w], prefix, capacity, w, W,
                          self.worker_init_fn, self._iterable,
                          self.batch_size if self._iterable else None,
                          self.drop_last if self._iterable else False,
                          self._default_collate),
                    daemon=True)
                p.start()
                procs.append(p)
            wait_hist = _queue_wait_histogram()
            alive = [True] * W
            w = 0
            while any(alive):
                if not alive[w]:
                    w = (w + 1) % W
                    continue
                t_wait = time.perf_counter()
                while True:
                    try:
                        msg = rings[w].recv_msg(timeout_us=1_000_000)
                        break
                    except ShmRing.Timeout:
                        # a killed worker never hangs up its ring
                        if not procs[w].is_alive():
                            raise RuntimeError(
                                "DataLoader worker %d died unexpectedly "
                                "(exitcode=%s)" % (w, procs[w].exitcode))
                wait_hist.observe(time.perf_counter() - t_wait)
                if msg is None:            # this worker's clean EOF
                    alive[w] = False
                    w = (w + 1) % W
                    continue
                tag = msg[:1].tobytes()
                if tag == ERROR:
                    raise RuntimeError("DataLoader worker %d failed:\n%s"
                                       % (w, pickle.loads(msg[1:].tobytes())))
                self.ring_frames += 1
                self.ring_bytes += msg.nbytes
                batch = decode_batch(msg, 1)
                yield to_tensors(batch) if tag == COLLATED \
                    else self.collate_fn(list(batch))
                w = (w + 1) % W
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
            for r in rings:
                r.detach()
                r.unlink()

    # -- single process ------------------------------------------------------
    def _iter_single(self, skip=0):
        # resume fast-forward: advance the sampler WITHOUT touching the
        # dataset — skipping 10k batches costs index arithmetic, not I/O
        for n, batch_idx in enumerate(self.batch_sampler):
            if n < skip:
                continue
            samples = [self.dataset[i] for i in batch_idx]
            yield self.collate_fn(samples)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == (self.batch_size or 1):
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    # -- threaded prefetch (use_shared_memory=False) ------------------------
    def _iter_prefetch(self):
        q: "queue.Queue" = queue.Queue(
            maxsize=self.num_workers * self.prefetch_factor)
        sentinel = object()
        # a consumer that stops early (break / exception / gc of this
        # generator) sets `stop`; the producer's bounded put polls it so
        # it can never block forever on a full queue the consumer will
        # never drain again
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            global _worker_info
            _worker_info = WorkerInfo(0, self.num_workers, self.dataset)
            if self.worker_init_fn:
                self.worker_init_fn(0)
            pool = ThreadPoolExecutor(self.num_workers)
            try:
                def load(batch_idx):
                    samples = [self.dataset[i] for i in batch_idx]
                    return self.collate_fn(samples)

                # bounded submission window (Executor.map would submit
                # the WHOLE sampler eagerly, letting finished batches
                # pile up in memory ahead of a slow consumer — the queue
                # bound must also bound the in-flight work)
                from collections import deque
                window = q.maxsize + self.num_workers
                pending: "deque" = deque()
                sampler_it = iter(self.batch_sampler)
                exhausted = False
                while pending or not exhausted:
                    while not exhausted and len(pending) < window \
                            and not stop.is_set():
                        try:
                            pending.append(
                                pool.submit(load, next(sampler_it)))
                        except StopIteration:
                            exhausted = True
                    if not pending:
                        break
                    if not _put(pending.popleft().result()):
                        return
            except Exception as e:  # surface worker errors to the consumer
                _put(e)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
                # the threads' worker info ends with them
                _worker_info = None
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="ptt-dataloader-prefetch")
        t.start()
        wait_hist = _queue_wait_histogram()
        try:
            while True:
                t_wait = time.perf_counter()
                item = q.get()
                wait_hist.observe(time.perf_counter() - t_wait)
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a put blocked on the full queue returns promptly
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
