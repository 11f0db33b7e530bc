"""The DataLoader's worker process (counterpart of
``paddle_tpu/io/worker.py``).

A worker is forked from a parent that may have initialised CUDA and runs
other threads, so it touches only numpy and its ring: it reads its share
of the samples, collates them to numpy (``collate_numpy``, when the
loader collates by default; otherwise the raw samples travel and the
parent runs the loader's ``collate_fn``) and writes each batch as one
frame to its own shared-memory ring.  The parent makes the tensors.
An error in a worker travels as an ``E`` frame; a worker that cannot
send it exits nonzero, and the parent's watchdog reports the death.
"""
from __future__ import annotations

import os
import pickle
import traceback

import numpy as np

BATCH, COLLATED, ERROR = b"B", b"C", b"E"


def to_plain(x):
    """``x`` with API Tensors as numpy arrays (a dataset that returns
    tensors; it should return numpy)."""
    if hasattr(x, "_value") and hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    if isinstance(x, (list, tuple)):
        out = [to_plain(i) for i in x]
        return tuple(out) if isinstance(x, tuple) else out
    if isinstance(x, dict):
        return {k: to_plain(v) for k, v in x.items()}
    return x


def worker_loop(dataset, my_batches, prefix, capacity, worker_id,
                num_workers, worker_init_fn, iterable, batch_size,
                drop_last, collate_in_worker):
    """The forked worker's body; it ends the process."""
    from . import dataloader as dl_mod
    from .shm_ring import ShmRing, encode_batch

    ring = ShmRing(f"/{prefix}-{worker_id}", capacity, owner=False)
    dl_mod._worker_info = dl_mod.WorkerInfo(worker_id, num_workers, dataset)
    code = 0

    def send(samples):
        samples = to_plain(samples)
        if collate_in_worker:
            ring.send_msg(encode_batch(dl_mod.collate_numpy(samples),
                                       COLLATED))
        else:
            ring.send_msg(encode_batch(samples, BATCH))

    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if iterable:
            # every worker iterates the whole stream; a dataset shards
            # itself through get_worker_info() (the reference's rule)
            batch = []
            for sample in dataset:
                batch.append(sample)
                if len(batch) == (batch_size or 1):
                    send(batch)
                    batch = []
            if batch and not drop_last:
                send(batch)
        else:
            for batch_idx in my_batches:
                send([dataset[i] for i in batch_idx])
    except BaseException:     # sent to the parent, which raises it
        try:
            ring.send_msg(ERROR + pickle.dumps(traceback.format_exc()))
        except BaseException:
            # unsent: exit nonzero without hanging up, and the parent's
            # watchdog reports the death
            code = 1
    finally:
        if code == 0:
            ring.close_write()
        ring.detach()
        os._exit(code)        # no atexit handlers in a forked child
