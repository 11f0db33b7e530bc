"""Sharded checkpoint save (counterpart of
``paddle_tpu/distributed/checkpoint/save_state_dict.py``).

Each rank saves the boxes it owns (``jit.redistribute.is_owner``: one
writer per box) with their global offsets to ``{rank}_0.distcp``; the
coordinator writes the global :class:`Metadata` index, which holds every
rank's shard entries (gathered to it first), to ``{rank}.metadata`` last,
after every rank's data file landed; no rank returns before it did, and a
failed write on any rank raises on every rank.  Both files are written
through ``_atomic_pickle`` (temp + ``os.replace``), so a crash never
presents a truncated pickle as a checkpoint.
"""
from __future__ import annotations

import os
import threading
from typing import Dict

from ...framework_io import _atomic_pickle
from ...testing.faults import fault_point
from ..comm_watchdog import comm_task
from .manager import _snapshot_value
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata

__all__ = ["save_state_dict"]


def _shard_info(value, rank: int) -> list:
    """[(global_offset, local_shape, storable array, dtype_name)] of what
    ``rank`` writes of ``value`` (a tensor, a numpy array or a
    ``Placed`` slice)."""
    return [(off, shape, arr, dt)
            for off, shape, dt, arr in _snapshot_value(value, rank)]


def save_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id=None, async_save=False):
    """Save ``state_dict`` under ``path`` (every rank of ``process_group``
    calls it).  ``async_save=True`` snapshots on the calling thread and
    writes the data file on a background thread; the returned handle's
    ``join()`` re-raises a failure, then waits for every rank (on the
    caller's thread) and has the coordinator write the metadata."""
    import torch.distributed as dist
    os.makedirs(path, exist_ok=True)
    joined = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if joined else 0
    world = dist.get_world_size(process_group) if joined else 1
    meta = Metadata()
    payload = {}
    fname = f"{rank}_0.distcp"
    with comm_task("save_state_dict.gather"):
        for key, t in state_dict.items():
            metas = []
            for offset, shape, store, dtype_name in _shard_info(t, rank):
                metas.append(LocalTensorMetadata(offset, shape, dtype_name))
                meta.storage_metadata[LocalTensorIndex(key, offset)] = fname
                payload[(key, offset)] = (store, dtype_name)
            meta.state_dict_metadata[key] = metas
        if world > 1:
            parts = [None] * world
            dist.all_gather_object(parts, (meta.state_dict_metadata,
                                           meta.storage_metadata),
                                   group=process_group)
            meta = Metadata()
            for sdm, stm in parts:
                for key, metas in sdm.items():
                    meta.state_dict_metadata.setdefault(key, []).extend(
                        metas)
                meta.storage_metadata.update(stm)

    def _write():
        fault_point("ckpt.write")
        _atomic_pickle(payload, os.path.join(path, fname))

    def _agree(error, what):
        """Raise on every rank when ``what`` failed on any of them (so
        no rank waits for good on one that raised)."""
        mine = None if error is None else repr(error)
        errs = [mine]
        if world > 1:
            errs = [None] * world
            with comm_task("save_state_dict." + what):
                dist.all_gather_object(errs, mine, group=process_group)
        if error is not None:
            raise error
        failed = {r: e for r, e in enumerate(errs) if e is not None}
        if failed:
            raise RuntimeError("save_state_dict: the %s failed on rank(s) "
                               "%s" % (what, failed))

    def _finish(error=None):
        _agree(error, "write")       # every rank's data file landed
        if rank == coordinator_rank:
            try:
                fault_point("ckpt.manifest")
                _atomic_pickle(meta, os.path.join(path, f"{rank}.metadata"))
            except Exception as e:                    # noqa: BLE001
                error = e
        _agree(error, "metadata")    # the checkpoint is whole on return

    if async_save:
        handle = _AsyncSaveHandle(_write, _finish)
        handle.start()
        return handle
    error = None
    try:
        _write()
    except Exception as e:                            # noqa: BLE001
        error = e
    _finish(error)
    return None


class _AsyncSaveHandle(threading.Thread):
    """Background write whose failure surfaces on ``join()`` — a caller
    must never believe a checkpoint landed when the write died; the
    ranks' exchange of their write status and the metadata write run in
    ``join()``, on the caller's thread, and a failure on any rank raises
    on every rank."""

    def __init__(self, fn, finish):
        super().__init__(name="save-state-dict", daemon=True)
        self._fn = fn
        self._finish = finish
        self.error = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:                    # noqa: BLE001
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.is_alive() or self._finish is None:
            return
        finish, self._finish = self._finish, None
        err, self.error = self.error, None
        finish(err)
