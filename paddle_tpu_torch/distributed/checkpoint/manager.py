"""Async atomic checkpoint manager (counterpart of
``paddle_tpu/distributed/checkpoint/manager.py``).

A training job must survive preemption at any instant, so a checkpoint is
either complete and loadable or invisible.  The reference's design, kept:

- **Step-boundary snapshot, background write.**  ``save()`` does the
  device->host copies on the calling thread and returns only after they
  finished (the port's optimizer updates parameters and moments in
  place, so a copy still in flight when the next step starts would
  capture a half-updated state); a writer thread pickles, fsyncs and
  commits while training goes on.  ``wait()`` joins it and re-raises its
  failure on the caller's thread.
- **Atomicity via rename.**  Everything is written into
  ``<dir>/.tmp.<step>.<pid>/``, the CRC-carrying ``manifest.json`` last;
  one ``os.replace`` commits the directory to ``<dir>/step_<N>``.  A
  checkpoint is loadable iff its directory name is final and every file's
  size and CRC match its manifest.
- **Sharded state stays sharded.**  A value given as a
  ``jit.redistribute.Placed`` (a rank's slice, its spec, its mesh; what
  ``TrainStep.ckpt_values`` gives) is saved as this rank's box with its
  global offset, written by one rank per box: the rank at coordinate 0
  on every axis the spec does not shard over (a whole value: rank 0
  alone).  :func:`assemble` and :meth:`TrainState.box_tensor` put a
  value, or one rank's box of it, back together under any other
  placement (array redistribution, arXiv:2112.01075).
- **keep_last_k GC** that never deletes the newest complete checkpoint.

The layout is the reference's: ``step_<N>/manifest.json`` (``format``,
``step``, ``files`` with each file's ``crc32`` and ``size``, ``meta``)
and pickled payloads ``{key: [(offset, shape, dtype_name, ndarray)]}``,
bf16 as a uint16 view.  One process writes ``shards_0.distcp`` under
format 1, so the reference's manager and this one each read the other's.

Over ranks (in a joined world of more than one rank): the manager makes its own gloo group at construction (collective
over the world, in the same order on every rank), so its handshake never
shares a group with the training thread's collectives, and rank 0's pid,
broadcast over it, names the one staging directory.  Each rank's writer
thread writes ``shards_<rank>.distcp`` there, then the ranks gather every
file's size and CRC (or a failure) to all; rank 0 writes the manifest and
makes the single ``os.replace`` and the keep_last_k GC, then tells the
others; a failure on any rank leaves only the ``.tmp.*`` directory and
raises on every rank's ``wait()``.  Stale ``.tmp.*`` directories are
cleaned by rank 0 alone, at construction before the pid reaches the
others and after a commit before they hear of it, so never while another
rank writes.  Such a checkpoint is **format 2**: the reference's
``_validate`` accepts only format 1, and its ``load`` reads only
``shards_0.distcp``, so a multi-file checkpoint that called itself format
1 would load there as rank 0's shards alone with zeros in every other
box; under format 2 the reference's scan skips it instead.  Its
manifest also carries ``index`` (each payload file's keys with the
offset, shape and dtype of the one box the file holds of each), so a
loaded :class:`TrainState` reads a payload only when a value or box that
overlaps one of its boxes is asked for.

Metrics (the reference's five): ``checkpoint_save_duration_seconds``,
``checkpoint_written_bytes_total`` (this rank's payload file),
``checkpoint_commits_total``, ``checkpoint_gc_removed_total`` and
``checkpoint_failures_total``.  Fault points (``testing/faults.py``):
``ckpt.snapshot``, ``ckpt.gather``, ``ckpt.write``, ``ckpt.manifest``,
``ckpt.commit``.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...jit.redistribute import (Placed, box_overlap, is_owner, spec_box)
from ...testing.faults import fault_point
from ..comm_watchdog import comm_task

__all__ = ["CheckpointManager", "TrainState", "assemble", "assemble_box"]

_MANIFEST = "manifest.json"
_PAYLOAD = "shards_0.distcp"
_FORMAT = 1           # one payload: the reference's own format
_FORMAT_RANKS = 2     # one payload a rank (see the module notes)

Shard = Tuple[Tuple[int, ...], Tuple[int, ...], str, np.ndarray]


def _np_store(value) -> Tuple[np.ndarray, str]:
    """(a host copy as a storable numpy array, dtype name): a tensor is
    copied to the host (synchronously), bf16 as a uint16 view; anything
    else is copied as a numpy array."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.array(value, copy=True)
    return arr, arr.dtype.name


def _np_restore(arr: np.ndarray, dtype_name: str):
    """A stored array back: bf16 (a uint16 view) as a ``torch.bfloat16``
    tensor through an int16 view, anything else as the numpy array."""
    if dtype_name == "bfloat16":
        bits = _contiguous(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return arr


def _contiguous(arr: np.ndarray) -> np.ndarray:
    """``arr`` in C order, keeping its rank (``np.ascontiguousarray``
    makes a 0-d array 1-d)."""
    return arr if arr.flags.c_contiguous else arr.copy()


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(_contiguous(np.asarray(value)))


def _snapshot_value(value, rank: int = 0) -> List[Shard]:
    """[(global_offset, local_shape, dtype_name, host_array)] of what
    ``rank`` writes of ``value``: a ``Placed`` value's box when ``rank``
    owns it (one writer per box), a whole value on rank 0 alone."""
    if isinstance(value, Placed):
        if not is_owner(value.spec, value.mesh, rank):
            return []
        box = spec_box(value.shape, value.spec, value.mesh.axis_sizes(),
                       value.mesh.coords(rank))
        store, dt = _np_store(value.local)
        return [(tuple(lo for lo, _ in box), tuple(store.shape), dt, store)]
    if rank != 0:
        return []
    store, dt = _np_store(value)
    return [(tuple([0] * store.ndim), tuple(store.shape), dt, store)]


def _whole_shape(shards: List[Shard]) -> Tuple[int, ...]:
    ndim = len(shards[0][1])
    return tuple(max(off[d] + shp[d] for off, shp, _, _ in shards)
                 for d in range(ndim))


def assemble(shards: List[Shard]):
    """The whole value from its saved shards (numpy; bf16 as a
    ``torch.bfloat16`` tensor)."""
    if len(shards) == 1 and all(o == 0 for o in shards[0][0]):
        return _np_restore(shards[0][3], shards[0][2])
    return assemble_box(shards, tuple((0, n) for n in _whole_shape(shards)))


def assemble_box(shards: List[Shard], box):
    """Only ``box`` of the value (a rank's slice under another
    placement), from the shards that overlap it (zeros where none
    does)."""
    dtype_name = shards[0][2]
    pieces = []
    for off, shp, _, arr in shards:
        sbox = tuple((o, o + s) for o, s in zip(off, shp))
        ov = box_overlap(box, sbox)
        if ov is None:
            continue
        if ov == sbox == tuple(box):
            return _np_restore(arr, dtype_name)      # the very shard
        pieces.append((
            tuple(slice(a - b, c - b) for (a, c), (b, _) in zip(ov, box)),
            arr[tuple(slice(a - b, c - b) for (a, c), (b, _)
                      in zip(ov, sbox))]))
    shape = [hi - lo for lo, hi in box]
    covered = sum(int(a.size) for _, a in pieces) == int(np.prod(
        shape, dtype=np.int64))
    out = (np.empty if covered else np.zeros)(shape, shards[0][3].dtype)
    for dst, a in pieces:
        out[dst] = a
    return _np_restore(out, dtype_name)


class _Unread:
    """The array of a shard still in payload file ``path`` (a format-2
    checkpoint's index names each file's shards)."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path


def _box_of(shard) -> tuple:
    return tuple((o, o + s) for o, s in zip(shard[0], shard[1]))


class TrainState:
    """The full resumable state of one training run, as flat host data.

    arrays: key -> shard list (see :func:`_snapshot_value`), merged over
    every rank's payload; meta: JSON-able dict (``global_step``, ...).
    Loaded from a checkpoint with a per-file index, a shard's array is
    read with its payload file the first time a value or box that
    overlaps it is asked for, so a rank that restores reads only the
    payloads that hold its boxes."""

    def __init__(self, arrays: Dict[str, list], meta: Dict[str, Any]):
        self.arrays = arrays
        self.meta = meta
        self.read: List[str] = []        # payload files read on demand

    def _read(self, key: str, box=None) -> List[Shard]:
        """``key``'s shards (those overlapping ``box``), their payload
        files read where they were not yet."""
        shards = [sh for sh in self.arrays[key]
                  if box is None or box_overlap(tuple(box), _box_of(sh))
                  is not None]
        for path in {sh[3].path for sh in shards
                     if isinstance(sh[3], _Unread)}:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            self.read.append(path)
            for k, got in payload.items():
                held = {tuple(sh[0]): sh for sh in got}
                self.arrays[k] = [held.get(tuple(sh[0]), sh)
                                  if isinstance(sh[3], _Unread)
                                  and sh[3].path == path else sh
                                  for sh in self.arrays[k]]
        if box is None:
            return self.arrays[key]
        return [sh for sh in self.arrays[key]
                if box_overlap(tuple(box), _box_of(sh)) is not None]

    def global_value(self, key: str):
        return assemble(self._read(key))

    def global_tensor(self, key: str) -> torch.Tensor:
        return _as_tensor(self.global_value(key))

    def global_shape(self, key: str) -> Tuple[int, ...]:
        return _whole_shape(self.arrays[key])

    def box_tensor(self, key: str, box) -> torch.Tensor:
        """``box`` of the value (per-dim ``(start, stop)``), as a tensor."""
        return _as_tensor(assemble_box(self._read(key, box), box))


class _CrcWriter:
    """File-object shim accumulating crc32 and size as data streams
    through (the manifest digest without re-reading the payload)."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.size = 0

    def write(self, data):
        self.crc = zlib.crc32(data, self.crc) & 0xFFFFFFFF
        self.size += len(data)
        return self._f.write(data)


class CheckpointManager:
    """Async atomic checkpoints under one directory.

    Usage::

        mgr = CheckpointManager(ckpt_dir, keep_last_k=3)
        mgr.save(step, step_obj.ckpt_values(), {"global_step": step})
        ...                                   # returns after the copy
        mgr.wait()                            # join the in-flight write
        state = mgr.load()                    # newest valid TrainState
        step_obj.load_train_state(state)      # under any mesh

    In a joined world of more than one rank the manager is one of the
    world's ranks (module notes): construct it on every rank, in the same
    order.  Otherwise it reads and writes as one process.
    """

    def __init__(self, directory: str, keep_last_k: int = 3,
                 async_save: bool = True, prefix: str = "step"):
        import torch.distributed as dist
        self.directory = str(directory)
        self.keep_last_k = int(keep_last_k)
        self.async_save = bool(async_save)
        self.prefix = prefix
        joined = dist.is_available() and dist.is_initialized()
        self._dist = joined and dist.get_world_size() > 1
        self.rank = dist.get_rank() if joined else 0
        self.world = dist.get_world_size() if self._dist else 1
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.saved_steps: List[int] = []       # committed by THIS manager
        self.last_snapshot_bytes = 0
        from ...observability import default_registry
        r = default_registry()
        self._m_duration = r.histogram(
            "checkpoint_save_duration_seconds",
            "full write (pickle+fsync+commit) of one checkpoint; "
            "off-thread under async_save")
        self._m_bytes = r.counter(
            "checkpoint_written_bytes_total",
            "payload bytes committed to checkpoint storage")
        self._m_commits = r.counter(
            "checkpoint_commits_total",
            "checkpoints atomically committed (os.replace)")
        self._m_gc = r.counter(
            "checkpoint_gc_removed_total",
            "committed checkpoints removed by keep_last_k GC")
        self._m_failures = r.counter(
            "checkpoint_failures_total",
            "checkpoint writes that raised (sync or background)")
        self._group = None
        self._pid0 = os.getpid()
        if self._dist:
            self._group = dist.new_group(list(range(self.world)),
                                         backend="gloo")
            if self.rank == 0:
                self._clean_stale_tmp()
            pid = torch.tensor([os.getpid()], dtype=torch.int64)
            dist.broadcast(pid, src=0, group=self._group)
            self._pid0 = int(pid[0])
        else:
            self._clean_stale_tmp()

    # -- naming ---------------------------------------------------------------
    def _final_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{int(step)}")

    def _tmp_dir(self, step: int) -> str:
        return os.path.join(self.directory,
                            f".tmp.{int(step)}.{self._pid0}")

    def _step_of(self, name: str) -> Optional[int]:
        head = self.prefix + "_"
        if not name.startswith(head):
            return None
        try:
            return int(name[len(head):])
        except ValueError:
            return None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, values: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None, sync: bool = False):
        """Snapshot ``values`` (tensors, numpy arrays or ``Placed``
        slices; device->host on this thread, finished before the return)
        and commit them as checkpoint ``step``.  Async unless ``sync=True``
        or the manager was built with ``async_save=False``.

        Raises any error the previous background write hit, after which
        the manager is usable again."""
        self.wait()           # one write in flight; ordering preserved
        fault_point("ckpt.snapshot")
        with comm_task("ckpt.gather"):
            fault_point("ckpt.gather")
            snapshot = {}
            for k, v in values.items():
                shards = _snapshot_value(v, self.rank)
                if shards:
                    snapshot[k] = shards
        self.last_snapshot_bytes = sum(
            int(a.nbytes) for shards in snapshot.values()
            for _, _, _, a in shards)
        meta = dict(meta or {})
        meta.setdefault("wall_time", time.time())
        if sync or not self.async_save:
            self._write(step, snapshot, meta)
            return
        self._thread = threading.Thread(
            target=self._write_guard, args=(step, snapshot, meta),
            name=f"ckpt-writer-{step}", daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the in-flight background write (if any) commits;
        re-raise its failure here, on the caller's thread."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def _write_guard(self, step, snapshot, meta):
        try:
            self._write(step, snapshot, meta)
        except BaseException as e:                    # noqa: BLE001
            self._write_error = e

    def _write(self, step: int, snapshot, meta):
        t0 = time.perf_counter()
        try:
            self._write_inner(step, snapshot, meta)
        except BaseException:                         # noqa: BLE001
            self._m_failures.inc()
            raise
        dt = time.perf_counter() - t0
        self._m_duration.observe(dt)
        from ...observability import record_span
        record_span("ckpt_write", t0, t0 + dt, cat="checkpoint",
                    step=int(step))

    def _write_payload(self, tmp: str, name: str, snapshot):
        fault_point("ckpt.write")
        with open(os.path.join(tmp, name), "wb") as f:
            crc_f = _CrcWriter(f)
            pickle.dump(snapshot, crc_f, protocol=4)
            f.flush()
            os.fsync(f.fileno())
        fault_point("ckpt.write")
        return {"crc32": crc_f.crc, "size": crc_f.size}

    def _write_inner(self, step: int, snapshot, meta):
        tmp = self._tmp_dir(step)
        if not self._dist:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            digest = self._write_payload(tmp, _PAYLOAD, snapshot)
            self._commit(step, tmp, {_PAYLOAD: digest}, meta, _FORMAT)
            self._m_bytes.inc(digest["size"])
            return
        import torch.distributed as dist
        name = "shards_%d.distcp" % self.rank
        os.makedirs(tmp, exist_ok=True)
        digest, error = None, None
        try:
            digest = self._write_payload(tmp, name, snapshot)
        except BaseException as e:                    # noqa: BLE001
            error = e
        index = {k: (list(sh[0][0]), list(sh[0][1]), sh[0][2])
                 for k, sh in snapshot.items()}
        with comm_task("ckpt.commit"):
            got = [None] * self.world
            dist.all_gather_object(
                got, (name, digest, None if error is None else repr(error),
                      index), group=self._group)
        if error is not None:
            raise error
        bad = [(r, g[2]) for r, g in enumerate(got) if g[2] is not None]
        if bad:
            raise RuntimeError("checkpoint step %d not committed: rank %d "
                               "failed to write (%s)" % (step, *bad[0]))
        result: List[Optional[str]] = [None]
        if self.rank == 0:
            try:
                self._commit(step, tmp, {n: d for n, d, _, _ in got}, meta,
                             _FORMAT_RANKS, {n: ix for n, _, _, ix in got})
            except BaseException as e:
                result[0] = repr(e)
                raise
            finally:
                with comm_task("ckpt.commit"):
                    dist.broadcast_object_list(result, src=0,
                                               group=self._group)
        else:
            with comm_task("ckpt.commit"):
                dist.broadcast_object_list(result, src=0, group=self._group)
            if result[0] is not None:
                raise RuntimeError("checkpoint step %d not committed: rank "
                                   "0 failed (%s)" % (step, result[0]))
            self.saved_steps.append(int(step))
            self._m_commits.inc()
        self._m_bytes.inc(digest["size"])

    def _commit(self, step: int, tmp: str, files, meta, fmt: int,
                index=None):
        manifest = {"format": fmt, "step": int(step), "files": files,
                    "meta": meta}
        if index is not None:
            manifest["index"] = index
        fault_point("ckpt.manifest")
        # written directly: the staging dir is invisible to scans until
        # the directory-level os.replace below, the only commit point
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        self._fsync_dir(tmp)
        fault_point("ckpt.commit")
        final = self._final_dir(step)
        with self._lock:
            if os.path.exists(final):
                # re-save of an existing step: the new bytes win
                shutil.rmtree(final)
            os.replace(tmp, final)                    # THE commit point
            self._fsync_dir(self.directory)
            self.saved_steps.append(int(step))
        self._m_commits.inc()
        self._gc()

    @staticmethod
    def _file_digest(path: str) -> Dict[str, Any]:
        crc = 0
        size = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                size += len(chunk)
        return {"crc32": crc & 0xFFFFFFFF, "size": size}

    @staticmethod
    def _fsync_dir(path: str):
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass           # platform without dir fsync: rename still atomic

    # -- scan / validate ------------------------------------------------------
    def _validate(self, path: str) -> Optional[Dict[str, Any]]:
        """Manifest dict if ``path`` is a complete checkpoint (manifest
        present, every file's size and CRC matching), else None."""
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if manifest.get("format") not in (_FORMAT, _FORMAT_RANKS):
            return None
        for fname, digest in manifest.get("files", {}).items():
            try:
                got = self._file_digest(os.path.join(path, fname))
            except OSError:
                return None
            if got["size"] != digest.get("size") or \
                    got["crc32"] != digest.get("crc32"):
                return None
        return manifest

    def all_valid(self) -> List[Tuple[int, str]]:
        """[(step, path)] of every complete checkpoint, ascending step —
        partial (.tmp.*) and corrupt directories are skipped."""
        return [(s, p) for s, p in self._step_dirs()
                if self._validate(p) is not None]

    def latest_valid(self) -> Optional[Tuple[int, str]]:
        valid = self.all_valid()
        return valid[-1] if valid else None

    # -- load -----------------------------------------------------------------
    def load(self, step: Optional[int] = None) -> Optional[TrainState]:
        """Load the newest valid checkpoint (or the given ``step``), every
        payload's shards merged; None when nothing valid exists."""
        if step is not None:
            path = self._final_dir(step)
            manifest = self._validate(path)
            if manifest is None:
                raise FileNotFoundError(
                    f"checkpoint step {step} missing or corrupt under "
                    f"{self.directory}")
        else:
            found = self.latest_valid()
            if found is None:
                return None
            _, path = found
            manifest = self._validate(path)
            if manifest is None:       # raced away by concurrent GC
                return None
        arrays: Dict[str, list] = {}
        index = manifest.get("index") or {}
        for fname in sorted(manifest["files"]):
            if not fname.endswith(".distcp"):
                continue
            fpath = os.path.join(path, fname)
            if fname in index:
                unread = _Unread(fpath)
                for k, (off, shape, dt) in index[fname].items():
                    arrays.setdefault(k, []).append(
                        (tuple(off), tuple(shape), dt, unread))
                continue
            with open(fpath, "rb") as f:
                for k, shards in pickle.load(f).items():
                    arrays.setdefault(k, []).extend(shards)
        return TrainState(arrays, manifest.get("meta", {}))

    def _step_dirs(self) -> List[Tuple[int, str]]:
        """Every ``step_*`` directory, ascending step — no validation."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            step = self._step_of(name)
            if step is not None:
                out.append((step, os.path.join(self.directory, name)))
        out.sort()
        return out

    # -- GC -------------------------------------------------------------------
    def _gc(self):
        """Drop the oldest checkpoints beyond keep_last_k, and stale tmp
        dirs; nothing older than the newest fully valid checkpoint
        survives only because it is corrupt."""
        if self.keep_last_k > 0:
            dirs = self._step_dirs()
            newest_valid = None
            for step, path in reversed(dirs):
                if self._validate(path) is not None:
                    newest_valid = step
                    break
            if newest_valid is not None:
                for step, path in dirs[:-self.keep_last_k]:
                    if step < newest_valid:
                        shutil.rmtree(path, ignore_errors=True)
                        self._m_gc.inc()
        self._clean_stale_tmp()

    def _clean_stale_tmp(self):
        """Remove ``.tmp.*`` orphans of dead writers (a crashed save, ours
        or a previous incarnation of this job)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if not name.startswith(".tmp."):
                continue
            parts = name.split(".")
            pid = None
            if len(parts) >= 4:
                try:
                    pid = int(parts[3])
                except ValueError:
                    pid = None
            if pid == os.getpid() and self._thread is not None \
                    and self._thread.is_alive():
                continue               # our own in-flight write
            if pid is not None and pid != os.getpid():
                try:
                    os.kill(pid, 0)
                    continue           # writer still alive: not ours to GC
                except (ProcessLookupError, PermissionError):
                    pass
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
