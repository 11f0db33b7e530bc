"""The ctypes binding of the shared-memory ring (``io/_native/ringbuf.cc``;
counterpart of ``paddle_tpu/io/shm_ring.py``).

The library builds at first use with the host C++ compiler into the
git-ignored ``build/`` tree (``_build.build_host``, content-hash keyed);
a failed build raises, and nothing falls back.  On top of the byte ring a
message framing:

  frame := u64 payload_size | payload
  batch payload := tag | u64 template_len | u32 n_buffers |
                   pickle(template) |
                   (u64 nbytes | zeros to a 64-byte offset | bytes) * n

where the template is the batch's structure with every numpy array
replaced by a stub (dtype, shape): arrays travel as raw bytes, not
pickles.  A received frame lands in one fresh numpy buffer and the
decoded arrays are views of it (writable, no further copy).
"""
from __future__ import annotations

import ctypes
import os
import pickle
import struct
import threading
from typing import List, Optional

import numpy as np

from .. import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                      "ringbuf.cc")
_LIB = [None]
_LIB_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The ring's library, built and loaded at first use."""
    if _LIB[0] is None:
        with _LIB_LOCK:
            if _LIB[0] is None:
                lib = ctypes.CDLL(_build.build_host("ringbuf", SOURCE))
                lib.rb_open.restype = ctypes.c_void_p
                lib.rb_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_int]
                lib.rb_write.restype = ctypes.c_int64
                lib.rb_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint64]
                lib.rb_read.restype = ctypes.c_int64
                lib.rb_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_uint64]
                lib.rb_read_timeout.restype = ctypes.c_int64
                lib.rb_read_timeout.argtypes = [ctypes.c_void_p,
                                                ctypes.c_void_p,
                                                ctypes.c_uint64,
                                                ctypes.c_uint64]
                lib.rb_close_write.argtypes = [ctypes.c_void_p]
                lib.rb_detach.argtypes = [ctypes.c_void_p]
                lib.rb_unlink.argtypes = [ctypes.c_char_p]
                _LIB[0] = lib
    return _LIB[0]


def build() -> str:
    """Build (or find) the ring's library and load it; its path."""
    path = _build.build_host("ringbuf", SOURCE)
    _lib()
    return path


class ShmRing:
    """One SPSC byte ring in POSIX shared memory, message-framed."""

    class Timeout(Exception):
        """No byte arrived within the read's timeout."""

    def __init__(self, name: str, capacity: int, owner: bool):
        self._lib = _lib()
        self.name = name.encode()
        self.owner = owner
        self.capacity = int(capacity)
        self._h = self._lib.rb_open(self.name, self.capacity,
                                    1 if owner else 0)
        if not self._h:
            raise OSError(f"rb_open({name}) failed")

    # -- producer --
    def send_msg(self, payload: bytes):
        frame = struct.pack("<Q", len(payload)) + payload
        if len(frame) > self.capacity:
            raise OSError("a frame of %d bytes does not fit the ring's %d "
                          "(raise FLAGS_dataloader_ring_bytes)"
                          % (len(frame), self.capacity))
        if self._lib.rb_write(self._h, frame, len(frame)) < 0:
            raise OSError("ring write failed")

    def close_write(self):
        self._lib.rb_close_write(self._h)

    # -- consumer --
    def _read_exact(self, ptr, n, timeout_us):
        if timeout_us is None:
            return self._lib.rb_read(self._h, ptr, n)
        return self._lib.rb_read_timeout(self._h, ptr, n, timeout_us)

    def recv_msg(self, timeout_us: Optional[int] = None
                 ) -> Optional[np.ndarray]:
        """The next message as a fresh uint8 array; None on a clean EOF;
        raises :class:`ShmRing.Timeout` after ``timeout_us`` without a
        byte (so the caller can check the producer and retry)."""
        hdr = np.empty(8, np.uint8)
        rc = self._read_exact(hdr.ctypes.data, 8, timeout_us)
        if rc == 0:
            return None
        if rc == -2:
            raise ShmRing.Timeout()
        if rc != 8:
            raise OSError("ring read failed (truncated frame)")
        size = int(hdr.view("<u8")[0])
        buf = np.empty(size, np.uint8)
        if size and self._read_exact(buf.ctypes.data, size,
                                     timeout_us) != size:
            raise OSError("ring read failed mid-frame (the producer died "
                          "while writing?)")
        return buf

    def detach(self):
        if self._h:
            self._lib.rb_detach(self._h)
            self._h = None

    def unlink(self):
        self._lib.rb_unlink(self.name)


# ---------------------------------------------------------------------------
# batch (de)serialisation: numpy buffers as raw bytes, structure as pickle
# ---------------------------------------------------------------------------
class _ArrayStub:
    __slots__ = ("idx", "dtype", "shape")

    def __init__(self, idx, dtype, shape):
        self.idx = idx
        self.dtype = dtype
        self.shape = shape


def encode_batch(obj, tag: bytes = b"") -> bytes:
    """``tag`` then ``obj``'s template and arrays, each array at a 64-byte
    offset of the message."""
    buffers: List[np.ndarray] = []

    def strip(x):
        if isinstance(x, np.ndarray):
            buffers.append(np.ascontiguousarray(x))
            return _ArrayStub(len(buffers) - 1, x.dtype.str, x.shape)
        if isinstance(x, (list, tuple)):
            out = [strip(i) for i in x]
            return tuple(out) if isinstance(x, tuple) else out
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        return x

    tpl = pickle.dumps(strip(obj), protocol=4)
    parts = [tag, struct.pack("<QI", len(tpl), len(buffers)), tpl]
    off = len(tag) + 12 + len(tpl)
    for b in buffers:
        start = _aligned(off + 8)
        parts += [struct.pack("<Q", b.nbytes), bytes(start - off - 8),
                  b.tobytes()]
        off = start + b.nbytes
    return b"".join(parts)


def _aligned(off: int) -> int:
    """``off`` rounded up to 64 bytes: each array starts aligned."""
    return -(-off // 64) * 64


def decode_batch(payload, start: int = 0):
    """The batch ``encode_batch`` put in ``payload`` (bytes or a uint8
    array, whose arrays the result then views) after ``start`` bytes of
    tag."""
    buf = np.frombuffer(payload, np.uint8) if isinstance(
        payload, (bytes, bytearray)) else payload
    tpl_len, n_buf = struct.unpack_from("<QI", buf, start)
    off = start + 12
    template = pickle.loads(buf[off:off + tpl_len].tobytes())
    off += tpl_len
    spans = []
    for _ in range(n_buf):
        (blen,) = struct.unpack_from("<Q", buf, off)
        off = _aligned(off + 8)
        spans.append((off, blen))
        off += blen

    def fill(x):
        if isinstance(x, _ArrayStub):
            boff, blen = spans[x.idx]
            return buf[boff:boff + blen].view(np.dtype(x.dtype)).reshape(
                x.shape)
        if isinstance(x, (list, tuple)):
            out = [fill(i) for i in x]
            return tuple(out) if isinstance(x, tuple) else out
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        return x

    return fill(template)
