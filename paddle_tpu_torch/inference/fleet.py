"""Multi-process serving fleet — the cross-process engine data plane (a
copy of ``paddle_tpu/inference/fleet.py`` over the port's engine).

One engine-server process wraps one :class:`ContinuousBatchingEngine`
and exposes the full engine API over a length-prefixed socket protocol,
and a :class:`RemoteEngineClient` presents the in-process engine
interface so :class:`ServingRouter` drives N processes through the SAME
dispatch/drain/requeue/migrate state machine it runs in-process —
same routing keys, same SLO plane, same capacity signals.

Wire protocol (one frame per message, either direction; byte for byte
the reference's, so a reference client drives a port server and a port
client a reference server)::

    header   <4sII   magic b"PTF1", json_len, n_blobs
    lengths  n_blobs x <Q   byte length of each raw blob
    payload  json_len bytes of JSON (the message object)
    blobs    concatenated raw bytes (KVPageBuffer planes)

Requests are ``{"v":1, "tok": <client token>, "id": <monotonic int>,
"method": ..., "params": {...}}``; responses ``{"id":..., "ok":true,
"result":...}`` or ``{"id":..., "ok":false, "error":{"type","msg"}}``
with the error type mapped back onto the in-process exception contract
(KeyError / ValueError / RuntimeError) client-side — the router's
existing error handling keeps working verbatim across the wire.

``KVPageBuffer`` crosses the wire verbatim: its self-describing header
rides in the JSON, its ``codes`` (and int8 ``scales``) host arrays ride
as raw blobs — ONE payload per dtype plane, zero re-encoding.  bf16
pages are named ``"bfloat16"`` on the wire, as the reference names them;
the port holds them as their 16-bit patterns (``uint16``), so the same
bytes decode on either side without ``ml_dtypes``.  The server validates
blob sizes against the declared geometry BEFORE any engine call, and
``inject_request`` keeps the pre-side-effect error contract (ValueError
= never fits, RuntimeError = transient).

Robustness contract:

* every socket operation is deadline-bounded (``settimeout`` derived
  from the per-method RPC deadline — no unbounded blocking call);
* transient failures (connection loss, timeouts, torn frames) retry
  with capped exponential backoff + jitter (:class:`RetryPolicy`,
  shared with ``EngineHandle``'s /healthz scrape);
* retries are SAFE: every request carries a (client token, rpc id)
  pair and the server replays the cached response for a duplicate —
  a resent ``step`` never double-advances the engine;
* retries exhausted raise :class:`EngineRPCError`, which the router's
  step/probe machinery turns into drain-and-requeue from the router's
  OWN record (reason="engine_lost", zero drops — surviving ``kill -9``
  of a real process);
* the network itself is fault-injectable: ``rpc.send`` / ``rpc.recv``
  / ``rpc.accept`` sites (``testing/faults.py``) fire on both sides of
  the wire, per process.

Threading: :class:`EngineServer` serializes all engine access under
``_engine_lock`` (one handler thread per connection) and guards its
RPC-dedup/tracking maps under ``_lock`` (strict order: engine lock
outer).  :class:`RemoteEngineClient` is single-threaded by design —
it is owned by one router loop, exactly like an in-process engine.

:class:`EngineProcess` runs the port's own server entry point,
``python -m paddle_tpu_torch.inference.engine_server``.
"""
from __future__ import annotations

import json
import os
import random
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability import metrics as _metrics
from ..ops.paged_attention import KVPageBuffer
from ..testing.faults import FaultDrop, fault_point

__all__ = [
    "RetryPolicy", "EngineRPCError", "ProtocolError",
    "send_frame", "recv_frame", "buffer_to_wire", "buffer_from_wire",
    "RemoteEngineClient", "RemoteRequestView", "EngineServer",
    "EngineProcess", "RPC_METHODS",
]

_MAGIC = b"PTF1"
_HEADER = struct.Struct("<4sII")     # magic, json_len, n_blobs
_BLOBLEN = struct.Struct("<Q")
_MAX_JSON = 64 << 20
_MAX_BLOBS = 8
_MAX_BLOB = 16 << 30

#: the closed RPC method set — also the graftlint label domain for
#: ``router_rpc_*{method=...}``
RPC_METHODS = ("hello", "add_request", "step", "preempt_request",
               "extract_request", "inject_request", "health_payload",
               "ping", "shutdown")

# RPC latency is network + engine step time — the default buckets top
# out too low for a slow first step, so extend the tail
_RPC_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


class ProtocolError(OSError):
    """A torn / corrupt / mismatched frame.  An :class:`OSError` so the
    client's transient-retry machinery treats it like any other broken
    connection: drop the socket, reconnect, resend (dedup-safe)."""


class EngineRPCError(RuntimeError):
    """An RPC that exhausted its retries (or hit a non-engine server
    failure).  Deliberately NOT a ValueError: the router maps it to the
    engine-lost drain path, never to a capacity rejection."""

    def __init__(self, msg: str, method: str = "", attempts: int = 0):
        super().__init__(msg)
        self.method = method
        self.attempts = attempts


# exception types the server serializes by name and the client
# re-raises as the in-process engine contract
_ERROR_TYPES = {"KeyError": KeyError, "ValueError": ValueError,
                "RuntimeError": RuntimeError, "TypeError": TypeError}


# ---------------------------------------------------------------------------
# retry policy (shared with EngineHandle /healthz scraping)
# ---------------------------------------------------------------------------
class RetryPolicy:
    """Capped exponential backoff with jitter.

    ``delay(attempt)`` for the 1-based ``attempt``-th failure is
    ``min(max_delay, base_delay * 2**(attempt-1)) * (1 + jitter*u)``
    with ``u`` uniform in [0, 1).  ``clock``/``sleep``/``rng`` are
    injectable so tests pin the arithmetic on a stub clock."""

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: float = 0.5,
                 rng=None, sleep=time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()
        self.sleep = sleep

    def delay(self, attempt: int) -> float:
        base = min(self.max_delay,
                   self.base_delay * (2.0 ** (max(1, attempt) - 1)))
        return base * (1.0 + self.jitter * self._rng.random())

    def run(self, fn, retry_on=(OSError,), on_retry=None):
        """Call ``fn`` with up to ``max_attempts`` tries; sleeps
        ``delay(i)`` between them.  The final failure re-raises."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except retry_on as e:
                if attempt >= self.max_attempts:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self.sleep(self.delay(attempt))


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def _remaining(deadline: Optional[float]) -> Optional[float]:
    if deadline is None:
        return None
    rem = deadline - time.monotonic()
    if rem <= 0:
        raise TimeoutError("rpc deadline exhausted")
    return rem


def send_frame(sock: socket.socket, obj: dict,
               blobs: Sequence[bytes] = (), deadline: float = None):
    """Write one frame (header + blob lengths + JSON + blobs), every
    ``sendall`` bounded by ``deadline``."""
    payload = json.dumps(obj, separators=(",", ":"),
                         default=str).encode("utf-8")
    head = [_HEADER.pack(_MAGIC, len(payload), len(blobs))]
    head.extend(_BLOBLEN.pack(len(b)) for b in blobs)
    head.append(payload)
    sock.settimeout(_remaining(deadline))
    sock.sendall(b"".join(head))
    for b in blobs:
        sock.settimeout(_remaining(deadline))
        sock.sendall(b)


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    chunks, got = [], 0
    while got < n:
        sock.settimeout(_remaining(deadline))
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionResetError("peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket,
               deadline: float = None) -> Tuple[dict, List[bytes]]:
    """Read one frame; raises :class:`ProtocolError` on a corrupt
    header/JSON, ``TimeoutError`` past ``deadline``."""
    head = _recv_exact(sock, _HEADER.size, deadline)
    try:
        magic, json_len, n_blobs = _HEADER.unpack(head)
    except struct.error as e:             # pragma: no cover - fixed size
        raise ProtocolError(f"bad frame header: {e}") from e
    if magic != _MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if json_len > _MAX_JSON or n_blobs > _MAX_BLOBS:
        raise ProtocolError(
            f"frame exceeds limits (json={json_len}, blobs={n_blobs})")
    lens = []
    for _ in range(n_blobs):
        (blen,) = _BLOBLEN.unpack(_recv_exact(sock, _BLOBLEN.size,
                                              deadline))
        if blen > _MAX_BLOB:
            raise ProtocolError(f"blob of {blen} bytes exceeds limit")
        lens.append(blen)
    payload = _recv_exact(sock, json_len, deadline)
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"bad frame payload: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError("frame payload is not an object")
    blobs = [_recv_exact(sock, blen, deadline) for blen in lens]
    return obj, blobs


# ---------------------------------------------------------------------------
# KVPageBuffer <-> wire
# ---------------------------------------------------------------------------
def _np_dtype(name: str) -> np.dtype:
    """The host dtype of a wire ``codes_dtype``: ``"bfloat16"`` reads as
    its 16-bit patterns (numpy has no bfloat16; the port's pools hold
    bf16 pages as ``uint16``)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


def _codes_dtype_name(buf: KVPageBuffer) -> str:
    """The wire name of a buffer's codes dtype: a bf16 pool's ``uint16``
    patterns go out as ``"bfloat16"``, the reference's name for them."""
    if buf.kv_dtype == "bfloat16":
        return "bfloat16"
    return str(np.asarray(buf.codes).dtype)


def buffer_to_wire(buf: Optional[KVPageBuffer]):
    """``(header_dict | None, [codes_bytes, scales_bytes?])`` — the
    header pins the geometry, the blobs are the raw host planes (one
    per dtype), byte-exact."""
    if buf is None:
        return None, []
    header = {"n_pages": int(buf.n_pages), "n_tokens": int(buf.n_tokens),
              "block_size": int(buf.block_size),
              "num_kv_heads": int(buf.num_kv_heads),
              "head_dim": int(buf.head_dim),
              "num_layers": int(buf.num_layers),
              "kv_dtype": str(buf.kv_dtype),
              "codes_dtype": _codes_dtype_name(buf),
              "has_scales": buf.scales is not None}
    blobs = [np.ascontiguousarray(buf.codes).tobytes()]
    if buf.scales is not None:
        blobs.append(np.ascontiguousarray(
            np.asarray(buf.scales, np.float32)).tobytes())
    return header, blobs


def buffer_from_wire(header: Optional[dict],
                     blobs: Sequence[bytes]) -> Optional[KVPageBuffer]:
    """Rebuild a :class:`KVPageBuffer` from its wire form, validating
    every blob length against the declared geometry BEFORE constructing
    anything — a mismatched frame raises ValueError with no side
    effect (the pre-side-effect contract holds across the wire)."""
    if header is None:
        return None
    try:
        L = int(header["num_layers"])
        n_pages = int(header["n_pages"])
        bs = int(header["block_size"])
        hkv = int(header["num_kv_heads"])
        d = int(header["head_dim"])
        dtype = _np_dtype(str(header["codes_dtype"]))
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise ValueError(f"malformed KVPageBuffer header: {e}") from e
    shape = (2 * L, n_pages, bs, hkv, d)
    want = int(np.prod(shape)) * dtype.itemsize
    if not blobs or len(blobs[0]) != want:
        raise ValueError(
            "KVPageBuffer codes blob is %d bytes, geometry %r wants %d"
            % (len(blobs[0]) if blobs else 0, shape, want))
    codes = np.frombuffer(blobs[0], dtype).reshape(shape)
    scales = None
    if header.get("has_scales"):
        sshape = (2 * L, n_pages, hkv)
        swant = int(np.prod(sshape)) * 4
        if len(blobs) < 2 or len(blobs[1]) != swant:
            raise ValueError(
                "KVPageBuffer scales blob is %d bytes, geometry %r "
                "wants %d" % (len(blobs[1]) if len(blobs) > 1 else 0,
                              sshape, swant))
        scales = np.frombuffer(blobs[1], np.float32).reshape(sshape)
    return KVPageBuffer(
        codes=codes, scales=scales, n_pages=n_pages,
        n_tokens=int(header["n_tokens"]), block_size=bs,
        num_kv_heads=hkv, head_dim=d, num_layers=L,
        kv_dtype=str(header["kv_dtype"]))


def _fleet_metrics(registry=None):
    r = registry if registry is not None else _metrics.default_registry()
    return (
        r.counter(
            "router_rpc_requests_total",
            "logical fleet RPCs by method and outcome (ok / error) — "
            "one count per call, however many attempts it took",
            labels=("method", "outcome")),
        r.counter(
            "router_rpc_retries_total",
            "transient-failure retries (reconnect + resend) by method; "
            "a healthy fleet holds this near zero",
            labels=("method",)),
        r.histogram(
            "router_rpc_latency_seconds",
            "wall time of logical fleet RPCs (first attempt through "
            "final outcome, retries included)",
            labels=("method",), buckets=_RPC_BUCKETS),
        r.counter(
            "fleet_engine_process_restarts_total",
            "engine-server subprocess restarts through "
            "EngineProcess.restart()"),
    )


# ---------------------------------------------------------------------------
# client-side request views
# ---------------------------------------------------------------------------
@dataclass
class RemoteRequestView:
    """The client-side twin of the engine's live request object — the
    router reads these exactly as it reads ``GenerationRequest`` (slot,
    state, output_ids, t_first_token, truncated), synced from ``step``
    responses.  ``t_first_token`` is stamped CLIENT-side when the first
    output token is observed: ``perf_counter`` is not comparable across
    processes, and the router's TTFT math runs on ITS clock."""
    req_id: int
    prompt_ids: Optional[np.ndarray] = None
    output_ids: List[int] = field(default_factory=list)
    slot: int = -1
    state: str = "waiting"
    t_first_token: float = 0.0
    truncated: bool = False
    max_new_tokens: int = 0


class _RemotePrefixTable:
    """Membership view of the server engine's prefix-cache table
    (blake2b page keys), synced from step responses — the router's
    affinity routing only ever asks ``key in pc.table``."""

    def __init__(self):
        self.table: Dict[bytes, int] = {}

    def replace(self, hex_keys: Sequence[str]):
        self.table = {bytes.fromhex(k): 0 for k in hex_keys}


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------
class RemoteEngineClient:
    """Drives one engine-server process through the wire protocol while
    presenting the in-process :class:`ContinuousBatchingEngine`
    interface the router already speaks (``add_request`` / ``step`` /
    ``has_work`` / ``finished`` / ``preempt_request`` /
    ``extract_request`` / ``inject_request`` / ``health_payload`` /
    ``waiting`` / ``slots`` / ``prefix_cache`` / ``block_size`` ...).

    Single-threaded by design (one owner: the router loop).  Every RPC
    is deadline-bounded and retried per :class:`RetryPolicy`; the
    (token, id) dedup pair makes retries side-effect-safe.

    ``begin_step()`` / ``finish_step()`` split the step RPC so a router
    can FAN OUT one ``step`` to every remote engine and then collect —
    N processes genuinely step concurrently, which is the point of
    leaving the process."""

    DEFAULT_TIMEOUTS = {
        "hello": 60.0, "add_request": 60.0, "step": 180.0,
        "preempt_request": 60.0, "extract_request": 180.0,
        "inject_request": 180.0, "health_payload": 5.0,
        "ping": 5.0, "shutdown": 5.0,
    }

    def __init__(self, address, retry: Optional[RetryPolicy] = None,
                 timeouts: Optional[Dict[str, float]] = None,
                 eager: bool = True, registry=None,
                 health_cache_s: float = 0.25):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self._address = (address[0], int(address[1]))
        self.retry = retry if retry is not None else RetryPolicy()
        self._timeouts = dict(self.DEFAULT_TIMEOUTS)
        if timeouts:
            self._timeouts.update(timeouts)
        self._health_cache_s = float(health_cache_s)
        self._sock: Optional[socket.socket] = None
        self._token = os.urandom(8).hex()
        self._next_id = 1
        self._step_pending: Optional[dict] = None
        self._views: "OrderedDict[int, RemoteRequestView]" = OrderedDict()
        self.finished: Dict[int, RemoteRequestView] = {}
        self._hello: Optional[dict] = None
        self._prefix = _RemotePrefixTable()
        self._health: Optional[Tuple[float, dict]] = None
        (self._m_requests, self._m_retries, self._m_latency,
         _restarts) = _fleet_metrics(registry)
        if eager:
            self._ensure_hello()

    # ---- static engine surface (from the hello handshake) ---------------
    def _ensure_hello(self) -> dict:
        if self._hello is None:
            self._hello, _ = self._call("hello", {})
        return self._hello

    @property
    def engine_id(self):
        return self._ensure_hello().get("engine_id")

    @property
    def role(self) -> str:
        return self._ensure_hello().get("role", "mixed")

    @property
    def block_size(self) -> int:
        return int(self._ensure_hello().get("block_size", 0))

    @property
    def prefix_cache(self):
        if not self._ensure_hello().get("has_prefix_cache"):
            return None
        return self._prefix

    def migration_geometry(self):
        geo = self._ensure_hello().get("migration_geometry")
        return tuple(geo) if geo is not None else None

    @property
    def server_pid(self) -> Optional[int]:
        return self._ensure_hello().get("pid")

    # ---- live request surface -------------------------------------------
    @property
    def waiting(self) -> List[RemoteRequestView]:
        return [v for v in self._views.values() if v.slot < 0]

    @property
    def slots(self) -> List[RemoteRequestView]:
        return [v for v in self._views.values() if v.slot >= 0]

    def has_work(self) -> bool:
        return bool(self._views)

    # ---- engine API over the wire ---------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int = 16,
                    eos_token_id: Optional[int] = None,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, seed: int = 0) -> int:
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        res, _ = self._call("add_request", {
            "prompt_ids": prompt.tolist(),
            "max_new_tokens": int(max_new_tokens),
            "eos_token_id": (int(eos_token_id)
                             if eos_token_id is not None else None),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p), "seed": int(seed)})
        erid = int(res["req_id"])
        self._views[erid] = RemoteRequestView(
            req_id=erid, prompt_ids=prompt,
            max_new_tokens=int(max_new_tokens))
        return erid

    def inject_request(self, prompt_ids, buffer: KVPageBuffer,
                       max_new_tokens: int = 16,
                       eos_token_id: Optional[int] = None,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0, seed: int = 0) -> int:
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        header, blobs = buffer_to_wire(buffer)
        res, _ = self._call("inject_request", {
            "prompt_ids": prompt.tolist(), "buffer": header,
            "max_new_tokens": int(max_new_tokens),
            "eos_token_id": (int(eos_token_id)
                             if eos_token_id is not None else None),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p), "seed": int(seed)}, blobs=blobs)
        erid = int(res["req_id"])
        self._views[erid] = RemoteRequestView(
            req_id=erid, prompt_ids=prompt, slot=int(res.get("slot", 0)),
            state=str(res.get("state", "running")),
            max_new_tokens=int(max_new_tokens))
        return erid

    def preempt_request(self, req_id: int):
        res, _ = self._call("preempt_request", {"req_id": int(req_id)})
        self._views.pop(int(req_id), None)
        return (np.asarray(res["prompt_ids"], np.int64),
                list(res["generated"]))

    def extract_request(self, req_id: int):
        res, rblobs = self._call("extract_request",
                                 {"req_id": int(req_id)})
        self._views.pop(int(req_id), None)
        buf = buffer_from_wire(res.get("buffer"), rblobs)
        return (np.asarray(res["prompt_ids"], np.int64),
                list(res["generated"]), buf)

    def health_payload(self) -> dict:
        if self._health is not None:
            age = time.monotonic() - self._health[0]
            if 0 <= age < self._health_cache_s:
                return self._health[1]
        res, _ = self._call("health_payload", {})
        self._health = (time.monotonic(), res)
        return res

    def ping(self) -> bool:
        try:
            self._call("ping", {})
            return True
        except EngineRPCError:
            return False

    def shutdown_server(self):
        """Ask the server process to exit cleanly (it replies first)."""
        try:
            self._call("shutdown", {})
        finally:
            self.close()

    # ---- the step fan-out -----------------------------------------------
    def begin_step(self):
        """Fire the step RPC without waiting for the reply (pure
        opportunistic send — a send failure is absorbed and
        ``finish_step`` retries from scratch)."""
        if self._step_pending is not None:
            return
        self._ensure_hello()
        rid = self._next_id
        self._next_id += 1
        msg = {"v": 1, "tok": self._token, "id": rid, "method": "step",
               "params": {}}
        pend = {"rid": rid, "msg": msg, "t0": time.perf_counter(),
                "sent": False}
        self._step_pending = pend
        try:
            deadline = time.monotonic() + self._timeouts["step"]
            sock = self._connect(deadline)
            self._send(sock, msg, (), deadline)
            pend["sent"] = True
        except OSError:
            self._drop_conn()

    def finish_step(self) -> List[int]:
        """Collect (or run) the step RPC and fold the response into the
        local views/finished record.  Returns the done erid list."""
        pend = self._step_pending
        if pend is None:
            self.begin_step()
            pend = self._step_pending
        msg, t0 = pend["msg"], pend["t0"]
        last: Optional[BaseException] = None
        try:
            for attempt in range(1, self.retry.max_attempts + 1):
                deadline = time.monotonic() + self._timeouts["step"]
                try:
                    sock = self._connect(deadline)
                    if not (attempt == 1 and pend["sent"]):
                        self._send(sock, msg, (), deadline)
                    resp, rblobs = self._recv_for(sock, pend["rid"],
                                                  deadline)
                    result = self._unwrap("step", t0, resp)
                    return self._apply_step(result)
                except OSError as e:
                    last = e
                    self._drop_conn()
                    if attempt >= self.retry.max_attempts:
                        break
                    self._m_retries.labels(method="step").inc()
                    self.retry.sleep(self.retry.delay(attempt))
        finally:
            self._step_pending = None
        self._observe("step", "error", t0)
        raise EngineRPCError(
            "step rpc to %s:%d failed after %d attempts: %r"
            % (self._address[0], self._address[1],
               self.retry.max_attempts, last),
            method="step", attempts=self.retry.max_attempts) from last

    def step(self) -> List[int]:
        self.begin_step()
        return self.finish_step()

    # ---- plumbing --------------------------------------------------------
    def close(self):
        self._drop_conn()

    def _drop_conn(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:       # pragma: no cover - close never blocks
                pass
            self._sock = None

    def _connect(self, deadline: float) -> socket.socket:
        if self._sock is not None:
            return self._sock
        s = socket.create_connection(
            self._address, timeout=max(0.05, _remaining(deadline) or 5.0))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        return s

    def _send(self, sock, msg, blobs, deadline):
        try:
            fault_point("rpc.send")
        except FaultDrop:
            return        # the bytes vanished; the reply deadline catches it
        send_frame(sock, msg, blobs, deadline)

    def _recv_for(self, sock, rid: int, deadline: float):
        while True:
            try:
                fault_point("rpc.recv")
            except FaultDrop:
                raise TimeoutError("fault-injected drop on rpc.recv") \
                    from None
            resp, rblobs = recv_frame(sock, deadline)
            got = resp.get("id")
            if got == rid:
                return resp, rblobs
            if isinstance(got, int) and got < rid:
                continue          # stale reply from an abandoned attempt
            raise ProtocolError(f"response id {got!r}, expected {rid}")

    def _settle_pending(self):
        """A non-step RPC while a step reply is in flight: drain the
        reply (short grace) so the socket is clean, else drop the
        connection — the dedup cache protects the resend either way."""
        pend = self._step_pending
        if pend is None:
            return
        try:
            sock = self._connect(time.monotonic() + 1.0)
            resp, _ = self._recv_for(sock, pend["rid"],
                                     time.monotonic() + 1.0)
            result = self._unwrap("step", pend["t0"], resp)
            self._apply_step(result)
        except (OSError, EngineRPCError, KeyError, ValueError,
                RuntimeError):
            self._drop_conn()
        finally:
            self._step_pending = None

    def _call(self, method: str, params: dict,
              blobs: Sequence[bytes] = ()):
        self._settle_pending()
        rid = self._next_id
        self._next_id += 1
        msg = {"v": 1, "tok": self._token, "id": rid, "method": method,
               "params": params}
        t0 = time.perf_counter()
        timeout = self._timeouts.get(method, 30.0)
        last: Optional[BaseException] = None
        for attempt in range(1, self.retry.max_attempts + 1):
            deadline = time.monotonic() + timeout
            try:
                sock = self._connect(deadline)
                self._send(sock, msg, blobs, deadline)
                resp, rblobs = self._recv_for(sock, rid, deadline)
                return self._unwrap(method, t0, resp), rblobs
            except OSError as e:
                last = e
                self._drop_conn()
                if attempt >= self.retry.max_attempts:
                    break
                self._m_retries.labels(method=method).inc()
                self.retry.sleep(self.retry.delay(attempt))
        self._observe(method, "error", t0)
        raise EngineRPCError(
            "%s rpc to %s:%d failed after %d attempts: %r"
            % (method, self._address[0], self._address[1],
               self.retry.max_attempts, last),
            method=method, attempts=self.retry.max_attempts) from last

    def _unwrap(self, method: str, t0: float, resp: dict):
        if not resp.get("ok", False):
            err = resp.get("error") or {}
            self._observe(method, "error", t0)
            cls = _ERROR_TYPES.get(err.get("type"), EngineRPCError)
            raise cls(err.get("msg", "remote engine error"))
        self._observe(method, "ok", t0)
        return resp.get("result")

    def _observe(self, method: str, outcome: str, t0: float):
        self._m_requests.labels(method=method, outcome=outcome).inc()
        self._m_latency.labels(method=method).observe(
            time.perf_counter() - t0)

    def _apply_step(self, result: dict) -> List[int]:
        now = time.perf_counter()
        done = [int(x) for x in (result.get("done") or [])]
        for erid_s, rec in (result.get("finished") or {}).items():
            erid = int(erid_s)
            v = self._views.pop(erid, None)
            t_ft = v.t_first_token if (v and v.t_first_token) else now
            self.finished[erid] = RemoteRequestView(
                req_id=erid,
                prompt_ids=v.prompt_ids if v is not None else None,
                output_ids=[int(t) for t in rec.get("output_ids", [])],
                slot=-1, state="done", t_first_token=t_ft,
                truncated=bool(rec.get("truncated", False)))
        for st in result.get("status") or []:
            erid = int(st["id"])
            if st.get("state") == "gone":
                self._views.pop(erid, None)
                continue
            v = self._views.get(erid)
            if v is None:
                continue
            v.slot = int(st.get("slot", v.slot))
            v.state = str(st.get("state", v.state))
            new = st.get("new") or []
            if new:
                if not v.output_ids and not v.t_first_token:
                    v.t_first_token = now
                v.output_ids.extend(int(t) for t in new)
            v.truncated = bool(st.get("truncated", v.truncated))
        if result.get("prefix_keys") is not None:
            self._prefix.replace(result["prefix_keys"])
        if result.get("health") is not None:
            self._health = (time.monotonic(), result["health"])
        return done


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
class EngineServer:
    """Wraps ONE engine behind the wire protocol.  One handler thread
    per connection; all engine access serialized under
    ``_engine_lock``; dedup/tracking maps under ``_lock`` (order:
    engine lock outer, never the reverse).  Every socket operation is
    bounded (listener and idle connections poll with short timeouts so
    ``stop()`` always lands)."""

    DUP_CACHE = 256
    DUP_WAIT_S = 300.0
    # how long a shutdown waits for a connection's in-flight reply
    SHUTDOWN_DRAIN_S = 10.0

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 idle_poll_s: float = 0.25, frame_timeout_s: float = 60.0,
                 max_prefix_keys: int = 4096):
        self.engine = engine
        self._host, self._port = host, int(port)
        self._idle_poll_s = float(idle_poll_s)
        self._frame_timeout_s = float(frame_timeout_s)
        self._max_prefix_keys = int(max_prefix_keys)
        self._engine_lock = threading.Lock()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: set = set()
        # (client token, rpc id) -> completed response; replayed for a
        # duplicate so a client retry NEVER double-executes
        self._done_rpcs: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._inflight_rpcs: Dict[tuple, threading.Event] = {}
        # erid -> output tokens already shipped in a step response
        self._shipped: Dict[int, int] = {}

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "EngineServer":
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((self._host, self._port))
        lst.listen(16)
        lst.settimeout(self._idle_poll_s)
        with self._lock:
            self._listener = lst
        t = threading.Thread(target=self._accept_loop,
                             name="fleet-accept", daemon=True)
        self._accept_thread = t
        t.start()
        return self

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()[:2]

    def stop(self, join: bool = True):
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:     # pragma: no cover - close never blocks
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:     # pragma: no cover
                pass
        if join:
            if self._accept_thread is not None:
                self._accept_thread.join(timeout=5.0)
            with self._lock:
                threads = list(self._conn_threads)
            for t in threads:
                t.join(timeout=5.0)

    def serve_forever(self):
        """CLI entrypoint body: start, then block until stop() /
        a shutdown RPC (bounded waits only).  Before the sockets close,
        each connection finishes the reply it is sending (its loop ends
        at its next idle poll), so a ``shutdown`` caller gets its reply
        instead of a reset connection."""
        if self._listener is None:
            self.start()
        while not self._stop.wait(timeout=0.5):
            pass
        with self._lock:
            threads = list(self._conn_threads)
        for t in threads:
            t.join(timeout=self.SHUTDOWN_DRAIN_S)
        self.stop()

    # ---- socket loops ----------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break             # listener closed: shutting down
            try:
                fault_point("rpc.accept")
            except (FaultDrop, ConnectionError, OSError):
                try:
                    conn.close()
                except OSError:   # pragma: no cover
                    pass
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="fleet-conn", daemon=True)
            with self._lock:
                self._conns.add(conn)
                self._conn_threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                try:
                    msg, blobs = self._recv_request(conn)
                except socket.timeout:
                    continue      # idle poll tick: re-check _stop
                except (ConnectionError, OSError, EOFError):
                    break
                if msg is None:
                    continue      # injected drop: pretend never arrived
                resp_obj, resp_blobs = self._handle(msg, blobs)
                try:
                    fault_point("rpc.send")
                    send_frame(conn, resp_obj, resp_blobs,
                               time.monotonic() + self._frame_timeout_s)
                except FaultDrop:
                    continue      # reply vanished; dedup serves the retry
                except (ConnectionError, OSError):
                    break
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:       # pragma: no cover
                pass

    def _recv_request(self, conn: socket.socket):
        """One frame with idle-friendly timing: short poll while no
        bytes have arrived (so stop() lands), a real per-frame deadline
        once a header starts flowing."""
        conn.settimeout(self._idle_poll_s)
        first = conn.recv(1)
        if not first:
            raise ConnectionResetError("client closed")
        deadline = time.monotonic() + self._frame_timeout_s
        try:
            return self._recv_request_body(conn, first, deadline)
        except TimeoutError as e:
            # a timeout MID-frame desyncs the stream: tear the
            # connection down (the idle tick is the recv(1) above)
            raise ProtocolError(f"frame stalled mid-read: {e}") from e

    def _recv_request_body(self, conn, first: bytes, deadline: float):
        head = first + _recv_exact(conn, _HEADER.size - 1, deadline)
        magic, json_len, n_blobs = _HEADER.unpack(head)
        if magic != _MAGIC:
            raise ProtocolError(f"bad magic {magic!r}")
        if json_len > _MAX_JSON or n_blobs > _MAX_BLOBS:
            raise ProtocolError("frame exceeds limits")
        lens = []
        for _ in range(n_blobs):
            (blen,) = _BLOBLEN.unpack(
                _recv_exact(conn, _BLOBLEN.size, deadline))
            if blen > _MAX_BLOB:
                raise ProtocolError("blob exceeds limit")
            lens.append(blen)
        payload = _recv_exact(conn, json_len, deadline)
        blobs = [_recv_exact(conn, blen, deadline) for blen in lens]
        try:
            fault_point("rpc.recv")
        except FaultDrop:
            return None, None     # the request "never arrived"
        try:
            msg = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ProtocolError(f"bad frame payload: {e}") from e
        if not isinstance(msg, dict):
            raise ProtocolError("frame payload is not an object")
        return msg, blobs

    # ---- dedup + dispatch ------------------------------------------------
    def _handle(self, msg: dict, blobs: List[bytes]):
        rid = msg.get("id")
        key = (msg.get("tok"), rid)
        wait_ev = None
        with self._lock:
            cached = self._done_rpcs.get(key)
            if cached is None:
                ev = self._inflight_rpcs.get(key)
                if ev is None:
                    self._inflight_rpcs[key] = threading.Event()
                else:
                    wait_ev = ev
        if cached is not None:
            return cached
        if wait_ev is not None:
            # the same rpc is executing on another connection (client
            # reconnected mid-call): wait for ITS result, bounded
            wait_ev.wait(timeout=self.DUP_WAIT_S)
            with self._lock:
                cached = self._done_rpcs.get(key)
            if cached is not None:
                return cached
            return ({"id": rid, "ok": False,
                     "error": {"type": "EngineRPCError",
                               "msg": "duplicate rpc still executing"}},
                    [])
        try:
            result, rblobs = self._dispatch_rpc(
                msg.get("method"), msg.get("params") or {}, blobs)
            resp = ({"id": rid, "ok": True, "result": result}, rblobs)
        except Exception as e:                        # noqa: BLE001
            resp = ({"id": rid, "ok": False,
                     "error": {"type": type(e).__name__,
                               "msg": str(e)}}, [])
        with self._lock:
            self._done_rpcs[key] = resp
            while len(self._done_rpcs) > self.DUP_CACHE:
                self._done_rpcs.popitem(last=False)
            ev = self._inflight_rpcs.pop(key, None)
        if ev is not None:
            ev.set()
        return resp

    def _dispatch_rpc(self, method: str, params: dict,
                      blobs: List[bytes]):
        if method == "ping":
            return {}, []
        if method == "shutdown":
            self._stop.set()
            return {}, []
        if method == "hello":
            with self._engine_lock:
                return self._do_hello(), []
        if method == "add_request":
            with self._engine_lock:
                return self._do_add(params), []
        if method == "step":
            with self._engine_lock:
                return self._do_step(), []
        if method == "preempt_request":
            with self._engine_lock:
                return self._do_preempt(params), []
        if method == "extract_request":
            with self._engine_lock:
                return self._do_extract(params)
        if method == "inject_request":
            with self._engine_lock:
                return self._do_inject(params, blobs), []
        if method == "health_payload":
            with self._engine_lock:
                return self.engine.health_payload(), []
        raise ValueError(f"unknown rpc method {method!r}")

    # ---- per-method bodies (engine lock held) ----------------------------
    def _do_hello(self) -> dict:
        eng = self.engine
        geo = None
        mg = getattr(eng, "migration_geometry", None)
        if mg is not None:
            g = mg()
            geo = list(g) if g is not None else None
        return {
            "engine_id": getattr(eng, "engine_id", None),
            "role": getattr(eng, "role", "mixed"),
            "block_size": int(getattr(eng, "block_size", 0) or 0),
            "has_prefix_cache":
                getattr(eng, "prefix_cache", None) is not None,
            "migration_geometry": geo,
            "max_slots": len(getattr(eng, "slots", []) or []),
            "pid": os.getpid(),
        }

    def _sampling_kwargs(self, params: dict) -> dict:
        kw = {}
        for name, cast in (("temperature", float), ("top_k", int),
                           ("top_p", float), ("seed", int)):
            if params.get(name):
                kw[name] = cast(params[name])
        return kw

    def _do_add(self, params: dict) -> dict:
        prompt = np.asarray(params["prompt_ids"], np.int64).reshape(-1)
        eos = params.get("eos_token_id")
        erid = self.engine.add_request(
            prompt, max_new_tokens=int(params.get("max_new_tokens", 16)),
            eos_token_id=int(eos) if eos is not None else None,
            **self._sampling_kwargs(params))
        with self._lock:
            self._shipped[int(erid)] = 0
        return {"req_id": int(erid)}

    def _do_inject(self, params: dict, blobs: List[bytes]) -> dict:
        # decode + geometry-validate the buffer BEFORE touching the
        # engine — a torn frame is a ValueError with zero side effects
        buf = buffer_from_wire(params.get("buffer"), blobs)
        if buf is None:
            raise ValueError("inject_request requires a KV buffer")
        prompt = np.asarray(params["prompt_ids"], np.int64).reshape(-1)
        eos = params.get("eos_token_id")
        erid = self.engine.inject_request(
            prompt, buf,
            max_new_tokens=int(params.get("max_new_tokens", 16)),
            eos_token_id=int(eos) if eos is not None else None,
            **self._sampling_kwargs(params))
        with self._lock:
            self._shipped[int(erid)] = 0
        slot = next((i for i, r in enumerate(
            getattr(self.engine, "slots", []) or [])
            if r is not None and r.req_id == erid), 0)
        return {"req_id": int(erid), "slot": int(slot),
                "state": "running"}

    def _do_preempt(self, params: dict) -> dict:
        erid = int(params["req_id"])
        prompt, gen = self.engine.preempt_request(erid)
        with self._lock:
            self._shipped.pop(erid, None)
        return {"prompt_ids": np.asarray(prompt).tolist(),
                "generated": [int(t) for t in gen]}

    def _do_extract(self, params: dict):
        erid = int(params["req_id"])
        ext = getattr(self.engine, "extract_request", None)
        if ext is None:
            prompt, gen = self.engine.preempt_request(erid)
            buf = None
        else:
            prompt, gen, buf = ext(erid)
        with self._lock:
            self._shipped.pop(erid, None)
        header, bblobs = buffer_to_wire(buf)
        return ({"prompt_ids": np.asarray(prompt).tolist(),
                 "generated": [int(t) for t in gen],
                 "buffer": header}, bblobs)

    def _do_step(self) -> dict:
        eng = self.engine
        done = [int(x) for x in (eng.step() if eng.has_work() else [])]
        finished = {}
        for erid in done:
            rec = eng.finished.pop(erid, None)
            finished[str(erid)] = {
                "output_ids": [int(t) for t in rec.output_ids]
                if rec is not None else [],
                "truncated": bool(getattr(rec, "truncated", False))}
        live = {}
        for r in list(getattr(eng, "waiting", []) or []):
            live[r.req_id] = r
        for r in list(getattr(eng, "slots", []) or []):
            if r is not None:
                live[r.req_id] = r
        with self._lock:
            tracked = dict(self._shipped)
        status = []
        for erid, shipped in tracked.items():
            if str(erid) in finished:
                continue
            r = live.get(erid)
            if r is None:
                rec = eng.finished.pop(erid, None)
                if rec is not None:
                    # a completion a step() return ever missed must
                    # degrade to a late completion, never a stall
                    done.append(int(erid))
                    finished[str(erid)] = {
                        "output_ids": [int(t) for t in rec.output_ids],
                        "truncated": bool(getattr(rec, "truncated",
                                                  False))}
                else:
                    status.append({"id": int(erid), "state": "gone"})
                continue
            out = [int(t) for t in r.output_ids]
            status.append({
                "id": int(erid), "state": getattr(r, "state", "running"),
                "slot": int(getattr(r, "slot", -1)),
                "new": out[shipped:], "n": len(out),
                "truncated": bool(getattr(r, "truncated", False))})
        with self._lock:
            for erid_s in finished:
                self._shipped.pop(int(erid_s), None)
            for st in status:
                if st.get("state") == "gone":
                    self._shipped.pop(st["id"], None)
                elif "n" in st:
                    self._shipped[st["id"]] = st["n"]
        payload = {"done": done, "finished": finished, "status": status,
                   "health": eng.health_payload()}
        pc = getattr(eng, "prefix_cache", None)
        if pc is not None:
            keys = list(pc.table.keys())[-self._max_prefix_keys:]
            payload["prefix_keys"] = [k.hex() for k in keys]
        return payload


# ---------------------------------------------------------------------------
# subprocess management
# ---------------------------------------------------------------------------
SERVER_MODULE = "paddle_tpu_torch.inference.engine_server"


class EngineProcess:
    """Spawns / kills / restarts one engine-server subprocess (by default
    ``python -m paddle_tpu_torch.inference.engine_server``; a
    ``server_script`` path runs that script instead) and resolves its
    listening address through a port file (bounded polling).  The child
    is started with ``subprocess``, never forked, and finds this package
    on its ``PYTHONPATH``.  ``kill()`` is SIGKILL — the drill the
    router's engine-lost path is tested against."""

    def __init__(self, config: dict, server_script=None, python=None,
                 env: Optional[Dict[str, str]] = None,
                 startup_timeout: float = 120.0, registry=None):
        self.config = dict(config)
        self._command = (
            [str(server_script)] if server_script
            else ["-m", SERVER_MODULE])
        self._python = str(python) if python else sys.executable
        self.env = dict(env) if env else {}
        self.startup_timeout = float(startup_timeout)
        self._proc: Optional[subprocess.Popen] = None
        self._address: Optional[Tuple[str, int]] = None
        self._dir: Optional[str] = None
        self._m_restarts = _fleet_metrics(registry)[3]

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return self._address

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    @property
    def log_path(self) -> Optional[str]:
        return (os.path.join(self._dir, "server.log")
                if self._dir else None)

    def spawn(self) -> Tuple[str, int]:
        if self.alive:
            return self._address
        self._dir = tempfile.mkdtemp(prefix="ptfleet-")
        cfg_path = os.path.join(self._dir, "config.json")
        port_path = os.path.join(self._dir, "port")
        with open(cfg_path, "w") as f:
            json.dump(self.config, f)
        env = {**os.environ, **self.env}
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        log = open(os.path.join(self._dir, "server.log"), "w")
        try:
            self._proc = subprocess.Popen(
                [self._python, *self._command, "--config", cfg_path,
                 "--port-file", port_path],
                stdout=log, stderr=subprocess.STDOUT, env=env)
        finally:
            log.close()
        deadline = time.monotonic() + self.startup_timeout
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise EngineRPCError(
                    "engine server exited rc=%s during startup (log: %s)"
                    % (self._proc.returncode, self.log_path))
            try:
                with open(port_path) as f:
                    line = f.read().strip()
                if line:
                    host, _, port = line.rpartition(":")
                    self._address = (host or "127.0.0.1", int(port))
                    return self._address
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        self.kill()
        raise EngineRPCError(
            "engine server did not publish a port within %.0fs (log: %s)"
            % (self.startup_timeout, self.log_path))

    def kill(self):
        """SIGKILL — no goodbye, the failure drill."""
        if self._proc is not None:
            try:
                self._proc.kill()
                self._proc.wait(timeout=10.0)
            except (OSError, subprocess.TimeoutExpired):  # pragma: no cover
                pass

    def terminate(self, timeout: float = 10.0):
        if self._proc is None:
            return
        try:
            self._proc.terminate()
            self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
        except OSError:             # pragma: no cover - already gone
            pass

    def wait(self, timeout: float = 60.0) -> Optional[int]:
        """Wait up to ``timeout`` seconds for the process to exit (after a
        ``shutdown`` RPC it prints its exit record first); returns its
        exit code, or None if it is still running."""
        if self._proc is None:
            return None
        try:
            return self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def restart(self) -> Tuple[str, int]:
        self.kill()
        self._proc = None
        self._address = None
        self._m_restarts.inc()
        return self.spawn()
