"""The port's multi-process fleet (``paddle_tpu_torch/inference/fleet.py``
and ``engine_server.py``) against the reference's, on the CPU.

The reference's tier-1 tests (``test_fleet.py``: PTF1 framing, the
KVPageBuffer wire form, retry arithmetic, the RPC round trip of the whole
engine surface over a stub engine, dedup-safe retries under injected
faults, the router's engine-lost drain, a server's death, the ``/healthz``
scrape retries) each run twice, over the reference's modules and over the
port's copies — the two cases of the ``m`` fixture; the round trip also
runs with one package's client against the other's server.  Across
packages: a port router drives a reference engine server and a port
engine server (the carried weights) as the prefill and decode roles, both
ways round, pages crossing PTF1 both ways, streams byte-identical to the
reference's eager greedy tokens (fp32); over bf16 pools the wire names the
pages ``"bfloat16"`` and re-encodes them bit for bit.  One real port
``EngineProcess`` on the CPU serves byte-identical to the in-process twin.
The reference's four slow drills (pool byte parity, cross-socket
migration, the hang-deadline drain, the kill -9 drill) run on port
processes under ``slow``.
"""
import os
import socket
import time
import types

import numpy as np
import pytest
import torch

from paddle_tpu.inference import fleet as ref_fleet
from paddle_tpu.inference import router as ref_router
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.ops.paged_attention import KVPageBuffer as RefKVPageBuffer
from paddle_tpu.testing import faults as ref_faults

from paddle_tpu_torch.inference import fleet as port_fleet
from paddle_tpu_torch.inference import router as port_router
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.ops.paged_attention import \
    KVPageBuffer as PortKVPageBuffer
from paddle_tpu_torch.testing import faults as port_faults


def _modules(fleet, router, metrics, buf, faults):
    return types.SimpleNamespace(
        EngineRPCError=fleet.EngineRPCError,
        EngineServer=fleet.EngineServer, ProtocolError=fleet.ProtocolError,
        RemoteEngineClient=fleet.RemoteEngineClient,
        RemoteRequestView=fleet.RemoteRequestView,
        RetryPolicy=fleet.RetryPolicy,
        buffer_from_wire=fleet.buffer_from_wire,
        buffer_to_wire=fleet.buffer_to_wire, recv_frame=fleet.recv_frame,
        send_frame=fleet.send_frame, EngineHandle=router.EngineHandle,
        ServingRouter=router.ServingRouter, KVPageBuffer=buf,
        default_registry=metrics.default_registry, faults=faults)


REF = _modules(ref_fleet, ref_router, ref_metrics, RefKVPageBuffer,
               ref_faults)
PORT = _modules(port_fleet, port_router, port_metrics, PortKVPageBuffer,
                port_faults)


@pytest.fixture(params=["reference", "port"])
def m(request):
    """The modules under test: the reference's or the port's."""
    return REF if request.param == "reference" else PORT


@pytest.fixture(autouse=True)
def _reset_faults():
    """Each package's injector is process-global: reset both."""
    for f in (ref_faults, port_faults):
        f.reset()
    yield
    for f in (ref_faults, port_faults):
        f.reset()


# ---------------------------------------------------------------------------
# stub engine (the test_serving_router contract, server-side here)
# ---------------------------------------------------------------------------
class _StubReq:
    def __init__(self, rid, prompt, budget):
        self.req_id = rid
        self.prompt_ids = np.asarray(prompt, np.int64)
        self.output_ids = []
        self.max_new_tokens = budget
        self.t_first_token = 0.0
        self.truncated = False
        self.slot = -1
        self.state = "waiting"


class _StubEngine:
    """Deterministic fake engine: each step admits waiting requests to
    slots and appends ``base + len(output)`` so streams are reproducible
    wherever the request runs."""
    block_size = 4

    def __init__(self, engine_id=0, slots=2, token_base=0):
        self.engine_id = engine_id
        self.role = "mixed"
        self.token_base = token_base
        self.waiting = []
        self.slots = [None] * slots
        self.finished = {}
        self.prefix_cache = None
        self._next = engine_id * 1000
        self.steps = 0

    def add_request(self, prompt_ids, max_new_tokens=16,
                    eos_token_id=None, **kw):
        self._next += 1
        r = _StubReq(self._next, prompt_ids, max_new_tokens)
        self.waiting.append(r)
        return r.req_id

    def has_work(self):
        return bool(self.waiting) or any(s is not None
                                         for s in self.slots)

    def step(self):
        self.steps += 1
        done = []
        for r in list(self.waiting):
            if None not in self.slots:
                break
            i = self.slots.index(None)
            self.slots[i] = r
            r.slot, r.state = i, "running"
            self.waiting.remove(r)
        for r in [s for s in self.slots if s is not None]:
            r.output_ids.append(self.token_base + len(r.output_ids))
            if len(r.output_ids) >= r.max_new_tokens:
                self.slots[r.slot] = None
                r.state = "done"
                self.finished[r.req_id] = r
                done.append(r.req_id)
        return done

    def preempt_request(self, req_id):
        for r in list(self.waiting) + [s for s in self.slots
                                       if s is not None]:
            if r.req_id == req_id:
                if r.slot >= 0:
                    self.slots[r.slot] = None
                else:
                    self.waiting.remove(r)
                return r.prompt_ids, list(r.output_ids)
        raise KeyError(req_id)

    def health_payload(self):
        return {"engine_id": self.engine_id,
                "occupancy": sum(s is not None for s in self.slots),
                "slots": len(self.slots),
                "waiting": len(self.waiting),
                "free_pages": 8, "total_pages": 8}


@pytest.fixture
def served_stub(m):
    """One EngineServer over a stub engine + a tight-deadline client."""
    eng = _StubEngine(engine_id=7)
    srv = m.EngineServer(eng, idle_poll_s=0.05).start()
    cli = m.RemoteEngineClient(
        srv.address,
        retry=m.RetryPolicy(max_attempts=3, base_delay=0.01,
                          max_delay=0.05),
        timeouts={"hello": 2.0, "add_request": 1.0, "step": 1.0,
                  "preempt_request": 1.0, "health_payload": 0.5})
    yield eng, srv, cli
    cli.close()
    srv.stop()


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def test_frame_roundtrip_over_socketpair(m):
    a, b = socket.socketpair()
    try:
        msg = {"id": 3, "method": "step", "params": {"x": [1, 2, 3]}}
        blobs = [b"\x00\x01\x02" * 100, b""]
        m.send_frame(a, msg, blobs, deadline=time.monotonic() + 2)
        got, gblobs = m.recv_frame(b, deadline=time.monotonic() + 2)
        assert got == msg
        assert gblobs == blobs
    finally:
        a.close()
        b.close()


def test_frame_bad_magic_raises_protocol_error(m):
    a, b = socket.socketpair()
    try:
        a.sendall(b"JUNK" + b"\x00" * 8)
        with pytest.raises(m.ProtocolError):
            m.recv_frame(b, deadline=time.monotonic() + 1)
    finally:
        a.close()
        b.close()


def test_kv_buffer_wire_byte_parity(m):
    rng = np.random.RandomState(5)
    # int8 pool WITH per-page scales, the gnarlier of the two planes
    codes = rng.randint(-127, 127, (2 * 2, 3, 4, 2, 8)).astype(np.int8)
    scales = rng.rand(4, 3, 2).astype(np.float32)
    buf = m.KVPageBuffer(codes=codes, scales=scales, n_pages=3,
                       n_tokens=10, block_size=4, num_kv_heads=2,
                       head_dim=8, num_layers=2, kv_dtype="int8")
    header, blobs = m.buffer_to_wire(buf)
    a, b = socket.socketpair()
    try:
        m.send_frame(a, {"id": 1, "buffer": header}, blobs,
                   deadline=time.monotonic() + 2)
        msg, gblobs = m.recv_frame(b, deadline=time.monotonic() + 2)
    finally:
        a.close()
        b.close()
    out = m.buffer_from_wire(msg["buffer"], gblobs)
    assert out.codes.tobytes() == codes.tobytes()
    assert out.scales.tobytes() == scales.tobytes()
    assert out.geometry() == buf.geometry()
    assert (out.n_pages, out.n_tokens) == (3, 10)
    # fp32 plane without scales
    f32 = rng.rand(2 * 1, 2, 4, 2, 8).astype(np.float32)
    buf2 = m.KVPageBuffer(codes=f32, scales=None, n_pages=2, n_tokens=8,
                        block_size=4, num_kv_heads=2, head_dim=8,
                        num_layers=1, kv_dtype="float32")
    h2, b2 = m.buffer_to_wire(buf2)
    out2 = m.buffer_from_wire(h2, b2)
    assert out2.codes.tobytes() == f32.tobytes()
    assert out2.scales is None


def test_kv_buffer_wire_validates_before_side_effects(m):
    header, blobs = m.buffer_to_wire(m.KVPageBuffer(
        codes=np.zeros((2, 1, 4, 2, 8), np.float32), scales=None,
        n_pages=1, n_tokens=4, block_size=4, num_kv_heads=2,
        head_dim=8, num_layers=1, kv_dtype="float32"))
    with pytest.raises(ValueError):
        m.buffer_from_wire(header, [blobs[0][:-4]])    # torn codes blob
    with pytest.raises(ValueError):
        m.buffer_from_wire({"num_layers": 1}, blobs)   # malformed header
    assert m.buffer_from_wire(None, []) is None


# ---------------------------------------------------------------------------
# retry policy (stub clock/rng — pure arithmetic)
# ---------------------------------------------------------------------------
def test_retry_policy_backoff_arithmetic(m):
    class _Rng:
        def random(self):
            return 0.5
    slept = []
    p = m.RetryPolicy(max_attempts=5, base_delay=0.1, max_delay=0.4,
                    jitter=0.5, rng=_Rng(), sleep=slept.append)
    # base * 2^(k-1) capped at max_delay, times (1 + 0.5*0.5)
    assert [round(p.delay(k), 6) for k in (1, 2, 3, 4)] == \
        [0.125, 0.25, 0.5, 0.5]
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert p.run(fn) == "ok"
    assert len(calls) == 3
    assert [round(s, 6) for s in slept] == [0.125, 0.25]

    # retries exhausted: the final failure propagates
    slept.clear()
    p2 = m.RetryPolicy(max_attempts=2, base_delay=0.1, jitter=0.0,
                     rng=_Rng(), sleep=slept.append)
    with pytest.raises(OSError):
        p2.run(lambda: (_ for _ in ()).throw(OSError("down")))
    assert len(slept) == 1   # one backoff between the two attempts


def test_retry_policy_jitter_bounds(m):
    p = m.RetryPolicy(max_attempts=3, base_delay=0.2, max_delay=5.0,
                    jitter=0.5)
    for k in (1, 2, 3):
        base = 0.2 * 2 ** (k - 1)
        for _ in range(50):
            d = p.delay(k)
            assert base <= d <= base * 1.5


# ---------------------------------------------------------------------------
# client <-> server over a real socket (in-process, stub engine)
# ---------------------------------------------------------------------------
def test_rpc_roundtrip_full_engine_surface(m, served_stub):
    eng, srv, cli = served_stub
    assert cli.engine_id == 7
    assert cli.role == "mixed"
    assert cli.block_size == 4
    assert cli.prefix_cache is None
    erid = cli.add_request(np.arange(5), max_new_tokens=3)
    assert [v.req_id for v in cli.waiting] == [erid]
    assert cli.has_work()
    done = []
    for _ in range(5):
        if not cli.has_work():
            break
        done += cli.step()
    assert done == [erid]
    rec = cli.finished.pop(erid)
    assert rec.output_ids == [0, 1, 2]
    assert rec.t_first_token > 0          # stamped on the CLIENT clock
    assert not cli.has_work()
    # preempt round-trip + KeyError for an unknown id (the in-process
    # error contract crosses the wire as types, not strings)
    e2 = cli.add_request(np.arange(3), max_new_tokens=10)
    cli.step()
    prompt, gen = cli.preempt_request(e2)
    assert prompt.tolist() == [0, 1, 2] and gen == [0]
    with pytest.raises(KeyError):
        cli.preempt_request(999999)
    assert cli.health_payload()["engine_id"] == 7


def test_step_retry_is_dedup_safe_under_drop(m, served_stub):
    """A dropped request frame -> deadline -> resend; the server's
    (token, id) dedup executes the step ONCE and replays the cached
    response — retried steps never double-advance the engine."""
    eng, srv, cli = served_stub
    erid = cli.add_request(np.arange(4), max_new_tokens=2)
    # hit 1 = the client's step request (passes), hit 2 = the SERVER's
    # response send (dropped): the engine executed, the reply vanished,
    # the client deadline fires and the resend gets the CACHED response
    m.faults.configure("drop:rpc.send:after=2:times=1")
    done = cli.step()
    m.faults.configure(None)
    assert eng.steps == 1                  # exactly one engine step
    assert done == []                      # request admitted, not done
    done = cli.step()
    assert done == [erid] and eng.steps == 2
    assert cli.finished[erid].output_ids == [0, 1]
    met = m.default_registry().get("router_rpc_retries_total")
    assert met is not None
    retried = {ch.labels["method"]: ch.value for ch in met.children()}
    assert retried.get("step", 0) >= 1


def test_econnreset_retries_then_succeeds(m, served_stub):
    eng, srv, cli = served_stub
    cli.add_request(np.arange(4), max_new_tokens=1)
    m.faults.configure("econnreset:rpc.recv:after=1:times=1")
    done = cli.step()
    m.faults.configure(None)
    assert len(done) == 1 and eng.steps == 1


def test_retries_exhausted_raises_engine_rpc_error(m, served_stub):
    eng, srv, cli = served_stub
    cli.add_request(np.arange(2), max_new_tokens=1)
    m.faults.configure("drop:rpc.send")      # every send vanishes
    t0 = time.monotonic()
    with pytest.raises(m.EngineRPCError) as ei:
        cli.step()
    m.faults.configure(None)
    assert ei.value.method == "step"
    assert ei.value.attempts == 3
    # bounded: attempts x deadline + backoff, nowhere near a hang
    assert time.monotonic() - t0 < 10.0


def test_server_accept_fault_then_recovery(m, served_stub):
    eng, srv, cli = served_stub
    cli.close()                            # force a fresh connection
    m.faults.configure("econnreset:rpc.accept:after=1:times=1")
    # server kills the first accepted conn; client reconnects + retries
    assert cli.health_payload()["engine_id"] == 7
    m.faults.configure(None)


# ---------------------------------------------------------------------------
# router integration: engine_lost drains from the ROUTER's record
# ---------------------------------------------------------------------------
class _DeadClient:
    """Stub RemoteEngineClient whose process just died: every RPC raises
    ``error`` (the package's EngineRPCError), but the router-side record
    (views + finished) survives — exactly what _lose_engine drains
    from."""
    block_size = 4

    def __init__(self, engine_id, views, error):
        self.error = error
        self.engine_id = engine_id
        self.role = "mixed"
        self.prefix_cache = None
        self.finished = {}
        self._views = {v.req_id: v for v in views}

    @property
    def waiting(self):
        return [v for v in self._views.values() if v.slot < 0]

    @property
    def slots(self):
        return [v for v in self._views.values() if v.slot >= 0]

    def has_work(self):
        return bool(self._views)

    def add_request(self, *a, **kw):
        raise self.error("rpc failed after 3 attempts",
                             method="add_request", attempts=3)

    def step(self):
        raise self.error("rpc failed after 3 attempts",
                             method="step", attempts=3)

    def preempt_request(self, req_id):
        raise self.error("rpc failed after 3 attempts",
                             method="preempt_request", attempts=3)

    def health_payload(self):
        raise self.error("rpc failed after 3 attempts",
                             method="health_payload", attempts=3)


def test_engine_lost_requeue_from_router_record_with_stub_client(m):
    survivor = _StubEngine(engine_id=1, slots=4, token_base=50)
    # the dead engine had generated 2 tokens for its one running view
    view = m.RemoteRequestView(req_id=2001, output_ids=[50, 51], slot=0,
                             state="running", t_first_token=time.
                             perf_counter())
    dead = _DeadClient(engine_id=2, views=[view], error=m.EngineRPCError)
    router = m.ServingRouter([survivor, dead],
                           probe_failure_threshold=1)
    rid = router.submit(np.arange(6), max_new_tokens=4)
    # force the pending request onto the dead client's books the way a
    # dispatch would have (we can't dispatch through it — RPCs raise)
    rr = router.pending[0]
    rr.state = "dispatched"
    rr.engine_id = 2
    rr.engine_req_id = 2001
    rr.engine_req = view
    rr.hops.append([2, 2001, time.perf_counter(), None])
    router.pending.clear()
    router._inflight[(2, 2001)] = rr
    out = router.run_to_completion()
    # zero drops: the tokens the dead engine generated (router record)
    # survive, the remainder regenerates on the survivor
    assert out[rid][:2] == [50, 51]
    assert len(out[rid]) == 4
    assert not router.handles[2].healthy
    met = m.default_registry().get("router_requeues_total")
    req = {ch.labels["reason"]: ch.value for ch in met.children()}
    assert req.get("engine_lost", 0) >= 1


def test_router_drives_remote_engines_and_survives_server_death(m):
    """Two stub engines behind REAL sockets; one server dies mid-run
    (no shutdown RPC — sockets just go dark).  Every request completes,
    with >=1 engine_lost requeue and the survivor finishing the work."""
    engines = [_StubEngine(engine_id=i, slots=2, token_base=100 * i)
               for i in (1, 2)]
    servers = [m.EngineServer(e, idle_poll_s=0.05).start()
               for e in engines]
    clients = [m.RemoteEngineClient(
        s.address,
        retry=m.RetryPolicy(max_attempts=2, base_delay=0.01,
                          max_delay=0.02),
        timeouts={"hello": 2.0, "add_request": 0.5, "step": 0.5,
                  "preempt_request": 0.5, "extract_request": 0.5,
                  "health_payload": 0.3}) for s in servers]
    try:
        router = m.ServingRouter(clients, probe_failure_threshold=2)
        rids = [router.submit(np.arange(4) + i, max_new_tokens=4)
                for i in range(4)]
        for _ in range(2):
            router.step()
        servers[0].stop()                  # dark, mid-flight
        out = router.run_to_completion()
        assert sorted(out) == sorted(rids)
        assert all(len(v) == 4 for v in out.values())
        healthy = [h for h in router.handles.values() if h.healthy]
        assert len(healthy) == 1
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.stop()


def test_engine_handle_healthz_scrape_retries(m):
    """The /healthz scrape satellite: one flaky read retries inside the
    probe via the shared m.RetryPolicy instead of burning a probe-failure
    count."""
    calls = []

    class _FlakyEngine:
        def health_payload(self):
            calls.append(1)
            if len(calls) < 2:
                raise OSError("scrape blip")
            return {"occupancy": 0, "slots": 2, "waiting": 0}

    h = m.EngineHandle(_FlakyEngine(), engine_id=9,
                     retry=m.RetryPolicy(max_attempts=3, base_delay=0.0,
                                       jitter=0.0))
    # in-process payload() doesn't retry (no wire) — probe() fails once
    assert h.probe() is False
    calls.clear()

    # the URL path retries through RetryPolicy.run: simulate with a
    # handle whose scrape fn we drive directly
    attempts = []

    def flaky_scrape():
        attempts.append(1)
        if len(attempts) < 3:
            raise OSError("timeout")
        return {"ok": 1}

    assert h.retry.run(flaky_scrape) == {"ok": 1}
    assert len(attempts) == 3


@pytest.mark.parametrize("client,server", [("reference", "port"),
                                           ("port", "reference")])
def test_rpc_roundtrip_across_packages(client, server):
    """One package's client drives the other's server through the whole
    stub engine surface: the wire is the same bytes both ways."""
    c, s = (REF if client == "reference" else PORT,
            REF if server == "reference" else PORT)
    eng = _StubEngine(engine_id=5)
    srv = s.EngineServer(eng, idle_poll_s=0.05).start()
    cli = c.RemoteEngineClient(
        srv.address, retry=c.RetryPolicy(max_attempts=2, base_delay=0.01),
        timeouts={"hello": 2.0, "add_request": 1.0, "step": 1.0,
                  "preempt_request": 1.0, "health_payload": 0.5})
    try:
        assert (cli.engine_id, cli.role, cli.block_size) == (5, "mixed", 4)
        erid = cli.add_request(np.arange(5), max_new_tokens=3)
        done = []
        while cli.has_work():
            done += cli.step()
        assert done == [erid]
        assert cli.finished.pop(erid).output_ids == [0, 1, 2]
        e2 = cli.add_request(np.arange(3), max_new_tokens=10)
        cli.step()
        prompt, gen = cli.preempt_request(e2)
        assert prompt.tolist() == [0, 1, 2] and gen == [0]
        with pytest.raises(KeyError):
            cli.preempt_request(999999)
        assert cli.health_payload()["engine_id"] == 5
    finally:
        cli.close()
        srv.stop()


def test_shutdown_reply_arrives_before_the_server_stops():
    """A ``shutdown`` RPC gets its reply although the serve loop stops the
    server the moment the RPC sets the stop flag: the port's
    ``serve_forever`` lets each connection finish its reply before the
    sockets close (the reply is held back here, by a delay on the
    server's send, until well after the flag is set)."""
    import threading
    eng = _StubEngine(engine_id=3)
    srv = port_fleet.EngineServer(eng, idle_poll_s=0.05).start()
    loop = threading.Thread(target=srv.serve_forever, daemon=True)
    loop.start()
    cli = port_fleet.RemoteEngineClient(
        srv.address, retry=port_fleet.RetryPolicy(max_attempts=1),
        timeouts={"hello": 2.0, "shutdown": 5.0})
    assert cli.engine_id == 3
    port_faults.configure("delay:rpc.send:ms=700")
    cli.shutdown_server()                  # raises if the reply is lost
    port_faults.configure(None)
    loop.join(timeout=10.0)
    assert not loop.is_alive()


def test_bf16_pages_cross_the_wire_as_bfloat16():
    """The port holds bf16 pages as uint16 patterns: on the wire they are
    ``"bfloat16"`` (the reference's name) with the same bytes, and a
    buffer from either package decodes on the other's side bit for bit."""
    import ml_dtypes
    rng = np.random.RandomState(2)
    bits = rng.randint(0, 1 << 16, (2 * 2, 3, 4, 2, 8)).astype(np.uint16)
    geo = dict(n_pages=3, n_tokens=10, block_size=4, num_kv_heads=2,
               head_dim=8, num_layers=2, kv_dtype="bfloat16")
    port_buf = PortKVPageBuffer(codes=bits, scales=None, **geo)
    ref_buf = RefKVPageBuffer(codes=bits.view(ml_dtypes.bfloat16),
                              scales=None, **geo)
    ph, pb = port_fleet.buffer_to_wire(port_buf)
    rh, rb = ref_fleet.buffer_to_wire(ref_buf)
    assert ph == rh and ph["codes_dtype"] == "bfloat16"
    assert pb == rb
    back = port_fleet.buffer_from_wire(rh, rb)           # reference -> port
    assert back.codes.dtype == np.uint16
    assert back.codes.tobytes() == bits.tobytes()
    assert back.geometry() == port_buf.geometry()
    there = ref_fleet.buffer_from_wire(ph, pb)           # port -> reference
    assert str(there.codes.dtype) == "bfloat16"
    assert there.codes.view(np.uint16).tobytes() == bits.tobytes()


# ---------------------------------------------------------------------------
# across packages: a reference server and a port server behind one router
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    """``llama_tiny_config()``: the reference model and the port model
    holding its weights."""
    from test_torch_split_serving import _pair
    return _pair()


def _cross_prompts(vocab):
    rng = np.random.RandomState(4)
    return [rng.randint(1, vocab - 60, (9,)).astype(np.int64)
            for _ in range(3)]


@pytest.fixture(scope="module")
def ref_eager(pair):
    """The reference's eager greedy tokens for the cross-package prompts
    (computed once: the reference's ``generate`` is the slow part)."""
    from tools.bench_common import eager_reference
    ref = pair[0]
    return [eager_reference(ref, p, CROSS_BUDGET)
            for p in _cross_prompts(ref.config.vocab_size)]


CROSS_BUDGET = 6


@pytest.fixture(scope="module")
def bf16_pair():
    """The tiny model in bf16 in both packages: the reference's seeded
    bf16 model and the port's holding its weights (bf16 -> fp32 -> bf16
    is exact)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
    from paddle_tpu.models.llama import llama_tiny_config as ref_tiny
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.testing.parity import load_paddle_tpu_weights
    paddle.seed(0)
    ref_cfg = ref_tiny(dtype="bfloat16")
    ref = RefLlama(ref_cfg).bfloat16()
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig(**{
        f: getattr(ref_cfg, f) for f in LlamaConfig.__dataclass_fields__}),
        device="cpu")
    load_paddle_tpu_weights(port, {
        k: np.asarray(v._value).astype(np.float32)
        for k, v in ref.state_dict().items()})
    return ref, port


def _cross_engines(pair, prefill_is):
    """A reference engine and a port engine over ``pair``, one
    ``role="prefill"`` and one ``role="decode"``."""
    from paddle_tpu.inference.serving import ContinuousBatchingEngine as Ref
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    ref, port = pair
    kw = dict(max_batch_size=4, num_blocks=64, block_size=4,
              mixed_step=True, prefill_chunk_size=8,
              enable_prefix_cache=False)
    roles = (("prefill", "decode") if prefill_is == "reference"
             else ("decode", "prefill"))
    r = Ref(ref, role=roles[0], engine_id=2300, **kw)
    p = ContinuousBatchingEngine(port, role=roles[1], engine_id=2301,
                                 device="cpu", **kw)
    return ref, port, r, p


@pytest.mark.parametrize("prefill_is", ["reference", "port"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_router_over_reference_and_port_servers(request, ref_eager, bf16,
                                                prefill_is, monkeypatch):
    """A port ServingRouter over port RemoteEngineClients of a reference
    EngineServer and a port EngineServer, prefill on one package and
    decode on the other: every request prefills on the prefill engine and
    resumes on the decode engine from pages that crossed PTF1 (the
    dispatch span says migrated, one migration each), both pools end
    whole, and in fp32 every stream equals the reference's eager greedy
    tokens.  Over bf16 pools the buffers cross as ``"bfloat16"`` and
    re-encode bit for bit on the client."""
    pair = request.getfixturevalue("bf16_pair" if bf16 else "pair")
    ref_model, port_model, r_eng, p_eng = _cross_engines(pair, prefill_is)
    seen = []
    decode = port_fleet.buffer_from_wire

    def spy(header, blobs):
        buf = decode(header, blobs)
        if buf is not None:
            seen.append((header, [bytes(b) for b in blobs],
                         port_fleet.buffer_to_wire(buf)))
        return buf
    monkeypatch.setattr(port_fleet, "buffer_from_wire", spy)
    servers = [ref_fleet.EngineServer(r_eng, idle_poll_s=0.05).start(),
               port_fleet.EngineServer(p_eng, idle_poll_s=0.05).start()]
    # fresh payloads on every read, as in process
    clients = [port_fleet.RemoteEngineClient(s.address, health_cache_s=0.0)
               for s in servers]
    if prefill_is == "port":
        clients.reverse()
    try:
        router = port_router.ServingRouter(clients)
        prompts = _cross_prompts(ref_model.config.vocab_size)
        rids = [router.submit(p, max_new_tokens=CROSS_BUDGET)
                for p in prompts]
        out = router.run_to_completion()
        ids = [c.engine_id for c in clients]
        for rid, want in zip(rids, ref_eager):
            rr = router.finished[rid]
            assert rr.engines_visited() == ids and rr.migrations == 1
            assert any(ev[1] == "dispatch" and ev[-1].get("migrated")
                       for ev in router.tracer.events(rid))
            assert len(out[rid]) == CROSS_BUDGET
            if not bf16:
                assert out[rid] == want, rid
        # the client decodes every extract reply; the port server (in
        # this process) every inject it is sent: one buffer a migration
        # crosses the port's codec once or twice
        assert len(seen) == (6 if prefill_is == "reference" else 3)
        for header, blobs, (h2, b2) in seen:
            assert h2 == header and b2 == blobs
            assert header["codes_dtype"] == ("bfloat16" if bf16
                                             else "float32")
        for c in clients:
            hp = c.health_payload()
            assert hp["free_pages"] == hp["total_pages"]
        assert p_eng.prefill_tokens == (0 if prefill_is == "reference"
                                        else sum(map(len, prompts)))
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.stop()


# ---------------------------------------------------------------------------
# one real engine-server subprocess (the CPU, the tiny model)
# ---------------------------------------------------------------------------
_FLEET_CFG = {
    "platform": "cpu", "seed": 0, "slots": 2, "num_blocks": 96,
    "block_size": 4, "chunk": None, "mixed_step": True,
    "enable_prefix_cache": False, "warm": {"prompt_len": 12,
                                           "budget": 4},
}
SUBPROCESS_TIMEOUT_S = 120.0


def _fleet_prompts(vocab, n=4, rng_seed=3):
    rng = np.random.RandomState(rng_seed)
    return [rng.randint(1, vocab - 60, (6 + i,)).astype(np.int64)
            for i in range(n)]


def _fleet_clients(addrs, step_timeout=240.0):
    return [port_fleet.RemoteEngineClient(
        a, retry=port_fleet.RetryPolicy(max_attempts=2, base_delay=0.05,
                                        max_delay=0.5),
        timeouts={"step": step_timeout, "add_request": 60.0,
                  "hello": 60.0, "extract_request": 120.0,
                  "inject_request": 240.0, "preempt_request": 60.0,
                  "health_payload": 10.0}) for a in addrs]


def _spawn_pool(n, cfg_overrides=None, startup_timeout=600.0):
    procs = []
    for i in range(n):
        cfg = dict(_FLEET_CFG, engine_id=10 + i)
        cfg.update(cfg_overrides or {})
        procs.append(port_fleet.EngineProcess(
            cfg, startup_timeout=startup_timeout))
    try:
        addrs = [p.spawn() for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return procs, addrs


def test_engine_process_serves_like_the_in_process_engine():
    """A real ``python -m paddle_tpu_torch.inference.engine_server``
    child on the CPU (``"platform": "cpu"``, the tiny model) behind the
    router: streams byte-identical to the same config's in-process
    engine, the pool whole, and on shutdown one exit record whose launch
    counts are 0 (the CPU path launches no kernel) and whose step count
    is the served steps."""
    import json
    from paddle_tpu_torch.inference.engine_server import (
        build_engine_from_config)
    t0 = time.monotonic()
    procs, addrs = _spawn_pool(1, startup_timeout=SUBPROCESS_TIMEOUT_S)
    proc = procs[0]
    cli = _fleet_clients(addrs, step_timeout=30.0)[0]
    try:
        model_cfg, twin = build_engine_from_config(dict(_FLEET_CFG,
                                                        engine_id=99))
        prompts = _fleet_prompts(model_cfg.vocab_size)
        router = port_router.ServingRouter([cli])
        rids = [router.submit(p, max_new_tokens=5) for p in prompts]
        out = router.run_to_completion()
        want = [twin.add_request(p, max_new_tokens=5) for p in prompts]
        ref = twin.run_to_completion()
        assert [out[r] for r in rids] == [ref[r] for r in want]
        hp = cli.health_payload()
        assert hp["free_pages"] == hp["total_pages"] == 96
        assert cli.server_pid == proc._proc.pid != os.getpid()
        cli.shutdown_server()
        assert proc.wait(timeout=30.0) == 0
        with open(proc.log_path) as f:
            rec = json.loads(f.read().strip().splitlines()[-1])
        rec = rec["engine_server"]
        assert set(rec["launches"].values()) == {0}
        assert rec["steps"]["mixed"] >= 5
        assert rec["prefill_tokens"] == sum(map(len, prompts))
    finally:
        cli.close()
        proc.kill()
    assert time.monotonic() - t0 < SUBPROCESS_TIMEOUT_S


def test_server_without_platform_needs_the_card(tmp_path):
    """A config that names no platform means the CUDA card: on a machine
    without one the server raises instead of serving on the CPU."""
    from paddle_tpu_torch.inference.engine_server import (
        build_engine_from_config)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is valid here")
    cfg = {k: v for k, v in _FLEET_CFG.items() if k != "platform"}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine_from_config(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine_from_config(dict(cfg, platform="gpu"))


# ---------------------------------------------------------------------------
# slow lane: real subprocesses, real engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleet_pool():
    """Two real port engine-server subprocesses (tiny llama, warmed) —
    the LAST test using this fixture kills process 0 on purpose."""
    procs, addrs = _spawn_pool(2)
    yield procs, addrs
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def eager_oracle():
    """Eager greedy ``generate`` on the SAME seeded tiny model the
    subprocess engines built."""
    from paddle_tpu_torch.inference.engine_server import (
        build_engine_from_config)
    cfg, eng = build_engine_from_config(dict(_FLEET_CFG))
    model = eng.model

    def eager(prompt, budget):
        ids = torch.from_numpy(np.asarray(prompt, np.int64))[None]
        return model.generate(ids, budget)[0, len(prompt):].tolist()
    return cfg, eager


@pytest.mark.slow
def test_multiprocess_pool_byte_parity(fleet_pool, eager_oracle):
    procs, addrs = fleet_pool
    cfg, eager = eager_oracle
    clients = _fleet_clients(addrs)
    try:
        router = port_router.ServingRouter(clients)
        prompts = _fleet_prompts(cfg.vocab_size, n=4)
        rids = [router.submit(p, max_new_tokens=5) for p in prompts]
        out = router.run_to_completion()
        assert sorted(out) == sorted(rids)
        used = set()
        for r in rids:
            used.update(router.finished[r].engines_visited())
        assert len(used) == 2, "expected both processes to serve"
        for rid, prompt in zip(rids, prompts):
            assert out[rid] == eager(prompt, 5), rid
    finally:
        for c in clients:
            c.close()


@pytest.mark.slow
def test_cross_socket_migration_byte_identical(fleet_pool, eager_oracle):
    """extract_request on process A -> KVPageBuffer over the wire ->
    inject_request on process B; the continuation equals the
    uninterrupted eager stream (zero re-prefill resume)."""
    procs, addrs = fleet_pool
    cfg, eager = eager_oracle
    a, b = _fleet_clients(addrs)
    try:
        prompt = _fleet_prompts(cfg.vocab_size, n=1, rng_seed=11)[0]
        budget = 6
        ref = eager(prompt, budget)
        erid = a.add_request(prompt, max_new_tokens=budget)
        gen = []
        while len(gen) < 2:
            a.step()
            view = next(v for v in a.slots + a.waiting
                        if v.req_id == erid)
            gen = list(view.output_ids)
        _prompt, gen, buf = a.extract_request(erid)
        assert buf is not None and buf.n_tokens >= len(prompt)
        assert gen == ref[:len(gen)]
        resume = np.concatenate([prompt, np.asarray(gen, np.int64)])
        erid_b = b.inject_request(resume, buf,
                                  max_new_tokens=budget - len(gen))
        while b.has_work():
            b.step()
        assert gen + b.finished.pop(erid_b).output_ids == ref
    finally:
        a.close()
        b.close()


@pytest.mark.slow
def test_fault_injected_hang_deadline_drain(eager_oracle):
    """A server process whose RPC plane hangs mid-run: the client's
    deadline fires, retries exhaust, and the router drains the engine
    and finishes everything on the survivor."""
    cfg, eager = eager_oracle
    procs, addrs = _spawn_pool(1)
    hang_procs, hang_addrs = _spawn_pool(1, cfg_overrides={
        "engine_id": 66, "fault_spec": "hang:rpc.recv:ms=60000:after=4"})
    clients = _fleet_clients(addrs) + _fleet_clients(hang_addrs,
                                                     step_timeout=8.0)
    clients[1]._timeouts.update({"add_request": 8.0,
                                 "extract_request": 8.0,
                                 "preempt_request": 8.0,
                                 "health_payload": 4.0})
    try:
        router = port_router.ServingRouter(clients,
                                           probe_failure_threshold=2)
        prompts = _fleet_prompts(cfg.vocab_size, n=4, rng_seed=7)
        t0 = time.monotonic()
        rids = [router.submit(p, max_new_tokens=4) for p in prompts]
        out = router.run_to_completion()
        assert sorted(out) == sorted(rids)
        for rid, prompt in zip(rids, prompts):
            assert out[rid] == eager(prompt, 4)
        assert time.monotonic() - t0 < 180.0
        assert not router.handles[66].healthy
    finally:
        for c in clients:
            c.close()
        for p in procs + hang_procs:
            p.kill()


@pytest.mark.slow
def test_kill9_drill_zero_drops(fleet_pool, eager_oracle):
    """SIGKILL a real port engine-server subprocess mid-decode: zero
    dropped requests, streams equal eager, an engine_lost requeue, the
    survivor's pool whole, span chains valid.  Runs LAST against the
    module pool (it eats one of its processes)."""
    from paddle_tpu_torch.observability.request_trace import (
        validate_span_chain)
    procs, addrs = fleet_pool
    cfg, eager = eager_oracle
    clients = _fleet_clients(addrs)
    met = port_metrics.default_registry().get("router_requeues_total")
    before = ({ch.labels["reason"]: ch.value for ch in met.children()}
              if met else {})
    try:
        router = port_router.ServingRouter(clients,
                                           probe_failure_threshold=2)
        prompts = _fleet_prompts(cfg.vocab_size, n=4, rng_seed=23)
        rids = [router.submit(p, max_new_tokens=5) for p in prompts]
        for _ in range(2):
            router.step()
        victim = next(
            h.engine_id for h in router.handles.values()
            if any(k[0] == h.engine_id for k in router._inflight))
        procs[[c.engine_id for c in clients].index(victim)].kill()
        out = router.run_to_completion()
        assert sorted(out) == sorted(rids), "dropped request(s)"
        for rid, prompt in zip(rids, prompts):
            assert out[rid] == eager(prompt, 5)
        met = port_metrics.default_registry().get("router_requeues_total")
        after = {ch.labels["reason"]: ch.value for ch in met.children()}
        assert after.get("engine_lost", 0) > before.get("engine_lost", 0)
        for rid in rids:
            ok, why = validate_span_chain(router.tracer.events(rid))
            assert ok, (rid, why)
        survivor = next(c for c in clients if c.engine_id != victim)
        hp = survivor.health_payload()
        assert hp["free_pages"] == hp["total_pages"]
        assert hp["occupancy"] == 0 and hp["waiting"] == 0
    finally:
        for c in clients:
            c.close()
