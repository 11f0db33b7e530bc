"""The port's observability copies (``paddle_tpu_torch/observability``)
on the CPU: ``test_observability.py``'s tests that need no JAX — the
registry semantics, the Prometheus text format, histogram quantiles, the
span log, the chrome-trace merge, the HTTP endpoint — each run over the
reference's modules and over the port's (the two cases of the ``obs``
fixture); the metric-name and label-cardinality lint over the port's
sources; and the serving engine's metric families, which must be the
reference engine's minus those of features the port does not have.
"""
from __future__ import annotations

import collections
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import observability as ref_obs

from test_torch_split_serving import TINY, _pair
from paddle_tpu_torch import observability as port_obs
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a host span as ``merge_chrome_trace`` reads one
HostSpan = collections.namedtuple("HostSpan", "name start end tid")

# reference engine families the port leaves out: their features
# (tensor/context/expert parallelism, fsdp, MoE dispatch, quantized
# collectives) are not ported
UNPORTED_FAMILIES = {
    "serving_tp_collective_bytes_total", "serving_cp_collective_bytes_total",
    "serving_ep_collective_bytes_total", "serving_moe_dispatch_tokens_total",
    "spmd_allgather_bytes_total", "serving_quant_collective_bytes_total"}


@pytest.fixture(params=["reference", "port"])
def obs(request):
    return ref_obs if request.param == "reference" else port_obs


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------
def test_counter_gauge_basics_and_idempotent_registration(obs):
    r = obs.MetricsRegistry()
    c = r.counter("reqs_total", "requests")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(obs.MetricError):
        c.inc(-1)                      # counters only go up
    g = r.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    assert g.value == 5
    assert r.counter("reqs_total", "requests") is c
    with pytest.raises(obs.MetricError):
        r.gauge("reqs_total")
    with pytest.raises(obs.MetricError):
        r.counter("reqs_total", labels=("method",))
    with pytest.raises(obs.MetricError):
        r.counter("notATotal", "bad case")
    with pytest.raises(obs.MetricError):
        r.counter("missing_suffix", "counters need _total")
    with pytest.raises(obs.MetricError):
        r.gauge("depth_total", "_total reserved for counters")


def test_label_cardinality_and_schema(obs):
    r = obs.MetricsRegistry()
    c = r.counter("rpc_total", "calls", labels=("method", "code"))
    c.labels(method="get", code="200").inc()
    c.labels(method="get", code="500").inc(2)
    c.labels(code="200", method="get").inc()       # kwarg order free
    assert c.labels(method="get", code="200").value == 2
    assert len(c.children()) == 2
    with pytest.raises(obs.MetricError):
        c.labels(method="get")                     # missing label
    with pytest.raises(obs.MetricError):
        c.labels(method="get", code="200", extra="x")
    with pytest.raises(obs.MetricError):
        c.inc()                # labeled metric needs .labels(...)
    snap = r.snapshot()
    assert {s["labels"]["code"] for s in
            snap["rpc_total"]["series"]} == {"200", "500"}


def test_histogram_fixed_buckets(obs):
    r = obs.MetricsRegistry()
    h = r.histogram("wait_seconds", "wait", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.01, 0.05, 0.5, 2.0):
        h.observe(v)
    child = h.children()[0]
    assert child._counts == [2, 1, 1, 1]       # 0.01 lands in le=0.01
    assert child.cumulative() == [2, 3, 4, 5]
    assert h.count == 5
    assert abs(h.sum - 2.565) < 1e-9
    with pytest.raises(obs.MetricError):
        r.histogram("bad_seconds", buckets=(1.0, 0.5))
    with pytest.raises(obs.MetricError):
        r.histogram("worse_seconds", buckets=())


def test_concurrent_increments_are_exact(obs):
    r = obs.MetricsRegistry()
    c = r.counter("spins_total", "concurrent")
    h = r.histogram("spin_seconds", "concurrent", buckets=(0.5,))
    n, per = 8, 5000

    def work():
        for _ in range(per):
            c.inc()
            h.observe(0.25)

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n * per
    assert h.count == n * per
    assert h.children()[0].cumulative()[-1] == n * per


def test_prometheus_text_format_and_escaping(obs):
    r = obs.MetricsRegistry()
    c = r.counter("odd_total", 'help with \\ and\nnewline',
                  labels=("tag",))
    c.labels(tag='va"l\\ue\nx').inc()
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    text = obs.generate_latest(r).decode()
    assert r"# HELP odd_total help with \\ and\nnewline" in text
    assert "# TYPE odd_total counter" in text
    assert 'odd_total{tag="va\\"l\\\\ue\\nx"} 1' in text
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1"} 1' in text
    assert 'lat_seconds_bucket{le="+Inf"} 2' in text
    assert "lat_seconds_sum 5.05" in text
    assert "lat_seconds_count 2" in text
    js = json.dumps(obs.json_snapshot(r))
    assert "odd_total" in js and "lat_seconds" in js


def test_histogram_quantile_pins_against_numpy(obs):
    reg = obs.MetricsRegistry()
    buckets = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
    h = reg.histogram("q_seconds", "", buckets=buckets)
    rng = np.random.RandomState(7)
    sample = rng.gamma(2.0, 0.05, size=2000)
    for v in sample:
        h.observe(float(v))
    bounds = (0.0,) + buckets
    for q in (0.1, 0.5, 0.9, 0.95, 0.99):
        est = h.quantile(q)
        true = float(np.quantile(sample, q))
        i = min(int(np.searchsorted(buckets, true)), len(buckets) - 1)
        assert abs(est - true) <= buckets[i] - bounds[i], (q, est, true)
    qs = [h.quantile(q) for q in (0.05, 0.25, 0.5, 0.75, 0.95)]
    assert qs == sorted(qs)
    h2 = reg.histogram("q2_seconds", "", buckets=(1.0, 2.0))
    assert h2.quantile(0.5) != h2.quantile(0.5)    # NaN
    for _ in range(5):
        h2.observe(100.0)
    assert h2.quantile(0.99) == 2.0
    hl = reg.histogram("q3_seconds", "", labels=("kind",),
                       buckets=(1.0, 2.0, 4.0))
    for _ in range(10):
        hl.labels(kind="decode").observe(0.5)
        hl.labels(kind="prefill").observe(3.0)
    assert hl.labels(kind="decode").quantile(0.5) <= 1.0
    assert hl.labels(kind="prefill").quantile(0.5) > 2.0


def test_span_log_bound_holds_under_concurrent_writers(obs):
    log = obs.SpanLog(maxlen=64)
    errs = []

    def writer(tid):
        try:
            for i in range(500):
                log.record("w%d" % tid, float(i), float(i) + 0.5, idx=i)
                if i % 7 == 0:
                    log.instant("i%d" % tid, ts=float(i))
        except Exception as e:                    # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(log) == 64
    for ph, name, cat, start, end, args, ident in log.events():
        assert ph in ("X", "i") and isinstance(args, dict)
    log.clear()
    assert len(log) == 0


# ---------------------------------------------------------------------------
# chrome-trace merge
# ---------------------------------------------------------------------------
def test_merge_chrome_trace_deterministic_tie_order(obs, tmp_path):
    t = time.perf_counter()
    host = [HostSpan("zeta", t, t + 0.1, 5), HostSpan("alpha", t, t + 0.1, 3)]
    log = obs.SpanLog()
    log.record("mid", t, t + 0.05)
    out1 = obs.merge_chrome_trace(str(tmp_path / "a.json"),
                                  host_events=host, runtime_events=log)
    out2 = obs.merge_chrome_trace(str(tmp_path / "b.json"),
                                  host_events=list(reversed(host)),
                                  runtime_events=log)
    d1, d2 = json.load(open(out1)), json.load(open(out2))
    assert d1["traceEvents"] == d2["traceEvents"]
    spans = [e for e in d1["traceEvents"] if e["ph"] != "M"]
    keys = [(e["ts"], e["pid"], e["tid"], e["name"]) for e in spans]
    assert keys == sorted(keys)
    assert d1["traceEvents"][0]["ph"] != "M"
    assert d1["traceEvents"][-1]["ph"] == "M"


def test_merge_chrome_trace_extra_groups(obs, tmp_path):
    t = time.perf_counter()
    log = obs.SpanLog()
    log.record("runtime_span", t, t + 0.01)
    group = [{"name": "req 0", "cat": "request", "ph": "X",
              "tid": 0, "ts": t + 1.0, "dur": 0.5},
             {"name": "thread_name", "ph": "M", "tid": 0,
              "args": {"name": "req 0"}}]
    out = obs.merge_chrome_trace(str(tmp_path / "g.json"),
                                 runtime_events=log,
                                 extra_groups=[("engine 9", group)])
    data = json.load(open(out))
    names = {e["args"]["name"] for e in data["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert "engine 9" in names
    span = next(e for e in data["traceEvents"] if e["name"] == "req 0")
    rt = next(e for e in data["traceEvents"] if e["name"] == "runtime_span")
    assert abs((span["ts"] - rt["ts"]) - 1.0 * 1e6) < 1e3
    assert span["dur"] == pytest.approx(0.5 * 1e6)
    assert span["pid"] != rt["pid"]


def test_merge_chrome_trace_with_runtime_spans(obs, tmp_path):
    log = obs.SpanLog()
    t = time.perf_counter()
    log.record("ckpt_write", t + 2.0, t + 2.01, cat="checkpoint", step=7)
    log.instant("comm_timeout:allreduce", ts=t + 3.0, cat="comm")
    host = [HostSpan("train_region", t, t + 0.5, 1)]
    out = obs.merge_chrome_trace(str(tmp_path / "merged.json"),
                                 host_events=host, runtime_events=log)
    data = json.load(open(out))
    names = {e["name"] for e in data["traceEvents"]}
    assert "ckpt_write" in names and "comm_timeout:allreduce" in names
    span = next(e for e in data["traceEvents"] if e["name"] == "ckpt_write")
    assert span["ph"] == "X" and span["args"]["step"] == 7
    inst = next(e for e in data["traceEvents"]
                if e["name"].startswith("comm_timeout"))
    assert inst["ph"] == "i"
    host_ev = next(e for e in data["traceEvents"]
                   if e["name"] == "train_region")
    assert abs((span["ts"] - host_ev["ts"]) - 2.0 * 1e6) < 1e3


def test_merge_takes_a_torch_profiler_trace_dir(tmp_path):
    """The port's merge reads a ``torch.profiler`` chrome export as its
    device trace directory (profiled here on the CPU): its events land in
    their own pid range beside the runtime spans; a missing directory
    merges to host spans alone."""
    from torch.profiler import ProfilerActivity, profile
    d = tmp_path / "prof"
    d.mkdir()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.export_chrome_trace(str(d / "step.pt.trace.json"))
    log = port_obs.SpanLog()
    t = time.perf_counter()
    log.record("step", t, t + 0.01)
    dev = port_obs.load_device_trace_events(str(d))
    assert dev
    out = port_obs.merge_chrome_trace(str(tmp_path / "m.json"),
                                      runtime_events=log,
                                      device_trace_dir=str(d))
    evs = json.load(open(out))["traceEvents"]
    assert any(e.get("pid", 0) >= 1_000_000 and e.get("ph") == "X"
               for e in evs)
    assert any(e["name"] == "step" for e in evs)
    bare = port_obs.merge_chrome_trace(str(tmp_path / "h.json"),
                                       runtime_events=log,
                                       device_trace_dir=str(tmp_path / "no"))
    assert all(e.get("pid", 0) < 1_000_000
               for e in json.load(open(bare))["traceEvents"])


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------
def test_http_endpoint_lifecycle(obs, monkeypatch):
    import urllib.error
    import urllib.request
    r = obs.MetricsRegistry()
    r.counter("pings_total", "demo").inc(3)
    srv = obs.MetricsServer(port=0, addr="127.0.0.1", registry=r).start()
    try:
        port = srv.port
        assert port and srv.running
        body = urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % port, timeout=10).read()
        assert b"pings_total 3" in body
        hz = urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % port, timeout=10)
        assert hz.status == 200 and b"ok" in hz.read()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen("http://127.0.0.1:%d/nope" % port,
                                   timeout=10)
    finally:
        srv.stop()
    assert not srv.running
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen("http://127.0.0.1:%d/healthz" % port,
                               timeout=2)
    monkeypatch.setenv(obs.METRICS_PORT_ENV, "0")
    srv2 = obs.MetricsServer(addr="127.0.0.1", registry=r).start()
    assert srv2.port
    srv2.stop()


# ---------------------------------------------------------------------------
# the lint over the port's sources
# ---------------------------------------------------------------------------
@pytest.fixture
def lint(monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from graftlint import metric_names
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(metric_names, "SCAN", ["paddle_tpu_torch"])
    return metric_names


def test_metric_name_and_label_lint_over_the_port(lint):
    """Rules 1-5 (names, suffixes, units, one kind a name) and rule 7
    (label cardinality) hold at every registration and ``.labels`` site of
    the port; of the contract names, only those of features the port does
    not have are missing."""
    regs = lint.find_registrations()
    assert {rel.split(os.sep)[0] for rel, _l, _k, _n in regs} \
        == {"paddle_tpu_torch"}
    errors = lint.lint(regs)
    site_errors = [e for e in errors if not e.startswith("<scan>")]
    assert site_errors == []
    assert lint.lint_label_sites(lint.find_label_sites()) == []
    # (the package-coverage rule names the reference's directory: a name
    # the port registers is reported there as outside it, not missing)
    missing = {re.search(r"'([a-z0-9_]+)'", e).group(1)
               for e in errors if "registered nowhere" in e}
    names = {n for _r, _l, _k, n in regs}
    assert not missing & names
    unported = re.compile(
        r"fsdp|redistribute|_cp_|_ep_|moe|spmd|quant_collective|"
        r"tp_collective")
    assert all(unported.search(n) for n in missing), sorted(missing)
    assert "serving_page_migrations_total" in names
    assert "router_role_dispatch_total" in names
    for family in ("router_capacity_recommendation", "serving_step_mfu",
                   "serving_hbm_bytes_per_token", "train_mfu_ratio",
                   "router_rpc_requests_total",
                   "fleet_engine_process_restarts_total",
                   "elastic_actions_total"):
        assert family in names, family


def _families(path):
    pat = re.compile(r"\b(counter|gauge|histogram)\(\s*[\"']"
                     r"([A-Za-z0-9_.\-]+)[\"']")
    with open(os.path.join(REPO, path)) as f:
        return {(k, n) for k, n in pat.findall(f.read())}


def test_engine_metric_families_are_the_references():
    """The port engine registers the reference engine's metric families,
    each with its kind, minus ``UNPORTED_FAMILIES``."""
    ref = _families("paddle_tpu/inference/serving.py")
    port = _families("paddle_tpu_torch/inference/serving.py")
    assert {n for _k, n in ref} >= UNPORTED_FAMILIES
    assert port == {(k, n) for k, n in ref if n not in UNPORTED_FAMILIES}
    assert _families("paddle_tpu_torch/inference/router.py") \
        == _families("paddle_tpu/inference/router.py")


def test_serving_engine_metric_families_move():
    """The port engine populates its families in the port's registry (the
    reference's slow ``test_serving_engine_metric_families`` on the mixed
    engine): queue, occupancy, page use, TTFT/TPOT, decode and prefill
    histograms once warm, tokens, and the truncated-victim counter under
    lazy_alloc pool exhaustion."""
    r = port_obs.default_registry()
    _ref, model = _pair(**TINY)
    eng = ContinuousBatchingEngine(model, max_batch_size=2, num_blocks=16,
                                   block_size=4, mixed_step=True,
                                   prefill_chunk_size=4, device="cpu")
    tokens0 = r.get("serving_tokens_total").value
    ttft0 = r.get("serving_ttft_seconds").count
    dec0 = r.get("serving_decode_step_duration_seconds").count
    eng.add_request(np.array([3, 14, 15], np.int64), max_new_tokens=4)
    assert r.get("serving_queue_depth").value == 1
    eng.add_request(np.array([1, 2], np.int64), max_new_tokens=4)
    eng.step()
    assert r.get("serving_slot_occupancy_ratio").value == 1.0
    assert r.get("serving_kv_page_utilization_ratio").value > 0
    eng.run_to_completion()
    assert r.get("serving_decode_step_duration_seconds").count > dec0
    assert r.get("serving_ttft_seconds").count == ttft0 + 2
    assert r.get("serving_tokens_total").value == tokens0 + 8
    assert r.get("serving_queue_depth").value == 0
    assert eng.counters["tokens_generated"] == 8
    trunc0 = r.get("serving_truncated_victims_total").value
    eng2 = ContinuousBatchingEngine(model, max_batch_size=2, num_blocks=4,
                                    block_size=4, max_seq_len=32,
                                    lazy_alloc=True, mixed_step=True,
                                    prefill_chunk_size=4, device="cpu",
                                    tracer=False)
    assert eng2.tracer is port_obs.NULL_TRACER
    eng2.add_request(np.arange(1, 8, dtype=np.int64), max_new_tokens=24)
    eng2.add_request(np.arange(1, 8, dtype=np.int64), max_new_tokens=24)
    eng2.run_to_completion()
    assert r.get("serving_truncated_victims_total").value > trunc0
    assert eng2.tracer.events(0) == []
    # the capacity plane's efficiency probe: nothing until asked for
    assert eng.efficiency_stats() is None
    assert "efficiency" not in eng.health_payload()
