"""paddle_tpu_torch.observability — the serving plane's metrics, request
tracing and exporters (copies of ``paddle_tpu/observability``'s host-only
modules; the registry is the port's own).

Every ported subsystem records into :func:`default_registry`:

========================  =================================================
subsystem                 metric families
========================  =================================================
ContinuousBatchingEngine  serving_queue_depth, serving_slot_occupancy_ratio,
                          serving_kv_page_utilization_ratio,
                          serving_prefill_duration_seconds,
                          serving_decode_step_duration_seconds,
                          serving_ttft_seconds, serving_tpot_seconds,
                          serving_requests_total, serving_tokens_total,
                          serving_truncated_victims_total, the prefix
                          cache, host tier, page migration, mixed step,
                          quantization, sampling and speculative families
ServingRouter             router_requests_total, router_pending_depth,
                          router_prefix_route_hits_total,
                          router_requeues_total, router_engine_healthy,
                          router_slo_attained_total,
                          router_latency_quantile_seconds,
                          router_role_dispatch_total,
                          router_engine_pool_size
RequestTracer             request_trace_spans_total,
                          request_trace_dropped_spans_total
FleetCapacityMonitor      router_capacity_recommendation,
                          router_capacity_transitions_total,
                          router_capacity_saturation_ratio,
                          router_capacity_headroom_ratio,
                          router_capacity_tokens_per_second,
                          serving_step_mfu, serving_hbm_bytes_per_token,
                          serving_model_flops_per_token
RemoteEngineClient        router_rpc_requests_total,
                          router_rpc_retries_total,
                          router_rpc_latency_seconds,
                          fleet_engine_process_restarts_total
ElasticController         elastic_actions_total,
                          elastic_drained_requests_total,
                          elastic_warmup_restored_pages_total
StepTelemetry             train_steps_total, train_step_duration_seconds,
                          train_examples_per_second,
                          train_tokens_per_second, train_mfu_ratio,
                          train_loss, train_nonfinite_loss_total,
                          train_step_flops, hbm_in_use_bytes,
                          hbm_peak_bytes
========================  =================================================
"""
from .metrics import (MetricsRegistry, Counter, Gauge, Histogram,
                      MetricError, DEFAULT_BUCKETS, default_registry,
                      counter, gauge, histogram)
from .exporters import (generate_latest, json_snapshot, dump_json,
                        MetricsServer, start_metrics_server,
                        METRICS_PORT_ENV, set_health_provider,
                        healthz_payload)
from .telemetry import (StepTelemetry, device_peak_flops,
                        PEAK_FLOPS_BY_KIND, CHECK_NAN_ENV,
                        PEAK_FLOPS_ENV)
from .trace_merge import (SpanLog, span_log, record_span, record_instant,
                          merge_chrome_trace, load_device_trace_events)
from .request_trace import (RequestTracer, NullRequestTracer,
                            NULL_TRACER, resolve_tracer,
                            LatencyReservoir, validate_span_chain,
                            fleet_trace)
from .capacity import (SignalWindow, EngineCapacityMonitor,
                       CapacityConfig, CapacityPlanner,
                       FleetCapacityMonitor, resolve_capacity_monitor,
                       CAPACITY_ACTIONS)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "MetricError",
    "DEFAULT_BUCKETS", "default_registry", "counter", "gauge",
    "histogram",
    "generate_latest", "json_snapshot", "dump_json", "MetricsServer",
    "start_metrics_server", "METRICS_PORT_ENV",
    "set_health_provider", "healthz_payload",
    "StepTelemetry", "device_peak_flops", "PEAK_FLOPS_BY_KIND",
    "CHECK_NAN_ENV", "PEAK_FLOPS_ENV",
    "SpanLog", "span_log", "record_span", "record_instant",
    "merge_chrome_trace", "load_device_trace_events",
    "RequestTracer", "NullRequestTracer", "NULL_TRACER",
    "resolve_tracer", "LatencyReservoir", "validate_span_chain",
    "fleet_trace",
    "SignalWindow", "EngineCapacityMonitor", "CapacityConfig",
    "CapacityPlanner", "FleetCapacityMonitor",
    "resolve_capacity_monitor", "CAPACITY_ACTIONS",
]
