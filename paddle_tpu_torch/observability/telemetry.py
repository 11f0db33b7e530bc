"""Per-step training telemetry: wall time, throughput, MFU, device memory,
and a NaN/Inf loss sentinel (a copy of
``paddle_tpu/observability/telemetry.py`` for the port).

MFU = achieved FLOP/s over the card's peak.  The reference takes the
FLOPs numerator from its compiled step's ``cost_analysis()``; the port
compiles nothing, so the caller states the FLOPs of one step
(:meth:`StepTelemetry.set_flops_per_step`, e.g. an analytic count).  The
peak is :func:`device_peak_flops`: the ``PADDLE_TPU_PEAK_FLOPS``
override, else the dense bf16 rate of the CUDA card by its name
(``torch.cuda.get_device_name``), else None (the CPU, an unknown card:
MFU then reads 0, never a made-up number).  Device memory comes from
``torch.cuda.memory_allocated`` / ``max_memory_allocated``, sampled every
``hbm_sample_interval`` steps.

The NaN/Inf sentinel is the reference's ``FLAGS_check_nan_inf``
equivalent: opt in with env ``PADDLE_TPU_CHECK_NAN_INF=1`` (or
``check_nan_inf=True``) and a non-finite loss raises
``FloatingPointError`` after bumping ``train_nonfinite_loss_total`` —
fail the job at the poisoned step instead of training garbage for hours.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional

from .metrics import MetricsRegistry, default_registry
from .trace_merge import span_log

__all__ = ["StepTelemetry", "device_peak_flops", "PEAK_FLOPS_BY_KIND",
           "CHECK_NAN_ENV", "PEAK_FLOPS_ENV"]

CHECK_NAN_ENV = "PADDLE_TPU_CHECK_NAN_INF"
PEAK_FLOPS_ENV = "PADDLE_TPU_PEAK_FLOPS"

# dense bf16 tensor-core peak FLOP/s per card, by the prefix of
# ``torch.cuda.get_device_name`` (NVIDIA's data sheets, without
# sparsity) — the MFU denominator.  Longest prefix first: "NVIDIA H100
# PCIe" must not match the SXM row ("NVIDIA H100 80GB HBM3").
PEAK_FLOPS_BY_KIND = {
    "NVIDIA H100": 989e12,          # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA A100": 312e12,
}


def device_peak_flops(device=None) -> Optional[float]:
    """Per-card peak FLOP/s: the ``PADDLE_TPU_PEAK_FLOPS`` env override
    if set, else the device-name table; None on the CPU or for a card
    the table does not name — MFU is then reported as 0 rather than a
    made-up number."""
    env = os.environ.get(PEAK_FLOPS_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(device) or ""
    for name in sorted(PEAK_FLOPS_BY_KIND, key=len, reverse=True):
        if kind.startswith(name):
            return PEAK_FLOPS_BY_KIND[name]
    return None


def _truthy_env(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


class StepTelemetry:
    """Records one training step's telemetry into the metrics registry.

    Usage::

        tel = StepTelemetry()
        tel.set_flops_per_step(flops)                # once
        ...
        t0 = time.perf_counter()
        loss = step(*batch); loss_val = float(loss)  # host fetch
        tel.on_step(time.perf_counter() - t0, loss=loss_val,
                    examples=bs, tokens=bs * seq)
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 peak_flops: Optional[float] = None,
                 check_nan_inf: Optional[bool] = None,
                 hbm_sample_interval: int = 10,
                 span_markers: bool = True):
        r = registry or default_registry()
        self.registry = r
        self._steps = r.counter(
            "train_steps_total", "optimizer steps applied")
        self._duration = r.histogram(
            "train_step_duration_seconds",
            "wall time per fused train step (dispatch -> loss fetch)")
        self._examples_rate = r.gauge(
            "train_examples_per_second", "examples/s over the last step")
        self._tokens_rate = r.gauge(
            "train_tokens_per_second", "tokens/s over the last step")
        self._mfu = r.gauge(
            "train_mfu_ratio",
            "achieved FLOP/s over peak; FLOPs per step as the caller "
            "states them (0 when peak or FLOPs are unknown)")
        self._loss = r.gauge("train_loss", "last step's loss")
        self._nonfinite = r.counter(
            "train_nonfinite_loss_total",
            "steps whose loss came back NaN/Inf "
            "(PADDLE_TPU_CHECK_NAN_INF sentinel)")
        self._flops_gauge = r.gauge(
            "train_step_flops",
            "FLOPs per train step, as the caller states them")
        self._hbm_in_use = r.gauge(
            "hbm_in_use_bytes", "live device memory at last sample")
        self._hbm_peak = r.gauge(
            "hbm_peak_bytes", "peak device memory at last sample")

        self.flops_per_step: Optional[float] = None
        self.peak_flops = peak_flops if peak_flops is not None \
            else device_peak_flops()
        self.check_nan_inf = _truthy_env(CHECK_NAN_ENV) \
            if check_nan_inf is None else bool(check_nan_inf)
        self.hbm_sample_interval = max(1, int(hbm_sample_interval))
        self.span_markers = bool(span_markers)
        self._n = 0

    # -- FLOPs / device memory ---------------------------------------------
    def set_flops_per_step(self, flops: Optional[float]):
        if flops:
            self.flops_per_step = float(flops)
            self._flops_gauge.set(float(flops))

    def sample_hbm(self):
        """Record the live and peak device-memory gauges now (CUDA
        allocator statistics; nothing on a machine without a card)."""
        import torch
        if torch.cuda.is_available():
            self._hbm_in_use.set(float(torch.cuda.memory_allocated()))
            self._hbm_peak.set(float(torch.cuda.max_memory_allocated()))

    # -- per-step record ------------------------------------------------------
    def on_step(self, duration_s: float, loss: Optional[float] = None,
                examples: Optional[int] = None,
                tokens: Optional[int] = None,
                step_index: Optional[int] = None,
                warmup: bool = False):
        """Record one completed step; ``duration_s`` must span dispatch
        through the loss host-fetch (the real device barrier: CUDA
        launches return before the card finishes).  Raises
        ``FloatingPointError`` on a non-finite loss when the NaN/Inf
        sentinel is enabled.

        ``warmup=True`` marks a step whose wall time includes one-off
        work (the kernels' first load, the allocator's growth): it is
        counted and loss-checked, but excluded from the duration
        histogram and the rate/MFU gauges so it doesn't skew the
        steady-state statistics forever."""
        self._n += 1
        dt = max(float(duration_s), 1e-9)
        self._steps.inc()
        if not warmup:
            self._duration.observe(dt)
            if examples:
                self._examples_rate.set(examples / dt)
            if tokens:
                self._tokens_rate.set(tokens / dt)
        if not warmup and self.flops_per_step and self.peak_flops:
            # FLOPs per step are one card's work, over one card's peak
            self._mfu.set(self.flops_per_step / dt / self.peak_flops)
        if loss is not None:
            self._loss.set(float(loss))
            if not math.isfinite(float(loss)):
                self._nonfinite.inc()
                if self.check_nan_inf:
                    raise FloatingPointError(
                        f"non-finite loss {loss!r} at telemetry step "
                        f"{self._n} ({CHECK_NAN_ENV} sentinel); "
                        f"checkpoint + restart from the last finite "
                        f"state")
        if self._n % self.hbm_sample_interval == 0:
            self.sample_hbm()
        if self.span_markers:
            now = time.perf_counter()
            span_log.record("train_step", now - dt, now, cat="train",
                            step=int(step_index if step_index is not None
                                     else self._n))
