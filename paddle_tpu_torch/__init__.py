"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays in the repository as the reference;
this package re-implements its serving and training paths on PyTorch and
runs them on an NVIDIA H100.  Every kernel the reference wrote in Pallas
for the TPU is a kernel written by hand here (CUDA C++ under ``csrc/``,
built by ``_build.py`` with ``nvcc`` at first use).  Each kernel wrapper
keeps the plain PyTorch version beside it, which it uses only for CPU
tensors.

This package imports ``torch``, never ``jax`` and nothing of
``paddle_tpu``.

Ported so far:

- single-device greedy serving — ``models.llama`` (its cache path is the
  eager oracle), ``inference.serving.ContinuousBatchingEngine`` with the
  reference's default split engine (``jit.serving_step.DecodeStep``,
  the bucketed ``PrefillStep`` or the dense prefill's
  ``prefill_scatter``) or the fused mixed step (``MixedStep``), lazy
  page allocation, and model-dtype or int8 KV pools
  (``quantization.functional``) — with three kernels: ragged paged
  attention and paged decode attention (each over fp32/bf16 or int8
  pools) and the fused RoPE + QKV epilogue;
- the single-device training path — ``jit.train_step.TrainStep`` over
  ``optimizer`` (Adam, AdamW), ``models.llama.LlamaPretrainingCriterion``
  and the model's cache-less path with recompute — with three kernels in
  ``ops.flash_attention``: the neox-rope flash forward and its one-pass
  and two-kernel backward;
- the layerwise training step — ``jit.layerwise.LlamaLayerwiseTrainStep``
  (the optimizer applied per layer inside the reverse sweep) with
  ``optimizer.Adafactor`` — over the flash kernels and the RMSNorm kernel
  of ``ops.rms_norm``;
- the serving plane over those engines — ``inference.router``
  (in-process routing, migration, disaggregation), ``inference.fleet``
  and ``inference.engine_server`` (engines in other processes over the
  reference's PTF1 wire protocol), ``observability`` (metrics, request
  tracing, the capacity plane, step telemetry) and
  ``inference.elastic`` (scaling the pool on the capacity plan).
"""
from .core.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
