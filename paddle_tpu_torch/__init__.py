"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays in the repository as the reference;
this package re-implements its serving path on PyTorch and runs it on an
NVIDIA H100.  Every kernel the reference wrote in Pallas for the TPU is a
kernel written by hand here (CUDA C++ under ``csrc/``, built by
``_build.py`` with ``nvcc`` at first use).  Each kernel wrapper keeps the
plain PyTorch version beside it, which it uses only for CPU tensors.

This package imports ``torch``, never ``jax`` and nothing of
``paddle_tpu``.

Ported so far: the single-device, greedy, fp32/bf16-pool serving path —
``models.llama`` (the eager oracle), ``jit.serving_step.MixedStep`` (one
fused mixed prefill+decode step) and
``inference.serving.ContinuousBatchingEngine`` — with two kernels:
ragged paged attention and the fused RoPE + QKV epilogue.
"""
from .core.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
