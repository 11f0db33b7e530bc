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
  ``inference.elastic`` (scaling the pool on the capacity plan);
- the model families beside Llama — ``models.mixtral`` (sparse top-k
  MoE over ``ops.moe_gate``; served in both engines, with int8 pools and
  int8 weights, its expert banks included, and trained through
  ``TrainStep``) and ``models.qwen`` (Qwen2: GQA with q/k/v biases) —
  over the same kernels;
- the paddle API, part 1 — ``import paddle_tpu_torch as paddle`` gives
  the reference's top-level names: the eager ``Tensor`` on
  ``torch.autograd`` (``core``, ``autograd``), the op families
  (``ops``), ``amp``, the ``nn`` core (``nn.Layer``, the layers over
  ``nn.functional``, whose attention runs the flash kernels) and
  ``models.gpt``.  The names are built at first use (this module's
  ``__getattr__``), so importing the engines does not build the op
  table.
"""
import importlib as _importlib

from .core.device import resolve_device  # noqa: F401

__version__ = "0.1.0"

# the API's subpackages, imported at first use
_SUBMODULES = ("nn", "amp", "autograd", "optimizer", "models", "ops",
               "core", "distributed", "inference", "io", "jit",
               "observability", "quantization", "testing")

# the subpackages that do not need the op table
_ENGINE_PACKAGES = ("distributed", "inference", "jit", "observability",
                    "quantization", "testing", "ops", "core", "optimizer")

# top-level names and the modules that hold them
_NAMES = {
    "core.dtypes": ("bfloat16", "float16", "float32", "float64", "int8",
                    "int16", "int32", "int64", "uint8", "uint16", "uint32",
                    "uint64", "bool_", "complex64", "complex128",
                    "float8_e4m3fn", "float8_e5m2", "get_default_dtype",
                    "set_default_dtype"),
    "core.tensor": ("Tensor", "to_tensor", "set_printoptions"),
    "core.flags": ("get_flags", "set_flags"),
    "core.device": ("CPUPlace", "CUDAPlace", "TPUPlace", "CustomPlace",
                    "set_device", "get_device", "device_count",
                    "is_compiled_with_tpu", "is_compiled_with_cuda",
                    "synchronize"),
    "ops.random": ("seed", "get_rng_state", "set_rng_state",
                   "default_generator", "Generator"),
    "autograd": ("no_grad", "enable_grad", "grad", "set_grad_enabled",
                 "is_grad_enabled"),
    "framework_io": ("save", "load"),
}
_ALIASES = {"bool": ("core.dtypes", "bool_"),
            "CUDAPinnedPlace": ("core.device", "CPUPlace"),
            "get_cuda_rng_state": ("ops.random", "get_rng_state"),
            "set_cuda_rng_state": ("ops.random", "set_rng_state")}


def _attr(mod, name):
    return getattr(_importlib.import_module("." + mod, __name__), name)


def __getattr__(name):
    """The paddle API's top-level names, loaded at first use."""
    if name.startswith("_"):
        raise AttributeError(name)
    if name not in _ENGINE_PACKAGES:
        # an API name: the Tensor gets its methods and operators here
        _importlib.import_module(".ops._table", __name__)
    if name in _SUBMODULES:
        value = _importlib.import_module("." + name, __name__)
    elif name in _ALIASES:
        value = _attr(*_ALIASES[name])
    else:
        mod = next((m for m, names in _NAMES.items() if name in names), None)
        if mod is not None:
            value = _attr(mod, name)
        else:
            ns = _importlib.import_module(".ops._table",
                                          __name__).ops_namespace()
            if name not in ns:
                _api_misc = _importlib.import_module("._api_misc", __name__)
                if not hasattr(_api_misc, name):
                    raise AttributeError("module %r has no attribute %r"
                                         % (__name__, name))
                value = getattr(_api_misc, name)
            else:
                value = ns[name]
    globals()[name] = value
    return value


__all__ = ["resolve_device"]
