"""The port's ground rules: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of ``paddle_tpu``; entry points run on
the card unless asked for the CPU; the kernel wrappers take their plain
versions for CPU tensors without counting a launch; options this slice
does not port raise ``NotImplementedError``."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (the reference; the port must not need it)

import paddle_tpu_torch
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.layerwise import LlamaLayerwiseTrainStep
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny_config,
                                           llama_truncated_draft)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.kernels import rope_qkv_epilogue
from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                  ragged_paged_attention)
from paddle_tpu_torch.ops.rms_norm import rms_norm_tpu
from paddle_tpu_torch.optimizer import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(paddle_tpu_torch.__file__)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "paddle_tpu" or module.startswith("paddle_tpu."))


def test_ast_scan_finds_no_jax_or_reference_import():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += ["%s:%d %s" % (os.path.relpath(path, ROOT), node.lineno,
                                  n) for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(_port_sources()) > 10
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ("ops/flash_attention.py", "optimizer/optimizer.py",
                   "jit/train_step.py", "models/llama.py",
                   "nn/functional.py", "quantization/functional.py",
                   "ops/online_softmax.py", "jit/serving_step.py",
                   "jit/layerwise.py", "ops/rms_norm.py"):
        assert os.path.join("paddle_tpu_torch", module) in scanned


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port and
    chip_smoke (without running it): no jax, no paddle_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
        "'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'paddle_tpu_torch.inference.serving' in sys.modules\n"
        "assert 'paddle_tpu_torch.jit.train_step' in sys.modules\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def _tiny(device="cpu", layers=1):
    cfg = llama_tiny_config(num_hidden_layers=layers, hidden_size=32,
                            num_attention_heads=2, num_key_value_heads=1,
                            vocab_size=64, intermediate_size=64)
    return LlamaForCausalLM(cfg, device=device,
                            generator=torch.Generator().manual_seed(0))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(_tiny(), max_batch_size=2, num_blocks=8,
                                 block_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaLayerwiseTrainStep(_tiny().config)
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle_tpu_torch.resolve_device(None)
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")


LAUNCH_COUNTERS = ((rope_qkv_epilogue, "launches"),
                   (rope_qkv_epilogue, "amax_launches"),
                   (ragged_paged_attention, "launches"),
                   (ragged_paged_attention, "int8_launches"),
                   (paged_attention, "launches"),
                   (paged_attention, "int8_launches"))


@pytest.mark.parametrize("mode", [
    dict(), dict(prefill_buckets="auto", kv_dtype="int8"),
    dict(mixed_step=True), dict(mixed_step=True, kv_dtype="int8"),
    dict(mixed_step=True, sampling=True),
    dict(prefill_buckets="auto", sampling=True),
    dict(mixed_step=True, draft=True),
    dict(mixed_step=True, sampling=True, draft=True)],
    ids=["split", "split_int8", "mixed", "mixed_int8", "mixed_sampled",
         "split_sampled", "spec", "spec_sampled"])
def test_launch_counters_stay_zero_on_cpu(mode):
    """The whole CPU engine path goes through the wrappers and never
    launches a kernel (card tests in the same process may have counted
    launches before, so the counts must only stay where they were):
    greedy, sampled and speculative (the draft's launches too)."""
    before = [getattr(f, a) for f, a in LAUNCH_COUNTERS]
    mode = dict(mode)
    model = _tiny(layers=2 if mode.get("draft") else 1)
    if mode.pop("draft", False):
        mode["draft_model"] = llama_truncated_draft(model, 1)
    eng = ContinuousBatchingEngine(model, max_batch_size=2, num_blocks=8,
                                   block_size=4, prefill_chunk_size=4,
                                   device="cpu", **mode)
    knobs = (dict(temperature=0.8, top_k=5, top_p=0.9, seed=1)
             if mode.get("sampling") else {})
    eng.add_request(np.arange(1, 7), 3, **knobs)
    eng.run_to_completion()
    assert eng.finished[0].output_ids
    assert [getattr(f, a) for f, a in LAUNCH_COUNTERS] == before


UNPORTED_ENGINE = {
    "enable_prefix_cache": dict(enable_prefix_cache=True),
    "mesh": dict(mesh=object()),
    "sharding": dict(sharding=object()),
    "kv_dtype=bfloat16 under fp32": dict(kv_dtype="bfloat16"),
    "weight_quant": dict(weight_quant="int8"),
    "quant_collectives": dict(quant_collectives=True),
    "tracer": dict(tracer=True),
    "role": dict(role="prefill"),
    "host_tier_bytes": dict(host_tier_bytes=1 << 20),
    "token_budgets": dict(token_budgets=(4, 8)),
}


@pytest.mark.parametrize("option", sorted(UNPORTED_ENGINE))
def test_unported_engine_options_raise(option):
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousBatchingEngine(_tiny(), max_batch_size=2, num_blocks=8,
                                 block_size=4, device="cpu",
                                 **UNPORTED_ENGINE[option])


@pytest.mark.parametrize("knobs", [dict(n=2)], ids=["n"])
def test_unported_request_options_raise(knobs):
    eng = ContinuousBatchingEngine(_tiny(), max_batch_size=2, num_blocks=8,
                                   block_size=4, device="cpu",
                                   sampling=True, mixed_step=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.add_request(np.arange(1, 4), 2, **knobs)
    assert not eng.waiting


FLASH_COUNTERS = (fa.flash_fwd, fa.flash_bwd_fused, fa.flash_bwd_two_kernel)


def test_training_path_on_cpu_launches_no_flash_kernel():
    """A TrainStep on the CPU runs the flash forward and backward through
    their plain versions and counts no launch (counts are compared with
    their values before, as above)."""
    before = [f.launches for f in FLASH_COUNTERS]
    model = _tiny()
    step = TrainStep(model, LlamaPretrainingCriterion(),
                     AdamW(1e-3, parameters=model.named_parameters()),
                     clip_norm=1.0)
    ids = torch.from_numpy(np.arange(1, 17).reshape(2, 8) % 64)
    loss = step(ids, ids)
    assert torch.isfinite(loss) and step.global_step == 1
    q = torch.randn(1, 64, 2, 64, requires_grad=True)
    out = fa.flash_attention_rope(q, q, q)
    out.sum().backward()
    fa.flash_bwd_two_kernel(*(t.detach() for t in (q, q, q)),
                            *fa.flash_fwd(q.detach(), q.detach(),
                                          q.detach(), True),
                            torch.ones_like(out), True)
    assert [f.launches for f in FLASH_COUNTERS] == before


@pytest.mark.parametrize("option", ["mesh", "sharding"])
def test_unported_train_step_options_raise(option):
    model = _tiny()
    opt = AdamW(1e-3, parameters=model.named_parameters())
    with pytest.raises(NotImplementedError, match="not ported"):
        TrainStep(model, LlamaPretrainingCriterion(), opt,
                  **{option: object()})


def test_layerwise_path_on_cpu_launches_no_kernel():
    """A layerwise step on the CPU runs the flash kernels' and RMSNorm's
    plain versions and counts no launch."""
    counters = FLASH_COUNTERS + (rms_norm_tpu,)
    before = [f.launches for f in counters]
    step = LlamaLayerwiseTrainStep(_tiny().config, device="cpu").init(0)
    ids = torch.from_numpy(np.arange(1, 17).reshape(2, 8) % 64)
    assert torch.isfinite(step(ids, ids))
    assert [f.launches for f in counters] == before


CUDA_SOURCES = ("flash_attention", "flash_attention_sm90",
                "paged_decode_attention", "ragged_paged_attention", "rms_norm",
                "rope_qkv")


def test_cuda_source_list_is_complete():
    from paddle_tpu_torch import _build
    assert tuple(_build.kernel_names()) == tuple(sorted(CUDA_SOURCES))


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_cuda_source_states_what_it_replaces_and_its_bound(name):
    """Each kernel source names the TPU kernel it replaces (a function of
    ``paddle_tpu``), states what bounds it on the card, includes no
    PyTorch header (the plain C interface that builds in seconds), and
    exports only entries that a module of the port binds."""
    with open(os.path.join(PKG, "csrc", name + ".cu")) as f:
        text = f.read()
    head = text[:text.index("#include")]
    assert "Replaces" in head and "paddle_tpu/ops/" in head
    assert "Bound on the card" in head
    includes = [line for line in text.splitlines()
                if line.startswith("#include")]
    assert not any("torch" in line or "ATen" in line for line in includes)
    entries = [line.split("(")[0].split()[-1]
               for line in text.splitlines()
               if line.startswith('extern "C"')]
    assert entries
    bound = ""
    for path in _port_sources():
        with open(path) as f:
            bound += f.read()
    for entry in entries:
        assert entry in bound, entry
