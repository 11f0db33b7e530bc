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
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.ops.kernels import rope_qkv_epilogue
from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention

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
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def _tiny(device="cpu"):
    cfg = llama_tiny_config(num_hidden_layers=1, hidden_size=32,
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
        paddle_tpu_torch.resolve_device(None)
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_launch_counters_stay_zero_on_cpu():
    """The whole CPU engine path goes through both wrappers and never
    launches a kernel (card tests in the same process may have counted
    launches before, so the counts must only stay where they were)."""
    before = (rope_qkv_epilogue.launches, ragged_paged_attention.launches)
    eng = ContinuousBatchingEngine(_tiny(), max_batch_size=2, num_blocks=8,
                                   block_size=4, prefill_chunk_size=4,
                                   device="cpu")
    eng.add_request(np.arange(1, 7), 3)
    eng.run_to_completion()
    assert eng.finished[0].output_ids
    assert (rope_qkv_epilogue.launches,
            ragged_paged_attention.launches) == before


UNPORTED_ENGINE = {
    "mixed_step=False": dict(mixed_step=False),
    "lazy_alloc": dict(lazy_alloc=True),
    "prefill_buckets": dict(prefill_buckets="auto"),
    "enable_prefix_cache": dict(enable_prefix_cache=True),
    "mesh": dict(mesh=object()),
    "sharding": dict(sharding=object()),
    "kv_dtype=int8": dict(kv_dtype="int8"),
    "kv_dtype=bfloat16 under fp32": dict(kv_dtype="bfloat16"),
    "weight_quant": dict(weight_quant="int8"),
    "quant_collectives": dict(quant_collectives=True),
    "sampling": dict(sampling=True),
    "draft_model": dict(draft_model=object()),
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


@pytest.mark.parametrize("knobs", [dict(temperature=0.7), dict(top_k=5),
                                   dict(top_p=0.9), dict(seed=3),
                                   dict(n=2)],
                         ids=["temperature", "top_k", "top_p", "seed", "n"])
def test_unported_request_options_raise(knobs):
    eng = ContinuousBatchingEngine(_tiny(), max_batch_size=2, num_blocks=8,
                                   block_size=4, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.add_request(np.arange(1, 4), 2, **knobs)
    assert not eng.waiting
