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
from paddle_tpu_torch.distributed.process_mesh import ProcessMesh
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.spmd import ShardingConfig
from paddle_tpu_torch.jit.layerwise import LlamaLayerwiseTrainStep
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.ops.dequant import dequant_int8
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
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

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
                   "models/mixtral.py", "models/qwen.py", "ops/moe_gate.py",
                   "models/_functional.py", "models/_layers.py",
                   "quantization/functional.py",
                   "ops/online_softmax.py", "jit/serving_step.py",
                   "jit/layerwise.py", "ops/rms_norm.py",
                   "inference/prefix_cache.py", "inference/router.py",
                   "inference/fleet.py", "ops/dequant.py",
                   "inference/engine_server.py", "inference/elastic.py",
                   "testing/faults.py",
                   "observability/__init__.py", "observability/metrics.py",
                   "observability/exporters.py",
                   "observability/request_trace.py",
                   "observability/trace_merge.py",
                   "observability/capacity.py",
                   "observability/telemetry.py",
                   "distributed/process_mesh.py",
                   "distributed/collective.py", "distributed/launch.py",
                   "jit/spmd.py", "testing/sharded.py",
                   "distributed/topology.py", "ops/sequence_parallel.py",
                   "optimizer/lr.py", "optimizer/lbfgs.py",
                   "distributed/sharding/__init__.py",
                   "distributed/fleet/meta_parallel/sharding_api.py",
                   "distributed/fleet/meta_parallel/sharding.py") + API_MODULES:
        assert os.path.join("paddle_tpu_torch", module) in scanned


# the paddle API's modules, under the reference's names
API_MODULES = ("core/dtypes.py", "core/flags.py", "core/device.py",
               "core/tensor.py", "core/dispatch.py", "autograd/__init__.py",
               "autograd/tape.py", "autograd/py_layer.py",
               "ops/registry.py", "ops/_helpers.py", "ops/_table.py",
               "ops/inplace.py", "ops/math.py", "ops/creation.py",
               "ops/reduction.py", "ops/logic.py", "ops/manipulation.py",
               "ops/random.py", "ops/linalg.py", "amp/__init__.py",
               "amp/amp_lists.py", "nn/__init__.py", "nn/layer_base.py",
               "nn/initializer.py", "nn/layers.py", "nn/transformer.py",
               "nn/clip.py", "nn/functional/__init__.py",
               "nn/functional/activation.py", "nn/functional/common.py",
               "nn/functional/norm.py", "nn/functional/loss.py",
               "models/gpt.py", "framework_io.py",
               "nn/functional/conv.py", "nn/functional/pooling.py",
               "nn/functional/vision.py", "nn/functional/extended.py",
               "nn/rnn.py", "nn/decode.py", "nn/utils/__init__.py",
               "models/resnet.py", "io/__init__.py", "io/dataset.py",
               "io/sampler.py", "io/bucketing.py", "io/shm_ring.py",
               "io/worker.py", "io/dataloader.py", "amp/debugging.py")


# the one forked process of the port: the DataLoader's workers, which
# never use the card (io/worker.py imports no torch; the parent makes the
# tensors)
FORKED = (os.path.join("io", "dataloader.py"),)


def test_no_fork_start_method():
    """No rank or server process of the port is forked: a fork of a
    process that touched CUDA cannot use the card.  The sources name no
    ``fork`` start method and call no ``os.fork``, but for the
    DataLoader's workers (``FORKED``), whose module imports no torch; the
    rank launcher starts its ranks with ``subprocess``."""
    bad, forked = [], set()
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            hit = (isinstance(node, ast.Constant) and node.value in (
                "fork", "forkserver")) or (
                isinstance(node, ast.Attribute) and node.attr == "fork")
            if hit:
                rel = os.path.relpath(path, PKG)
                if rel in FORKED:
                    forked.add(rel)
                else:
                    bad.append("%s:%d" % (os.path.relpath(path, ROOT),
                                           node.lineno))
    assert not bad, bad
    assert forked == set(FORKED)
    with open(os.path.join(PKG, "distributed", "launch.py")) as f:
        assert "subprocess.Popen" in f.read()
    with open(os.path.join(PKG, "io", "worker.py")) as f:
        tree = ast.parse(f.read())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + [
        n.module or "" for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom)]
    assert not any(m.split(".")[0] == "torch" for m in imported), imported


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
        "assert 'paddle_tpu_torch.inference.router' in sys.modules\n"
        "assert 'paddle_tpu_torch.observability.request_trace' in "
        "sys.modules\n"
        "for m in ('inference.fleet', 'inference.engine_server', "
        "'inference.elastic', 'testing.faults', 'observability.capacity', "
        "'observability.telemetry', 'models.mixtral', 'models.qwen', "
        "'ops.moe_gate', 'distributed.process_mesh', "
        "'distributed.collective', 'distributed.launch', 'jit.spmd', "
        "'testing.sharded', 'distributed.topology', "
        "'ops.sequence_parallel', 'optimizer.lr', 'optimizer.lbfgs', "
        "'distributed.sharding', "
        "'distributed.fleet.meta_parallel.sharding_api'):\n"
        "    assert 'paddle_tpu_torch.' + m in sys.modules, m\n"
        "for m in %r:\n"
        "    m = 'paddle_tpu_torch.' + m[:-3].replace('/', '.')\n"
        "    m = m[:-len('.__init__')] if m.endswith('.__init__') else m\n"
        "    assert m in sys.modules, m\n"
        "print('clean')\n" % (API_MODULES,))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_engines_do_not_build_the_api_op_table():
    """Importing the port, its engines and its rank launcher builds no
    part of the paddle API (its names load at first use)."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.jit.train_step\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "import paddle_tpu_torch.models.llama\n"
        "bad = [m for m in ('paddle_tpu_torch.ops._table', "
        "'paddle_tpu_torch.nn.layer_base', 'paddle_tpu_torch.core.tensor') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "import paddle_tpu_torch as paddle\n"
        "assert paddle.matmul is not None and paddle.nn.Linear\n"
        "assert 'paddle_tpu_torch.ops._table' in sys.modules\n"
        "print('lazy')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "lazy"


def test_api_tensors_default_to_the_card():
    """With no ``set_device("cpu")`` (and no ``place=``) an API tensor is
    made on the card; where there is none that raises, as
    ``resolve_device`` does, and nothing lands on the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is valid here")
    from paddle_tpu_torch.core import device as dev
    old = dev._CURRENT_DEVICE[0]
    dev._CURRENT_DEVICE[0] = None
    try:
        assert paddle_tpu_torch.get_device() == "gpu:0"
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle_tpu_torch.to_tensor([1.0, 2.0])
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle_tpu_torch.zeros([2])
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle_tpu_torch.nn.Linear(2, 2)
        t = paddle_tpu_torch.to_tensor([1.0], place="cpu")
        assert t.place == paddle_tpu_torch.CPUPlace()
    finally:
        dev._CURRENT_DEVICE[0] = old


def test_api_attention_on_cpu_launches_no_kernel():
    """The API's attention on CPU tensors, by each route and through GPT,
    runs the flash kernels' plain versions and counts no launch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.device import device_guard
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    before = [f.launches for f in FLASH_COUNTERS]
    with device_guard("cpu"):
        q = paddle.to_tensor(np.random.RandomState(0).randn(
            1, 8, 2, 16).astype(np.float32), stop_gradient=False)
        F = paddle.nn.functional
        for kw in (dict(is_causal=True), dict(
                attn_mask=paddle.to_tensor(np.ones((8, 8), bool)))):
            F.scaled_dot_product_attention(q, q, q, **kw).sum().backward()
        model = GPTForCausalLM(GPTConfig(
            vocab_size=32, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=8))
        model(paddle.to_tensor(np.arange(8).reshape(1, 8))).sum().backward()
    assert [f.launches for f in FLASH_COUNTERS] == before


def test_api_functional_hides_no_kernel_error():
    """No ``try`` in the API's ``nn.functional`` (the reference's attention
    wraps its kernel in ``except Exception: pass``; the port's must let a
    kernel that fails to build or launch fail the call), and the
    attention's no-mask route calls the flash kernels' entry itself."""
    bad = []
    fdir = os.path.join(PKG, "nn", "functional")
    for name in sorted(os.listdir(fdir)):
        if not name.endswith(".py"):
            continue
        path = os.path.join(fdir, name)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Try, ast.ExceptHandler)):
                bad.append("%s:%d" % (name, node.lineno))
    assert not bad, bad
    with open(os.path.join(fdir, "common.py")) as f:
        src = f.read()
    route = src[src.index("def _flash_route"):src.index(
        "def scaled_dot_product_attention")]
    assert "_fa.flash_attention(q, k, v, is_causal)" in route
    assert "_fa._chunked_sdpa(q, k, v, is_causal, mask=m[0])" in route


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
                   (paged_attention, "int8_launches"),
                   (dequant_int8, "launches"))


@pytest.mark.parametrize("mode", [
    dict(), dict(prefill_buckets="auto", kv_dtype="int8"),
    dict(mixed_step=True), dict(mixed_step=True, kv_dtype="int8"),
    dict(mixed_step=True, sampling=True),
    dict(prefill_buckets="auto", sampling=True),
    dict(mixed_step=True, draft=True),
    dict(mixed_step=True, sampling=True, draft=True),
    dict(mixed_step=True, enable_prefix_cache=True, host_tier_bytes=1 << 20),
    dict(prefill_buckets="auto", enable_prefix_cache=True,
         kv_dtype="int8"),
    dict(mixed_step=True, weight_quant="int8"),
    dict(prefill_buckets="auto", weight_quant="int8", kv_dtype="int8"),
    dict(mixed_step=True, weight_quant="int8", draft=True)],
    ids=["split", "split_int8", "mixed", "mixed_int8", "mixed_sampled",
         "split_sampled", "spec", "spec_sampled", "mixed_prefix_host_tier",
         "split_prefix_int8", "mixed_w8", "split_w8_int8", "spec_w8"])
def test_launch_counters_stay_zero_on_cpu(mode):
    """The whole CPU engine path goes through the wrappers and never
    launches a kernel (card tests in the same process may have counted
    launches before, so the counts must only stay where they were):
    greedy, sampled and speculative (the draft's launches too), and with
    the prefix cache (a second request hits the first one's pages)."""
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
    if mode.get("enable_prefix_cache"):
        eng.add_request(np.arange(1, 10), 2, **knobs)
        eng.run_to_completion()
        assert eng.finished[1].prefix_hit_tokens == 4
    assert [getattr(f, a) for f, a in LAUNCH_COUNTERS] == before


# the engine options, or the forms of them, that are still not ported —
# a pool dtype other than the model's or int8 — raise NotImplementedError;
# the mesh forms ported since (a cp axis, an fsdp axis, quantized
# collectives over cp) refuse only a whole model: each rank serves its
# shard (jit.spmd.shard_model)
UNPORTED_ENGINE = {
    "mesh": (dict(mesh=ProcessMesh([2], ["cp"]), mixed_step=True),
             ValueError, "shard_model"),
    "sharding": (dict(mesh=ProcessMesh([2], ["fsdp"]),
                      sharding=ShardingConfig(axis="tp"), mixed_step=True),
                 ValueError, "shard_model"),
    "kv_dtype=bfloat16 under fp32": (dict(kv_dtype="bfloat16"),
                                     NotImplementedError, "not ported"),
    "quant_collectives": (dict(quant_collectives=True, mixed_step=True,
                               mesh=ProcessMesh([2], ["cp"])),
                          ValueError, "shard_model"),
}


@pytest.mark.parametrize("option", sorted(UNPORTED_ENGINE))
def test_unported_engine_options_raise(option):
    kw, error, match = UNPORTED_ENGINE[option]
    with pytest.raises(error, match=match):
        ContinuousBatchingEngine(_tiny(), max_batch_size=2, num_blocks=8,
                                 block_size=4, device="cpu", **kw)


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


# the sharded steps are ported (ZeRO-1/2 over dp, fsdp x tp); what they
# still refuse raises as the reference does: a mesh whose other axes are
# live besides the dp axis (no fsdp axis to take the 2-D path), and a
# sharding config without a mesh
UNPORTED_TRAIN = {
    "mesh": (dict(mesh=ProcessMesh([2, 2], ["dp", "mp"]),
                  sharding=ShardingConfig(stage=2)),
             NotImplementedError, "pure data parallelism"),
    "sharding": (dict(sharding=ShardingConfig(stage=2)), ValueError,
                 "requires a mesh"),
}


@pytest.mark.parametrize("option", sorted(UNPORTED_TRAIN))
def test_unported_train_step_options_raise(option):
    model = _tiny()
    opt = AdamW(1e-3, parameters=model.named_parameters())
    kw, error, match = UNPORTED_TRAIN[option]
    with pytest.raises(error, match=match):
        TrainStep(model, LlamaPretrainingCriterion(), opt, **kw)


def test_layerwise_path_on_cpu_launches_no_kernel():
    """A layerwise step on the CPU runs the flash kernels' and RMSNorm's
    plain versions and counts no launch."""
    counters = FLASH_COUNTERS + (rms_norm_tpu,)
    before = [f.launches for f in counters]
    step = LlamaLayerwiseTrainStep(_tiny().config, device="cpu").init(0)
    ids = torch.from_numpy(np.arange(1, 17).reshape(2, 8) % 64)
    assert torch.isfinite(step(ids, ids))
    assert [f.launches for f in counters] == before


# kernel source -> the reference file it names as what it replaces (the
# Pallas kernels' modules; the weight dequant replaces an XLA-fused
# expression, not a Pallas kernel)
CUDA_SOURCES = {"flash_attention": "paddle_tpu/ops/",
                "flash_attention_sm90": "paddle_tpu/ops/",
                "paged_decode_attention": "paddle_tpu/ops/",
                "ragged_paged_attention": "paddle_tpu/ops/",
                "rms_norm": "paddle_tpu/ops/", "rope_qkv": "paddle_tpu/ops/",
                "dequant_int8": "paddle_tpu/quantization/functional.py"}


def test_cuda_source_list_is_complete():
    from paddle_tpu_torch import _build
    assert tuple(_build.kernel_names()) == tuple(sorted(CUDA_SOURCES))


@pytest.mark.parametrize("name", sorted(CUDA_SOURCES))
def test_cuda_source_states_what_it_replaces_and_its_bound(name):
    """Each kernel source names what of ``paddle_tpu`` it replaces (a
    Pallas kernel, or for the weight dequant the XLA-fused expression),
    states what bounds it on the card, includes no PyTorch header (the
    plain C interface that builds in seconds), and exports only entries
    that a module of the port binds."""
    with open(os.path.join(PKG, "csrc", name + ".cu")) as f:
        text = f.read()
    head = text[:text.index("#include")]
    assert "Replaces" in head and CUDA_SOURCES[name] in head
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


def test_the_ring_source_is_the_ports_own_and_builds_with_the_host():
    """The DataLoader's ring builds from ``paddle_tpu_torch/io/_native``
    (the port's own copy; nothing of ``paddle_tpu`` is read) with the host
    compiler into the git-ignored ``build/`` tree."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.io import shm_ring
    assert shm_ring.SOURCE == os.path.join(PKG, "io", "_native",
                                           "ringbuf.cc")
    path = shm_ring.build()
    assert path.startswith(_build.BUILD_DIR) and os.path.exists(path)
    with open(shm_ring.SOURCE) as f:
        text = f.read()
    assert "paddle_tpu/" not in text.replace("paddle_tpu_torch/", "")
    with open(os.path.join(PKG, "io", "shm_ring.py")) as f:
        assert "_native_build" not in f.read()


def _caught(handler):
    """The names of the exceptions ``handler`` catches (``queue.Full`` ->
    ``Full``)."""
    t = handler.type
    elts = [] if t is None else list(t.elts) if isinstance(t, ast.Tuple) \
        else [t]
    return {getattr(n, "attr", getattr(n, "id", None)) for n in elts}


def _broad(handler):
    return handler.type is None or bool(
        _caught(handler) & {"Exception", "BaseException"})


def test_the_loader_swallows_no_worker_or_build_error():
    """No ``except`` of ``io/`` or of the build helper passes an error
    over: none is bare, none has a body of only ``pass``/``continue``
    unless it catches a control-flow exception (a full or empty queue,
    the end of an iterator, the ring's read timeout), and every broad one
    (``Exception``, ``BaseException``) hands the error on (raise, a call
    that sends it) or sets the worker's nonzero exit."""
    control = {"Full", "Empty", "StopIteration", "Timeout"}
    bad = []
    paths = [os.path.join(PKG, "io", n) for n in sorted(os.listdir(
        os.path.join(PKG, "io"))) if n.endswith(".py")]
    for path in paths + [os.path.join(PKG, "_build.py")]:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for h in (n for n in ast.walk(tree)
                  if isinstance(n, ast.ExceptHandler)):
            where = "%s:%d" % (os.path.relpath(path, ROOT), h.lineno)
            caught = _caught(h)
            trivial = all(isinstance(b, (ast.Pass, ast.Continue))
                          for b in h.body)
            if h.type is None or (trivial and not caught <= control):
                bad.append(where)
            if _broad(h):
                body = [n for b in h.body for n in ast.walk(b)]
                hands_on = any(isinstance(n, (ast.Raise, ast.Call))
                               for n in body) or any(
                    isinstance(n, ast.Assign) and any(
                        getattr(t, "id", "") == "code" for t in n.targets)
                    for n in body)
                if not hands_on:
                    bad.append(where + " (broad)")
    assert not bad, bad


def test_op_families_pass_with_the_tensor_checker_on():
    """``apply_op``'s debug hook is the single door: a group of each op
    family's reference cases passes with the tensor checker (warning
    mode) and the operator statistics on, and every op of the groups
    went through the hook."""
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.core.device import device_guard
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_api_ops as ops_tests
    from torch_api_parity import run_cases
    groups = ops_tests.GROUPS[::4]
    seen = []
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF))
    dbg.enable_operator_stats_collection()
    hook = dispatch._amp_debug_hook[0]
    dispatch._amp_debug_hook[0] = lambda name, outs: (seen.append(name),
                                                      hook(name, outs))
    try:
        with device_guard("cpu"):
            for group in groups:
                run_cases(group, ops_tests._check_case)
        stats = dbg.get_operator_stats()
    finally:
        dispatch._amp_debug_hook[0] = hook
        dbg.disable_tensor_checker()
        dbg.disable_operator_stats_collection()
    assert dispatch._amp_debug_hook[0] is None
    names = {c[1] for g in groups for c in g}
    seen_ops = {n.split("::")[0] for n in seen}
    assert set(stats) == seen_ops
    assert len(names & seen_ops) >= len(names) // 2, sorted(
        names - seen_ops)
