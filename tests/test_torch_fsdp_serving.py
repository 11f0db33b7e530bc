"""2-D fsdp x tp, pure-fsdp and replica serving in the port against the
JAX reference, on the CPU.

The port's ranks run as one four-rank gloo world started once for this
module (``paddle_tpu_torch.distributed.launch.run_world`` over
``paddle_tpu_torch.testing.sharded.serve_cases``); each rank builds its
shard of the reference's weights, storing ``1/(fsdp·tp)`` of every weight
whose spec names fsdp, and gathers its tp compute shard back at each
dispatch.  The reference's engines run here, on the conftest's 8-device
CPU mesh.  The gates are the serving half of ``tests/test_spmd2d.py``:
``mesh_2d`` and ``cp_mesh`` shapes, names and errors, the spec tables with
fsdp (Llama, Qwen2, Mixtral), ``fsdp_gather_bytes`` (its 64-byte case),
the serving context's degrees (pure fsdp, a degenerate mesh), tokens
byte-identical to the reference's engines and to the one-rank twin
(fsdp2 x tp2 mixed and split, pure fsdp 4, dp2 x fsdp2, Qwen2 and Mixtral
at fsdp2 x tp2), each rank's stored shard the one-card model's slice, and
the counted gather bytes equal to the reference's.
"""
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch.distributed as dist

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.jit import spmd as ref_spmd
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_config
from paddle_tpu.models.mixtral import MixtralForCausalLM as RefMixtral
from paddle_tpu.models.mixtral import mixtral_tiny_config
from paddle_tpu.models.qwen import Qwen2ForCausalLM as RefQwen2
from paddle_tpu.models.qwen import qwen2_tiny_config
from paddle_tpu.observability import default_registry as ref_registry
from paddle_tpu.testing.dryrun import cpu_mesh_2d

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import spmd
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     MixtralConfig, MixtralForCausalLM,
                                     Qwen2Config, Qwen2ForCausalLM)
from paddle_tpu_torch.testing.parity import state_from_paddle_tpu
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

PROMPTS = [[7, 9, 2], [3, 14, 15, 92, 65], list(range(1, 11))]
BUDGET = 4
STAGGER = [["add", PROMPTS[0], BUDGET], ["step"],
           ["add", PROMPTS[1], BUDGET], ["add", PROMPTS[2], BUDGET],
           ["run"]]
MIXED = dict(max_batch_size=4, num_blocks=64, block_size=4,
             mixed_step=True, prefill_chunk_size=4)
SPLIT = dict(max_batch_size=4, num_blocks=64, block_size=4,
             prefill_buckets=(4, 8, 16))
W8 = dict(MIXED, weight_quant="int8")
GATHER = "spmd_allgather_bytes_total{serving_params}"
MESHES = {"f2t2": {"fsdp": 2, "tp": 2}, "f4": {"fsdp": 4, "tp": 1},
          "dp2f2": {"dp": 2, "fsdp": 2, "tp": 1}}


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _ref_llama():
    paddle.seed(0)
    model = RefLlama(ref_llama_config(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=128, intermediate_size=128))
    model.eval()
    return model


def _ref_family(cls, cfg_fn, **kw):
    paddle.seed(0)
    model = cls(cfg_fn(num_hidden_layers=2, **kw))
    model.eval()
    return model


def _ref_mesh(spec):
    return ref_spmd.mesh_2d(spec.get("fsdp", 1), spec.get("tp", 1),
                            replica=spec.get("dp", 1))


def _cfg_dict(ref, cls):
    return {f: getattr(ref.config, f) for f in cls.__dataclass_fields__
            if hasattr(ref.config, f)}


def _ref_serve(model, ops, **kw):
    eng = RefEngine(model, **kw)
    rids = []
    for op in ops:
        if op[0] == "add":
            rids.append(eng.add_request(np.asarray(op[1], np.int64), op[2]))
        elif op[0] == "step":
            eng.step()
        else:
            eng.run_to_completion()
    return eng, [eng.result(r) for r in rids]


def _ref_gather_bytes():
    c = ref_registry().get("spmd_allgather_bytes_total")
    return c.labels(site="serving_params").value if c else 0.0


@pytest.fixture(scope="module")
def refs():
    paddle.seed(0)
    tied = RefLlama(ref_llama_config(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=128, intermediate_size=128,
        tie_word_embeddings=True))
    tied.eval()
    return dict(
        llama=_ref_llama(), tied=tied,
        qwen2=_ref_family(RefQwen2, qwen2_tiny_config, hidden_size=64,
                          intermediate_size=128, vocab_size=128),
        mixtral=_ref_family(RefMixtral, mixtral_tiny_config,
                            vocab_size=128))


@pytest.fixture(scope="module")
def world(tmp_path_factory, refs):
    tmp = tmp_path_factory.mktemp("fsdp_world")
    models = {}
    for name, family, cls in (("m", "llama", LlamaConfig),
                              ("t", "llama", LlamaConfig),
                              ("q", "qwen2", Qwen2Config),
                              ("x", "mixtral", MixtralConfig)):
        ref = refs[{"m": "llama", "t": "tied", "q": "qwen2",
                    "x": "mixtral"}[name]]
        path = str(tmp / ("%s.npz" % name))
        np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
        models[name] = dict(family=family, config=_cfg_dict(ref, cls),
                            state=path)
    cases = [
        dict(name="one", model="m", mesh=None, engine=MIXED, ops=STAGGER),
        dict(name="one_split", model="m", mesh=None, engine=SPLIT,
             ops=STAGGER),
        dict(name="f2t2", model="m", mesh=MESHES["f2t2"], engine=MIXED,
             ops=STAGGER, return_params=True),
        dict(name="f2t2_split", model="m", mesh=MESHES["f2t2"],
             engine=SPLIT, ops=STAGGER),
        dict(name="f4", model="m", mesh=MESHES["f4"], engine=MIXED,
             ops=STAGGER, return_params=True),
        dict(name="dp2f2", model="m", mesh=MESHES["dp2f2"], engine=MIXED,
             ops=STAGGER, return_params=True),
        dict(name="q_f2t2", model="q", mesh=MESHES["f2t2"], engine=MIXED,
             ops=STAGGER),
        dict(name="x_f2t2", model="x", mesh=MESHES["f2t2"], engine=MIXED,
             ops=STAGGER),
        dict(name="f2t2_w8", model="m", mesh=MESHES["f2t2"], engine=W8,
             ops=STAGGER),
        dict(name="f4_w8", model="m", mesh=MESHES["f4"], engine=W8,
             ops=STAGGER),
        dict(name="one_w8", model="m", mesh=None, engine=W8, ops=STAGGER),
        dict(name="t_f2t2", model="t", mesh=MESHES["f2t2"], engine=MIXED,
             ops=STAGGER),
    ]
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                      "serve_cases", 4, dict(device="cpu", backend="gloo",
                                             models=models, cases=cases),
                      timeout=300, env={"OMP_NUM_THREADS": "1"})
    oracle = {}
    for name, ref, kw, mesh in (
            ("f2t2", refs["llama"], MIXED, "f2t2"),
            ("f2t2_split", refs["llama"], SPLIT, "f2t2"),
            ("f4", refs["llama"], MIXED, "f4"),
            ("dp2f2", refs["llama"], MIXED, "dp2f2"),
            ("q_f2t2", refs["qwen2"], MIXED, "f2t2"),
            ("x_f2t2", refs["mixtral"], MIXED, "f2t2"),
            ("f2t2_w8", refs["llama"], W8, "f2t2"),
            ("f4_w8", refs["llama"], W8, "f4"),
            ("t_f2t2", refs["tied"], MIXED, "f2t2")):
        b0 = _ref_gather_bytes()
        eng, toks = _ref_serve(ref, STAGGER, mesh=_ref_mesh(MESHES[mesh]),
                               **kw)
        oracle[name] = dict(tokens=toks, bytes=_ref_gather_bytes() - b0,
                            per_dispatch=eng._fsdp_gather_bytes)
    for name, ref, kw in (("t_one", refs["tied"], MIXED),
                          ("q_one", refs["qwen2"], MIXED),
                          ("x_one", refs["mixtral"], MIXED),
                          ("one_w8", refs["llama"], W8)):
        oracle[name] = dict(tokens=_ref_serve(ref, STAGGER, **kw)[1])
    out = {c["name"]: r for c, r in zip(cases, fut.result())}
    pool.shutdown()
    return out, oracle


def test_fsdp2_tp2_mixed_and_split_byte_identical(world):
    out, ora = world
    assert out["f2t2"]["tokens"] == ora["f2t2"]["tokens"] \
        == out["one"]["tokens"]
    assert out["f2t2_split"]["tokens"] == ora["f2t2_split"]["tokens"] \
        == out["one_split"]["tokens"]
    f = out["f2t2"]["facts"]
    assert (f["fsdp_degree"], f["tp_degree"]) == (2, 2)
    assert f["mixed_compiles"] <= 4 and f["decode_compiles"] == 0
    whole = out["one"]["ranks"][0]["pool_bytes"]
    for rk in out["f2t2"]["ranks"]:
        assert rk["pool_bytes"] * 2 == whole


def test_pure_fsdp_and_replica_parity(world):
    out, ora = world
    for name in ("f4", "dp2f2"):
        assert out[name]["tokens"] == ora[name]["tokens"] \
            == out["one"]["tokens"], name
        f = out[name]["facts"]
        assert f["tp_degree"] == 1 and f["fsdp_degree"] == MESHES[name][
            "fsdp"]
        assert f["dp_degree"] == MESHES[name].get("dp", 1)
        # pools replicate over fsdp and dp
        whole = out["one"]["ranks"][0]["pool_bytes"]
        assert all(rk["pool_bytes"] == whole for rk in out[name]["ranks"])
    m = out["dp2f2"]["metrics"]
    assert m["serving_mesh_shape{dp}"] == 2.0
    assert m["serving_mesh_shape{fsdp}"] == 2.0


def test_each_rank_binds_one_group_per_axis_of_a_3d_mesh(world):
    """dp x fsdp x tp: every rank's group on each axis has the axis's
    size and the rank's coordinate as its index."""
    out, _ = world
    mesh = spmd.mesh_2d(2, 1, replica=2)
    assert mesh.dim_names == ["dp", "fsdp", "tp"]
    for rk in out["dp2f2"]["ranks"]:
        coords = mesh.coords(rk["rank"])
        assert rk["axes"] == {n: (mesh.axis_sizes()[n], coords[n])
                              for n in mesh.dim_names}


def test_qwen2_mixtral_and_tied_head_under_fsdp_x_tp(world):
    """Qwen2 (biases whole over fsdp), Mixtral (expert banks not named by
    fsdp) and a tied embedding (gathered once, kept to the head)."""
    out, ora = world
    for name in ("q_f2t2", "x_f2t2", "t_f2t2"):
        assert out[name]["tokens"] == ora[name]["tokens"] \
            == ora[name[0] + "_one"]["tokens"], name


def test_int8_weights_under_fsdp_equal_the_reference(world):
    """The int8 tree under fsdp: each rank keeps its fsdp slice of the
    codes and gathers them at each dispatch; tokens equal the reference's
    int8 engine on the same mesh and the one-rank int8 engine."""
    out, ora = world
    assert out["one_w8"]["tokens"] == ora["one_w8"]["tokens"]
    for name in ("f2t2_w8", "f4_w8"):
        assert out[name]["tokens"] == ora[name]["tokens"] \
            == ora["one_w8"]["tokens"], name
    # a rank keeps 1/4 of the codes (the per-channel scales whole)
    one = out["one_w8"]["facts"]["weight_quant_bytes"]
    got = out["f4_w8"]["facts"]["weight_quant_bytes"]
    assert one / 4 < got < one / 3


def test_gather_bytes_equal_the_reference(world):
    out, ora = world
    for name in ("f2t2", "f2t2_split", "f4", "dp2f2", "q_f2t2", "x_f2t2",
                 "f2t2_w8", "f4_w8", "t_f2t2"):
        f = out[name]["facts"]
        assert f["fsdp_gather_bytes"] == ora[name]["per_dispatch"] > 0
        assert f["fsdp_received_bytes"] == f["fsdp_gather_bytes"]
        assert out[name]["metrics"][GATHER] == ora[name]["bytes"], name
        steps = f["device_ops"]["steps"]
        assert ora[name]["bytes"] == steps * f["fsdp_gather_bytes"]


def _slice(full, spec, sizes, coords):
    out = full
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        part, idx = 1, 0
        for n in names:
            idx = idx * sizes[n] + coords[n]
            part *= sizes[n]
        step = full.shape[dim] // part
        out = np.take(out, np.arange(idx * step, (idx + 1) * step), dim)
    return out


def test_each_rank_stores_its_slice_of_the_one_card_model(world, refs):
    out, _ = world
    state = {k: v.numpy() for k, v in state_from_paddle_tpu(
        {k: _np(v) for k, v in refs["llama"].state_dict().items()}).items()}
    whole = sum(a.nbytes for a in state.values())
    for name in ("f2t2", "f4", "dp2f2"):
        mesh = spmd.mesh_2d(MESHES[name]["fsdp"], MESHES[name]["tp"],
                            replica=MESHES[name].get("dp", 1))
        specs = out[name]["facts"]["specs"]
        sizes = mesh.axis_sizes()
        for rk in out[name]["ranks"]:
            coords = mesh.coords(rk["rank"])
            for n, got in rk["params"].items():
                spec = spmd.port_spec(n, specs[n])
                want = _slice(state[n], spec, sizes, coords)
                np.testing.assert_array_equal(got, want)
                part = np.prod([sizes[a] for a in spmd.spec_axes(spec)])
                if "fsdp" in spmd.spec_axes(spec):
                    assert got.nbytes * part == state[n].nbytes
        stored = {rk["param_bytes"] for rk in out[name]["ranks"]}
        assert len(stored) == 1
        if name == "f4":
            assert stored.pop() * 4 == whole


def test_mesh_helpers_match_the_reference():
    for args in ((2, 2), (4, 1), (2, 2, 2), (2, 1, 2)):
        kw = dict(replica=args[2]) if len(args) > 2 else {}
        pm, rm = spmd.mesh_2d(*args[:2], **kw), \
            ref_spmd.mesh_2d(*args[:2], **kw)
        assert pm.shape == list(rm.shape)
        assert pm.dim_names == list(rm.dim_names)
    assert spmd.mesh_2d(2, 2, replica=2).dim_names == ["dp", "fsdp", "tp"]
    assert spmd.cp_mesh(2, tp=2).dim_names == ["cp", "tp"]
    assert spmd.cp_mesh(4).shape == [4]
    for bad in ((0, 2), (2, 0)):
        with pytest.raises(ValueError, match="degree"):
            spmd.mesh_2d(*bad)
    # in a world of one rank a mesh needs no more ranks than it holds
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "rdv"), rank=0, world_size=1)
        try:
            with pytest.raises(ValueError, match="ranks"):
                spmd.mesh_2d(64, 64)
            with pytest.raises(ValueError, match="ranks"):
                spmd.cp_mesh(2, tp=2)
            assert spmd.mesh_2d(1, 1).shape == [1, 1]
        finally:
            dist.destroy_process_group()


def _port(ref, cls, cfg_cls):
    return cls(cfg_cls(**_cfg_dict(ref, cfg_cls)), device="meta")


def test_spec_tables_with_fsdp_equal_the_reference(refs):
    for key, cls, cfg_cls in (("llama", LlamaForCausalLM, LlamaConfig),
                              ("qwen2", Qwen2ForCausalLM, Qwen2Config),
                              ("mixtral", MixtralForCausalLM,
                               MixtralConfig)):
        ref = refs[key]
        port = _port(ref, cls, cfg_cls)
        for spec in (MESHES["f2t2"], MESHES["f4"], MESHES["dp2f2"],
                     {"fsdp": 2, "tp": 1}):
            pctx = spmd.tp_serving_context(port, spmd.mesh_2d(
                spec["fsdp"], spec["tp"], replica=spec.get("dp", 1)))
            rctx = ref_spmd.tp_serving_context(ref, _ref_mesh(spec))
            assert {k: tuple(v) for k, v in pctx.specs.items()} \
                == {k: tuple(v) for k, v in rctx.specs.items()}, (key, spec)
            arrays = {k: _np(v) for k, v in ref.state_dict().items()}
            assert pctx.fsdp_gather_bytes(arrays) \
                == rctx.fsdp_gather_bytes(arrays) > 0
            for n in (4, 8):
                assert pctx.collective_bytes(ref.config, n, 4) \
                    == rctx.collective_bytes(ref.config, n, 4)


def test_fsdp_gather_bytes_accounting_and_prune():
    """``tests/test_spmd2d.py``'s cases on the port's functions."""
    P = spmd.P
    lay = spmd.SpecLayout(tp_axis="tp", fsdp_axis="fsdp")
    assert lay.embeddings() == P("tp", "fsdp")
    assert lay.qkv_projection() == P("fsdp", "tp")
    assert lay.attn_output() == P("tp", "fsdp")
    assert lay.ffn_up() == P("fsdp", "tp")
    assert lay.ffn_down() == P("tp", "fsdp")
    assert lay.lm_head() == P("fsdp", "tp")
    assert lay.fsdp_default() == P("fsdp")
    pf = spmd.SpecLayout(tp_axis=None, fsdp_axis="fsdp")
    assert spmd.spec_axes(pf.qkv_projection()) == ("fsdp",)
    assert spmd.SpecLayout().qkv_projection() == P(None, "tp")
    mesh = spmd.mesh_2d(2, 2)
    assert spmd.prune_spec_axes(P("fsdp", "tp"), (64, 32), mesh) \
        == P("fsdp", "tp")
    assert spmd.prune_spec_axes(P("fsdp", "tp"), (63, 32), mesh) \
        == P(None, "tp")
    assert spmd.prune_spec_axes(P("fsdp", "tp"), (64, 31), mesh) \
        == P("fsdp")
    assert spmd.prune_spec_axes(P(("fsdp", "tp"),), (2,), mesh) == P("fsdp")
    assert spmd.prune_spec_axes(P("fsdp", "tp"), (64,), mesh) == P("fsdp")
    keys = ["llama.layers.0.self_attn.q_proj.weight",
            "llama.layers.0.input_layernorm.weight"]
    specs = spmd.llama_param_specs(keys, lay, shapes={
        keys[0]: (64, 64), keys[1]: (63,)}, mesh=mesh)
    assert specs[keys[0]] == P("fsdp", "tp") and specs[keys[1]] == P()
    ctx = spmd.TPContext(mesh, "tp", 2, lay,
                         {"w": P("fsdp", "tp"), "norm": P()},
                         fsdp_axis="fsdp", fsdp_degree=2)
    rctx = ref_spmd.TPContext(ref_spmd_mesh(), "tp", 2, ref_spmd.SpecLayout(
        tp_axis="tp", fsdp_axis="fsdp"), {"w": P("fsdp", "tp"),
                                          "norm": P()},
        fsdp_axis="fsdp", fsdp_degree=2)
    arrays = {"w": np.zeros((8, 8), np.float32),
              "norm": np.zeros((8,), np.float32)}
    assert ctx.fsdp_gather_bytes(arrays) == rctx.fsdp_gather_bytes(arrays) \
        == 64
    assert ctx.fsdp_gather_bytes({}) == 64          # cached per engine
    assert spmd.TPContext(mesh, "tp", 2, lay, {}).fsdp_gather_bytes(
        arrays) == 0


def ref_spmd_mesh():
    import paddle_tpu.distributed.process_mesh as pm
    return pm.as_jax_mesh(cpu_mesh_2d(2, 2))


def test_serving_context_2d_degrees(refs):
    ref = refs["llama"]
    port = _port(ref, LlamaForCausalLM, LlamaConfig)
    for args, want in (((2, 2), (2, 2, "tp")), ((4, 1), (1, 4, None)),
                       ((2, 1, 2), (1, 2, None))):
        kw = dict(replica=args[2]) if len(args) > 2 else {}
        pctx = spmd.tp_serving_context(port, spmd.mesh_2d(*args[:2], **kw))
        rctx = ref_spmd.tp_serving_context(ref, ref_spmd.mesh_2d(
            *args[:2], **kw))
        got = (pctx.degree, pctx.fsdp_degree, pctx.axis)
        assert got == want == (rctx.degree, rctx.fsdp_degree, rctx.axis)
        assert pctx.fsdp_axis == rctx.fsdp_axis == "fsdp"
    assert spmd.tp_serving_context(port, spmd.mesh_2d(1, 1)) is None
    assert ref_spmd.tp_serving_context(ref, ref_spmd.mesh_2d(1, 1)) is None
    # a whole model cannot serve an fsdp mesh: each rank serves its shard
    whole = LlamaForCausalLM(LlamaConfig(**_cfg_dict(ref, LlamaConfig)),
                             device="cpu")
    with pytest.raises(ValueError, match="shard_model"):
        ContinuousBatchingEngine(whole, device="cpu", mesh=spmd.mesh_2d(
            2, 2, backend="gloo"), **MIXED)
