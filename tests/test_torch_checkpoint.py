"""Sharded async checkpoints in the port against the JAX reference, on the
CPU: ``paddle_tpu_torch.distributed.checkpoint`` (the manager, its
multi-rank commit and reshard on load) and ``TrainStep.ckpt_values`` /
``load_train_state``.

The reference's ``tests/test_checkpoint_manager.py`` gates, retargeted:
the async round trip with ``keep_last_k`` (:51), the scan that skips
partial and corrupt directories (:71), an async write failure surfacing
on ``wait`` (:94), kill -9 at a write stage leaving only complete
checkpoints and a resume matching the uninterrupted run to 1e-5 (:145,
through the port's victim ``paddle_tpu_torch.testing.ckpt_victim``; one
kill point in tier 1, the other two slow), ZeRO-2 saved under dp 4 and
restored under dp 2 and dp 1 (:395) and 2-D (2, 2) under (4, 1) and
(1, 1) (:471), each next loss within 1e-5 of the uninterrupted run.
Besides: a snapshot finished before ``save`` returns (the port's
optimizer updates in place), one writer per box (the payload bytes summed
over ranks equal each value's whole bytes), and both directions across
formats — the reference's manager reads a one-process port checkpoint,
and a reference ZeRO-2 dp-4 checkpoint continues in the port's dp-2 step
within 1e-5 of the reference's uninterrupted run.  The ranks run as one
four-rank gloo world (``testing.sharded.train_cases``).
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.checkpoint import \
    CheckpointManager as RefManager
from paddle_tpu.distributed.process_mesh import ProcessMesh as RefMesh
from paddle_tpu.jit.train_step import ShardingConfig as RefSharding
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as RefCriterion
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_config

from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                     TrainState)
from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny_config)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing import ckpt_victim, faults

TOL = 1e-5
K, C = 3, 3             # steps before the save, steps after it
OPT = dict(name="adamw", learning_rate=1e-3)
LLAMA_KW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, vocab_size=128, intermediate_size=128)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SUB_ENV = {k: v for k, v in os.environ.items()
            if k not in ("PADDLE_TPU_FAULT_SPEC",)}
_SUB_ENV["PYTHONPATH"] = _ROOT


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------------------
# manager unit behaviour (one process)
# ---------------------------------------------------------------------------
def test_roundtrip_async_and_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.full((3, 4), float(s)),
                     "b": torch.full((5,), float(s), dtype=torch.bfloat16),
                     "k": np.arange(4, dtype=np.uint32)},
                 {"global_step": s})
    mgr.wait()
    assert [s for s, _ in mgr.all_valid()] == [2, 3]   # GC kept 2
    st = mgr.load()
    assert st.meta["global_step"] == 3
    assert np.all(st.global_value("w") == 3.0)
    b = st.global_value("b")
    assert b.dtype == torch.bfloat16 and bool((b == 3.0).all())
    assert st.global_value("k").dtype == np.uint32
    assert np.all(mgr.load(2).global_value("w") == 2.0)
    with pytest.raises(FileNotFoundError):
        mgr.load(1)                          # GC'd


def test_scan_skips_partial_and_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=10)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.full((2,), float(s))}, sync=True)
    p3 = os.path.join(str(tmp_path), "step_3", "shards_0.distcp")
    blob = bytearray(open(p3, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p3, "wb").write(bytes(blob))
    # a save that never committed (a dead pid), and a bare final dir
    os.makedirs(os.path.join(str(tmp_path), ".tmp.9.999999"))
    os.makedirs(os.path.join(str(tmp_path), "step_9"))
    fresh = CheckpointManager(str(tmp_path), keep_last_k=10)
    assert [s for s, _ in fresh.all_valid()] == [1, 2]
    assert fresh.load().meta.get("wall_time") is not None
    assert fresh.latest_valid()[0] == 2      # CRC mismatch skipped
    assert not any(n.startswith(".tmp.") for n in os.listdir(tmp_path))


def test_async_write_failure_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    faults.configure("ioerror:ckpt.write")
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(faults.FaultError):
        mgr.wait()
    faults.reset()
    mgr.save(2, {"w": torch.zeros(2)})       # the manager still works
    mgr.wait()
    assert [s for s, _ in mgr.all_valid()] == [2]


def _tiny_step(dtype="float32", seed=0):
    cfg = llama_tiny_config(dtype=dtype, **LLAMA_KW)
    model = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    opt = AdamW(1e-3, parameters=model.named_parameters(),
                multi_precision=dtype == "bfloat16")
    return TrainStep(model, LlamaPretrainingCriterion(), opt, clip_norm=1.0)


def _ids(seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        1, 128, (4, 16)))


def test_snapshot_is_finished_when_save_returns(tmp_path):
    """The optimizer writes parameters and moments in place: a step run
    at once after ``save`` must not reach the checkpoint, which must equal
    bitwise the values cloned before that step (bf16, fp32 master)."""
    step = _tiny_step("bfloat16")
    step(_ids(0), _ids(0))
    vals = step.ckpt_values()
    before = {k: v.clone() for k, v in vals.items()}
    assert any(k.endswith(".master") for k in before)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, vals, {"global_step": 1})
    step(_ids(1), _ids(1))                   # updates every value in place
    mgr.wait()
    state = mgr.load()
    moved = 0
    for k, want in before.items():
        assert torch.equal(state.global_tensor(k), want), k
        moved += not torch.equal(want, step.ckpt_values()[k])
    assert moved > len(before) // 2


def test_reference_manager_reads_a_port_checkpoint(tmp_path):
    """A one-process port checkpoint is the reference's format 1: its
    manager validates and loads it, bf16 and the fp32 master included,
    and the port restores it into a fresh step that then trains
    bitwise as the saved one."""
    step = _tiny_step("bfloat16")
    step(_ids(0), _ids(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, step.ckpt_values(), {"global_step": 1}, sync=True)
    manifest = json.load(open(tmp_path / "step_1" / "manifest.json"))
    assert manifest["format"] == 1
    assert list(manifest["files"]) == ["shards_0.distcp"]
    ref = RefManager(str(tmp_path)).load()
    assert ref.meta["global_step"] == 1
    for k, v in step.ckpt_values().items():
        got = np.asarray(ref.global_value(k)).astype(np.float32)
        np.testing.assert_array_equal(got, v.to(torch.float32).numpy(),
                                      err_msg=k)
    twin = _tiny_step("bfloat16", seed=5)
    twin.load_train_state(mgr.load())
    assert twin.global_step == 1
    assert torch.equal(twin(_ids(1), _ids(1)), step(_ids(1), _ids(1)))


# ---------------------------------------------------------------------------
# kill -9 mid-async-save (a real subprocess) and the resume
# ---------------------------------------------------------------------------
def _run_victim(ckpt_dir, loss_out, spec=None, check=True):
    env = dict(_SUB_ENV)
    if spec:
        env["PADDLE_TPU_FAULT_SPEC"] = spec
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.testing.ckpt_victim",
         ckpt_dir, loss_out], env=env, capture_output=True, text=True,
        timeout=240, cwd=_ROOT)
    if check and proc.returncode != 0:
        raise AssertionError("victim rc=%s\n%s\n%s" % (
            proc.returncode, proc.stdout, proc.stderr))
    return proc


@pytest.fixture(scope="module")
def baseline_losses(tmp_path_factory):
    """One uninterrupted run of the victim (no checkpoints)."""
    out = str(tmp_path_factory.mktemp("base") / "losses.json")
    _run_victim("-", out)
    losses = json.load(open(out))
    assert len(losses) == ckpt_victim.STEPS
    return losses


@pytest.mark.parametrize("spec", [
    "kill:ckpt.write:after=3",      # the 2nd save, before its payload
    pytest.param("kill:ckpt.manifest:after=2", marks=pytest.mark.slow),
    pytest.param("kill:ckpt.commit:after=1", marks=pytest.mark.slow),
])
def test_kill9_leaves_only_complete_checkpoints_and_resume_matches(
        tmp_path, baseline_losses, spec):
    ckpt = str(tmp_path / "ckpt")
    out = str(tmp_path / "losses.json")
    proc = _run_victim(ckpt, out, spec=spec, check=False)
    assert proc.returncode == -signal.SIGKILL, \
        "victim survived its kill spec: rc=%s" % proc.returncode
    assert not os.path.exists(out)
    step_dirs = [n for n in os.listdir(ckpt) if n.startswith("step_")]
    scan = CheckpointManager(ckpt, keep_last_k=0)
    valid = scan.all_valid()
    assert len(valid) == len(step_dirs)
    for s, _ in valid:
        st = scan.load(s)
        assert isinstance(st, TrainState)
        assert st.global_value(ckpt_victim.KEY).shape == (64, 32)
    survivor = valid[-1][0] if valid else 0
    _run_victim(ckpt, out)
    resumed = json.load(open(out))
    assert len(resumed) == ckpt_victim.STEPS - survivor
    diff = max(abs(a - b) for a, b in
               zip(baseline_losses[survivor:], resumed))
    assert diff <= TOL, (survivor, diff)


# ---------------------------------------------------------------------------
# over ranks: one four-rank world
# ---------------------------------------------------------------------------
def _batches(vocab, n=3):
    rng = np.random.RandomState(11)
    return [(rng.randint(0, vocab, (8, 16)).astype(np.int64),
             rng.randint(0, vocab, (8, 16)).astype(np.int64))
            for _ in range(n)]


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _reference_zero2_checkpoint(ckpt_dir, npz):
    """The reference's ZeRO-2 dp-4 Llama (its initial weights saved to
    ``npz``): K steps, a checkpoint, then C more steps (the uninterrupted
    run's losses)."""
    paddle.seed(0)
    model = RefLlama(ref_llama_config(**LLAMA_KW))
    np.savez(npz, **{k: _np(v) for k, v in model.state_dict().items()})
    crit = RefCriterion()
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    step = RefTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                        clip_norm=1.0,
                        mesh=RefMesh(shape=[4], dim_names=["dp"]),
                        sharding=RefSharding(stage=2))
    batches = _batches(128)
    losses = []
    for i in range(K + C):
        if i == K:
            vals = {f"model.{k}": t._value
                    for k, t in model.state_dict().items()}
            vals.update(step.opt_state_arrays())
            RefManager(ckpt_dir).save(K, vals, {"global_step": K},
                                      sync=True)
        ids, labels = batches[i % len(batches)]
        out = step(paddle.to_tensor(ids.astype(np.int32)),
                   paddle.to_tensor(labels))
        losses.append(float(np.asarray(out._value)))
    return model, losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_world")
    ref_dir = str(tmp / "reference")
    path = str(tmp / "m.npz")
    ref_model, ref_losses = _reference_zero2_checkpoint(ref_dir, path)
    models = {"m": dict(family="llama", state=path, config={
        f: getattr(ref_model.config, f)
        for f in LlamaConfig.__dataclass_fields__
        if hasattr(ref_model.config, f)})}
    common = dict(kind="checkpoint", model="m", optimizer=OPT, clip=1.0,
                  batches=_batches(128), steps=K, inplace_gate=True,
                  **{"continue": C})
    cases = [
        dict(common, name="z2", mesh={"dp": 4}, stage=2,
             dir=str(tmp / "z2"), restore={"dp2": {"dp": 2}, "dp1": None}),
        dict(common, name="2d", mesh={"fsdp": 2, "tp": 2},
             dir=str(tmp / "2d"),
             restore={"4x1": {"fsdp": 4, "tp": 1}, "1x1": None}),
        dict(common, name="ref", from_reference=ref_dir,
             restore={"dp2": {"dp": 2}}),
        dict(name="sdict", kind="state_dict", dir=str(tmp / "sdict"),
             x=SD_X, y=SD_Y, w=SD_W),
    ] + [dict(name="sdict_fault_%s" % mode, kind="state_dict",
              dir=str(tmp / ("sdict_fault_" + mode)), x=SD_X, y=SD_Y,
              w=SD_W, fault_rank=r, **{"async": mode == "async"})
         for mode, r in (("async", 2), ("sync", 0))]
    out = run_world("paddle_tpu_torch.testing.sharded:train_cases", 4,
                    dict(device="cpu", backend="gloo", models=models,
                         cases=cases), timeout=300,
                    env={"OMP_NUM_THREADS": "1"})
    res = {c["name"]: r for c, r in zip(cases, out)}
    return res, ref_losses, {c["name"]: c for c in cases}


SD_X = np.arange(48, dtype=np.float32).reshape(8, 6)
SD_Y = np.arange(12, dtype=np.float32) / 8
SD_W = np.arange(9, dtype=np.float32).reshape(3, 3) - 4


def _close(got, want, tol=TOL):
    assert len(got) == len(want) and got
    diff = max(abs(a - b) for a, b in zip(got, want))
    assert diff <= tol, (got, want, diff)


@pytest.mark.parametrize("target", ["dp2", "dp1"])
def test_zero2_dp4_checkpoint_restores_on_a_smaller_dp(world, target):
    res, _, _ = world
    z2 = res["z2"]["losses"]
    _close(z2["restored"][target], z2["continued"])


@pytest.mark.parametrize("target", ["4x1", "1x1"])
def test_2d_checkpoint_restores_on_another_mesh(world, target):
    res, _, _ = world
    two = res["2d"]["losses"]
    _close(two["restored"][target], two["continued"])
    # the 2-D and the ZeRO runs are one model on one batch stream
    _close(two["continued"], res["z2"]["losses"]["continued"])


def test_reference_zero2_checkpoint_continues_in_the_port(world):
    """A reference ZeRO-2 dp-4 checkpoint after K steps, restored into
    the port's dp-2 step (names and layouts through
    ``parity.train_state_from_paddle_tpu``): its next C losses are the
    reference's uninterrupted run's."""
    res, ref_losses, _ = world
    _close(res["ref"]["losses"]["restored"]["dp2"], ref_losses[K:])


@pytest.mark.parametrize("name", ["z2", "2d"])
def test_each_box_is_written_once(world, name):
    """One writer per box: the payload bytes summed over the ranks are
    each saved value's whole bytes, exactly (a replica written twice
    would still assemble, so only the count shows it)."""
    res, _, _ = world
    ranks = res[name]["ranks"]
    total = sum(rk["snapshot_bytes"] for rk in ranks)
    assert total == res[name]["losses"]["global_bytes"]
    assert all(rk["snapshot_bytes"] > 0 for rk in ranks)


@pytest.mark.parametrize("name", ["z2", "2d"])
def test_async_snapshot_over_ranks_is_the_state_at_save(world, name):
    res, _, _ = world
    for rk in res[name]["ranks"]:
        assert rk["snapshot_bitwise"], rk["rank"]
        assert rk["valid_steps"] == [K]


def test_multi_rank_checkpoint_is_format_2_which_the_reference_skips(
        world):
    res, _, cases = world
    d = cases["z2"]["dir"]
    manifest = json.load(open(os.path.join(d, "step_%d" % K,
                                           "manifest.json")))
    assert manifest["format"] == 2
    assert sorted(manifest["files"]) == ["shards_%d.distcp" % r
                                         for r in range(4)]
    assert CheckpointManager(d).latest_valid()[0] == K
    assert RefManager(d).all_valid() == []
    assert not any(n.startswith(".tmp.") for n in os.listdir(d))


def test_comm_watchdog_reports_a_collective_past_its_deadline(monkeypatch):
    """``FLAGS_comm_task_timeout_s`` arms the watchdog that every
    collective and the manager's commit run under: a task past its
    deadline reaches the abort handler (default off: no task at all)."""
    import time
    from paddle_tpu_torch.distributed import comm_watchdog as wd
    assert wd.comm_task("idle").__enter__() is None
    monkeypatch.setenv(wd.TIMEOUT_ENV, "0.05")
    mgr = wd.CommTaskManager()
    hit = []
    mgr.abort_handler = hit.append
    task = mgr.start_task("all_reduce", lambda: [0, 1])
    time.sleep(0.4)
    mgr.end_task(task)
    mgr.shutdown()
    assert [t.name for t in hit] == ["all_reduce"]
    assert hit[0].ranks == [0, 1]
    assert mgr.timed_out_tasks[0] is task


def test_save_and_load_state_dict_reshard_over_ranks(world):
    """``save_state_dict`` over four ranks (x placed fsdp x tp, y split
    four ways, w whole; async), loaded as x's rows over two ranks and y,
    w whole: the reference's per-rank ``{rank}_0.distcp`` files, one
    ``.metadata`` from the coordinator holding every rank's entries, each
    box written once."""
    import pickle
    res, _, cases = world
    for rk in res["sdict"]["ranks"]:
        if rk["rank"] < 2:
            np.testing.assert_array_equal(
                rk["x"], SD_X[4 * rk["rank"]:4 * (rk["rank"] + 1)])
        np.testing.assert_array_equal(rk["y"], SD_Y)
        np.testing.assert_array_equal(rk["w"], SD_W)
    d = cases["sdict"]["dir"]
    assert sorted(n for n in os.listdir(d) if n.endswith(".distcp")) == [
        "%d_0.distcp" % r for r in range(4)]
    assert [n for n in os.listdir(d) if n.endswith(".metadata")] == [
        "0.metadata"]
    with open(os.path.join(d, "0.metadata"), "rb") as f:
        meta = pickle.load(f)
    counts = {k: len(v) for k, v in meta.state_dict_metadata.items()}
    assert counts == {"x": 4, "y": 4, "w": 1}
    assert sorted(m.global_offset for m in meta.state_dict_metadata["x"]) \
        == [(0, 0), (0, 3), (4, 0), (4, 3)]
    assert meta.state_dict_metadata["y"][0].dtype == "bfloat16"


@pytest.mark.parametrize("mode,bad", [("async", 2), ("sync", 0)])
def test_save_state_dict_write_failure_raises_on_every_rank(world, mode,
                                                            bad):
    """A data write that fails on one rank (``ckpt.write``) raises on
    every rank, instead of leaving the others waiting for it for good,
    and no ``.metadata`` marks the directory as a checkpoint."""
    res, _, cases = world
    for rk in res["sdict_fault_" + mode]["ranks"]:
        err = rk["error"]
        if rk["rank"] == bad:
            assert err.startswith("FaultError"), err
        else:
            assert "the write failed on rank(s) {%d:" % bad in err, err
    d = cases["sdict_fault_" + mode]["dir"]
    assert not [n for n in os.listdir(d) if n.endswith(".metadata")]
