"""Array redistribution and the live mesh reshape in the port against the
JAX reference, on the CPU: ``paddle_tpu_torch.jit.redistribute``.

The plan layer is host integers: the reference's
``tests/test_redistribute.py`` (:23-112) retargeted, every number held
against the reference's own ``plan_leaf`` on the same maps (dp 8 -> 4:
moved 7/8 of the array, the full-gather equivalent 4x, ratio 7/32).  The
apply runs over ranks (one four-rank gloo world,
``testing.sharded.train_cases``): rows of dp 4 onto dp 2 and a replicated
vector adopted, with ``redistribute_bytes_total``; and
``live_reshape`` of a ZeRO-2 dp-4 step onto dp 2 and of a 2-D (2, 2)
step onto (4, 1) — the reference's ``tests/test_elastic_e2e.py:51``
gates: the live arm's losses and every parameter and state leaf bitwise
equal to the checkpoint restart's, moved < 0.5 x the full gather, the
bytes on the wire equal to the plan's ``moved_bytes``, each rank's
allocator peak over the reshape (measured by the profiler's allocation
timeline) beyond the new slices it keeps within the largest destination
slice, and each leaf's plan equal to the reference's ``plan_leaf`` on the
same maps.
"""
import types

import numpy as np
import pytest

from paddle_tpu.jit import redistribute as ref_rd

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.distributed.process_mesh import ProcessMesh
from paddle_tpu_torch.jit import redistribute as rd
from paddle_tpu_torch.jit.spmd import P, ShardingConfig
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny_config)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

GATE = 0.5        # tools/bench_elastic.py MOVED_RATIO_GATE
FIELDS = ("key", "shape", "itemsize", "nbytes", "n_dst_devices",
          "moved_bytes", "adopted_bytes", "full_gather_equiv_bytes",
          "max_dst_shard_bytes")


def _same_plan(src, dst, key="w", shape=(32,), itemsize=4):
    """The port's plan of a leaf, asserted equal, field for field, to the
    reference's on the same maps."""
    got = rd.plan_leaf(key, shape, itemsize, src, dst)
    want = ref_rd.plan_leaf(key, shape, itemsize, src, dst)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.unchanged == want.unchanged
    return got


# ---------------------------------------------------------------------------
# box helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("index,shape", [
    ((slice(2, 6),), (8, 3)), ((slice(None), slice(1, None)), (4, 5)),
    ((), (7,))])
def test_normalize_index_fills_open_and_missing_dims(index, shape):
    assert rd.normalize_index(index, shape) == \
        ref_rd.normalize_index(index, shape)
    assert rd.normalize_index((slice(2, 6),), (8, 3)) == ((2, 6), (0, 3))


def test_box_overlap_and_nelems():
    for box in (((0, 4), (0, 3)), ((2, 2),)):
        assert rd.box_nelems(box) == ref_rd.box_nelems(box)
    assert rd.box_nelems(((0, 4), (0, 3))) == 12
    for a, b in ((((0, 4),), ((2, 8),)), (((0, 2),), ((2, 4),)),
                 (((0, 4), (0, 2)), ((2, 8), (1, 5)))):
        assert rd.box_overlap(a, b) == ref_rd.box_overlap(a, b)
    assert rd.box_overlap(((0, 2),), ((2, 4),)) is None


# ---------------------------------------------------------------------------
# plan arithmetic
# ---------------------------------------------------------------------------
def _rows(n_dev, rows, dev0=0):
    per = rows // n_dev
    return {dev0 + i: ((i * per, (i + 1) * per),) for i in range(n_dev)}


def test_dp8_to_4_row_sharded_numbers():
    rows, itemsize = 32, 4
    leaf = _same_plan(_rows(8, rows), _rows(4, rows), shape=(rows,))
    nbytes = rows * itemsize
    assert leaf.moved_bytes == nbytes * 7 // 8
    assert leaf.adopted_bytes == nbytes // 8
    assert leaf.full_gather_equiv_bytes == 4 * nbytes
    assert leaf.moved_bytes / leaf.full_gather_equiv_bytes \
        == pytest.approx(7 / 32)
    assert leaf.max_dst_shard_bytes == nbytes // 4


def test_replicated_leaf_is_fully_adopted():
    full = ((0, 16),)
    leaf = _same_plan({d: full for d in range(8)},
                      {d: full for d in range(4)}, key="b", shape=(16,),
                      itemsize=8)
    assert leaf.moved_bytes == 0 and leaf.unchanged
    assert leaf.max_dst_shard_bytes == 0


def test_disjoint_device_sets_move_everything():
    leaf = _same_plan(_rows(4, 8), _rows(4, 8, dev0=100), shape=(8,))
    assert leaf.adopted_bytes == 0
    assert leaf.moved_bytes == 8 * 4


def test_tree_rollup_and_summary():
    plan, ref = rd.RedistributionPlan(), ref_rd.RedistributionPlan()
    full = ((0, 16),)
    for args in (("w", (32,), 4, _rows(8, 32), _rows(4, 32)),
                 ("b", (16,), 4, {d: full for d in range(8)},
                  {d: full for d in range(4)})):
        plan.add(rd.plan_leaf(*args))
        ref.add(ref_rd.plan_leaf(*args))
    assert plan.summary() == ref.summary()
    s = plan.summary()
    assert 0 < s["moved_over_full_gather"] < GATE
    assert s["per_chip_peak_bytes"] == 32 * 4 // 4


def test_spec_boxes_are_the_slices_shard_tensor_takes():
    """A placement's boxes: a 2-D spec on a (2, 2) mesh, each rank's box
    of a [4, 6] array (the minor axis of a tuple entry inner)."""
    mesh = ProcessMesh([2, 2], ["fsdp", "tp"])
    boxes = rd.spec_boxes((4, 6), P("tp", "fsdp"), mesh)
    assert boxes == {0: ((0, 2), (0, 3)), 1: ((2, 4), (0, 3)),
                     2: ((0, 2), (3, 6)), 3: ((2, 4), (3, 6))}
    assert rd.spec_boxes((8,), P(("fsdp", "tp")), mesh)[2] == ((4, 6),)
    assert [rd.is_owner(P("fsdp"), mesh, r) for r in range(4)] == \
        [True, False, True, False]


def test_live_reshape_refuses_what_the_reference_refuses():
    cfg = llama_tiny_config(hidden_size=32, num_hidden_layers=1,
                            num_attention_heads=2, num_key_value_heads=2,
                            intermediate_size=64, vocab_size=64)
    model = LlamaForCausalLM(cfg, device="cpu")
    plain = TrainStep(model, LlamaPretrainingCriterion(),
                      AdamW(1e-3, parameters=model.named_parameters()))
    with pytest.raises(ValueError, match="needs a sharded TrainStep"):
        rd.live_reshape(plain, ProcessMesh([2], ["dp"]))
    one_d = types.SimpleNamespace(_mode="1d", _cfg=ShardingConfig())
    with pytest.raises(ValueError, match="degenerate"):
        rd.live_reshape(one_d, ProcessMesh([1], ["dp"]))
    two_d = types.SimpleNamespace(_mode="2d", _cfg=ShardingConfig())
    with pytest.raises(ValueError, match="'fsdp' axis"):
        rd.live_reshape(two_d, ProcessMesh([2], ["tp"]))


# ---------------------------------------------------------------------------
# over ranks: one four-rank world
# ---------------------------------------------------------------------------
LLAMA_KW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, vocab_size=128, intermediate_size=128)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from dataclasses import asdict
    tmp = tmp_path_factory.mktemp("reshape_world")
    rng = np.random.RandomState(5)
    batches = [(rng.randint(0, 128, (8, 16)), rng.randint(0, 128, (8, 16)))
               for _ in range(3)]
    models = {"m": dict(family="llama", seed=0,
                        config=asdict(llama_tiny_config(**LLAMA_KW)))}
    common = dict(kind="checkpoint", model="m", clip=1.0, batches=batches,
                  optimizer=dict(name="adamw", learning_rate=1e-3), steps=2,
                  after=2)
    cases = [
        dict(name="move", kind="redistribute", dst=2,
             x=np.arange(64, dtype=np.float32).reshape(8, 8),
             b=np.ones(4, np.float32)),
        dict(common, name="1d", mesh={"dp": 4}, stage=2, live={"dp": 2},
             dir=str(tmp / "1d")),
        dict(common, name="2d", mesh={"fsdp": 2, "tp": 2},
             live={"fsdp": 4, "tp": 1}, dir=str(tmp / "2d")),
    ]
    out = run_world("paddle_tpu_torch.testing.sharded:train_cases", 4,
                    dict(device="cpu", backend="gloo", models=models,
                         cases=cases), timeout=300,
                    env={"OMP_NUM_THREADS": "1"})
    return {c["name"]: r for c, r in zip(cases, out)}


def test_redistribute_array_values_and_metrics(world):
    ranks = world["move"]["ranks"]
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    for rk in ranks[:2]:
        r = rk["rank"]
        np.testing.assert_array_equal(rk["x"], x[4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(rk["b"], np.ones(4))
        assert rk["b_adopted"]                   # zero copies
    assert all(rk["x"] is None and rk["b"] is None for rk in ranks[2:])
    s = ranks[0]["summary"]
    assert s["moved_bytes"] == x.nbytes * 3 // 4
    assert sum(rk["sent"] for rk in ranks) == s["moved_bytes"]
    for rk in ranks:
        assert rk["metric"] == {"moved": s["moved_bytes"],
                                "full_gather_equiv":
                                    s["full_gather_equiv_bytes"]}
    assert s["moved_bytes"] < GATE * s["full_gather_equiv_bytes"]


@pytest.mark.parametrize("name", ["1d", "2d"])
def test_live_reshape_is_bitwise_the_checkpoint_restart(world, name):
    res = world[name]
    losses = res["losses"]
    assert losses["live"] == losses["restart"]            # bitwise
    assert len(losses["live"]) == 2
    for rk in res["ranks"]:
        if rk.get("bitwise") is not None:
            assert rk["bitwise"], rk["rank"]
    n_live = 2 if name == "1d" else 4
    assert sum(rk.get("bitwise") is not None
               for rk in res["ranks"]) == n_live
    if name == "1d":
        # the restart reads only the payloads that hold its boxes: rank
        # 0's (the whole parameters, the first rows) and its rows' files
        got = [rk["payloads_read"] for rk in res["ranks"][:2]]
        assert got == [["shards_0.distcp", "shards_1.distcp"],
                       ["shards_0.distcp", "shards_2.distcp",
                        "shards_3.distcp"]]


@pytest.mark.parametrize("name", ["1d", "2d"])
def test_live_reshape_moves_only_the_plan_s_bytes(world, name):
    res = world[name]
    plans = [rk["plan"] for rk in res["ranks"]]
    moved = plans[0]["moved_bytes"]
    assert moved < GATE * plans[0]["full_gather_equiv_bytes"]
    assert sum(p["wire_bytes"] for p in plans) == moved
    assert all(p["wire_bytes"] == p["sent_bytes"] for p in plans)
    for p in plans:
        # the allocator's peak over the reshape, beyond the new slices the
        # rank keeps, is at most one destination slice
        assert p["alloc_peak_bytes"] - p["new_bytes"] <= \
            p["per_chip_peak_bytes"], p
        assert p["host_staging_bytes"] == 0          # CPU tensors
    assert max(p["new_bytes"] for p in plans) > 0


@pytest.mark.parametrize("name", ["1d", "2d"])
def test_live_reshape_plan_is_the_reference_plan(world, name):
    """Each leaf's numbers equal the reference's ``plan_leaf`` on the
    same maps (the rank-to-box layouts of the two placements)."""
    leaves = world[name]["losses"]["plan_leaves"]
    assert any(k.startswith("opt.") and k.endswith("moment1")
               for k, *_ in leaves)
    for key, shape, item, src, dst, *got in leaves:
        want = ref_rd.plan_leaf(key, shape, item, src, dst)
        assert got == [want.moved_bytes, want.adopted_bytes,
                       want.full_gather_equiv_bytes,
                       want.max_dst_shard_bytes], key
