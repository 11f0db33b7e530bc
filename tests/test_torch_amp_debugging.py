"""``paddle.amp.debugging`` of the port on the CPU: the reference's
``tests/test_amp_debugging.py`` cases retargeted (``check_numerics``, the
tensor checker naming the op and aborting, its skip list, operator
statistics by dtype, ``compare_accuracy`` over two runs' dumps), each
also run on the reference for the same answer, plus the hook's contract:
one slot in ``apply_op``, empty when no tool is on."""
import os

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu.amp.debugging as RD
import paddle_tpu_torch as paddle
from paddle_tpu_torch.amp.debugging import (
    DebugMode, TensorCheckerConfig, check_layer_numerics, check_numerics,
    collect_operator_stats, compare_accuracy, disable_tensor_checker,
    enable_tensor_checker, get_operator_stats)
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield
    assert dispatch._amp_debug_hook[0] is None


def test_check_numerics_counts_and_abort():
    t = paddle.to_tensor(np.array([1.0, np.nan, np.inf, 0.0], np.float32))
    with pytest.raises(FloatingPointError, match="1 nan, 1 inf"):
        check_numerics(t, "my_op", "x")
    n_nan, n_inf, n_zero = check_numerics(
        t, "my_op", "x", debug_mode=DebugMode.CHECK_NAN_INF)
    assert (int(n_nan.numpy()), int(n_inf.numpy()),
            int(n_zero.numpy())) == (1, 1, 1)
    want = RD.check_numerics(R.to_tensor(t.numpy()), "my_op", "x",
                             debug_mode=RD.DebugMode.CHECK_NAN_INF)
    assert [str(np.asarray(w.numpy()).dtype) for w in want] == \
        [str(g.numpy().dtype) for g in (n_nan, n_inf, n_zero)]
    ok = paddle.to_tensor(np.ones(3, np.float32))
    assert int(check_numerics(ok, "my_op", "ok")[0].numpy()) == 0


def test_tensor_checker_reports_op_name_and_aborts():
    enable_tensor_checker(TensorCheckerConfig(
        enable=True, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT))
    try:
        x = paddle.to_tensor(np.array([-1.0, 2.0], np.float32))
        with pytest.raises(FloatingPointError, match="op=log"):
            paddle.log(x) + 0   # log(-1) = nan, caught at the log op
    finally:
        disable_tensor_checker()
    y = paddle.log(paddle.to_tensor(np.array([-1.0], np.float32)))
    assert np.isnan(y.numpy()).all()


def test_tensor_checker_skip_list():
    enable_tensor_checker(TensorCheckerConfig(
        enable=True, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
        skipped_op_list=["log"]))
    try:
        y = paddle.log(paddle.to_tensor(np.array([-1.0], np.float32)))
        assert np.isnan(y.numpy()).all()
    finally:
        disable_tensor_checker()


def test_operator_stats_collection_by_dtype_equals_the_reference():
    def run(pkg, collect, get):
        with collect():
            a32 = pkg.to_tensor(np.ones((4, 4), np.float32))
            b16 = a32.astype("bfloat16")
            pkg.matmul(a32, a32)
            pkg.matmul(b16, b16)
            pkg.matmul(b16, b16)
            return get()
    stats = run(paddle, collect_operator_stats, get_operator_stats)
    assert stats["matmul"] == [0, 2, 1, 0]
    want = run(R, RD.collect_operator_stats, RD.get_operator_stats)
    assert stats["matmul"] == want["matmul"]


def _dump_run(pkg, debug, dump_dir, inject_nan):
    debug.enable_tensor_checker(debug.TensorCheckerConfig(
        enable=True, debug_mode=debug.DebugMode.CHECK_ALL,
        output_dir=str(dump_dir)))
    try:
        x = pkg.to_tensor(np.array([0.5, 2.0], np.float32))
        h = pkg.exp(x)
        if inject_nan:
            h = h * pkg.to_tensor(np.array([1.0, np.nan], np.float32))
        pkg.tanh(h)
    finally:
        debug.disable_tensor_checker()


def test_compare_accuracy_flags_nonfinite_divergence(tmp_path):
    _dump_run(paddle, paddle.amp.debugging, tmp_path / "a", False)
    _dump_run(paddle, paddle.amp.debugging, tmp_path / "b", True)
    report = str(tmp_path / "cmp.csv")
    rows = compare_accuracy(str(tmp_path / "a"), str(tmp_path / "b"),
                            report)
    assert os.path.exists(report)
    issues = {r["op"]: r["issue"] for r in rows}
    assert any("one run" in v or "drift" in v for v in issues.values())
    assert any(op in issues for op in ("multiply", "tanh", "mul"))
    _dump_run(R, RD, tmp_path / "ra", False)
    _dump_run(R, RD, tmp_path / "rb", True)
    want = RD.compare_accuracy(str(tmp_path / "ra"), str(tmp_path / "rb"),
                               str(tmp_path / "rcmp.csv"))
    assert sorted((r["op"], r["issue"]) for r in rows) == \
        sorted((r["op"], r["issue"]) for r in want)


def test_dumps_carry_the_reference_dtype_names(tmp_path):
    import json
    _dump_run(paddle, paddle.amp.debugging, tmp_path / "a", False)
    with open(tmp_path / "a" / "tensor_stats.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert {r["dtype"] for r in recs} == {"float32"}
    assert [r["op"] for r in recs] == ["exp", "tanh"]


def test_the_hook_is_one_slot_of_apply_op_and_empty_when_off():
    """Every tool installs the one slot and leaves it empty when it ends:
    the door's cost when off is one read."""
    assert dispatch._amp_debug_hook == [None]
    seen = []
    dispatch._amp_debug_hook[0] = lambda name, outs: seen.append(name)
    try:
        paddle.exp(paddle.to_tensor(np.ones(2, np.float32)))
    finally:
        dispatch._amp_debug_hook[0] = None
    assert seen == ["exp"]
    with collect_operator_stats():
        assert dispatch._amp_debug_hook[0] is not None
    assert dispatch._amp_debug_hook[0] is None


def test_check_layer_numerics_names_the_input_or_output():
    class Layer(paddle.nn.Layer):
        @check_layer_numerics
        def forward(self, x):
            return paddle.log(x)

    layer = Layer()
    layer(paddle.to_tensor(np.ones(2, np.float32)))
    with pytest.raises(FloatingPointError, match="output 0"):
        layer(paddle.to_tensor(np.array([-1.0], np.float32)))
    with pytest.raises(FloatingPointError, match="input 0"):
        layer(paddle.to_tensor(np.array([np.nan], np.float32)))
