"""The ResNet family through the paddle API, port against reference on
the CPU, from the same numpy weights (``api_state_from_paddle_tpu``,
every key matched both ways):

- ``resnet18(num_classes=10)`` at 4 x 3 x 32 x 32 through ``TrainStep``
  with ``Momentum(0.1, momentum=0.9)`` and ``F.cross_entropy``, the
  reference's ``TrainStep`` beside it.  In fp32: the first loss and the
  BatchNorm statistics of the first step within 1e-5.  Both steps are
  compared in fp64 (both models cast with ``to(dtype="float64")``), each
  step from the same state (the port given the reference's parameters,
  buffers and momentum after step 1): the losses, every parameter and
  every BN buffer within 1e-5 of its largest magnitude.
- ``resnet50()``, ``wide_resnet50_2()`` and ``resnext50_32x4d()``: the
  parameter counts and state-dict keys of the reference's; ResNet-50's
  eval forward at 1 x 3 x 64 x 64 within 1e-5.

Why not fp32 over both steps: layer 4's BatchNorm normalises 4 values a
channel (1 x 1 maps at batch 4), which magnifies rounding: after the two
steps each package's fp32 run lies away from its own fp64 run, by 0.58
of a tensor's magnitude for the reference's jitted step and 0.049 for
the port's eager one, and even the two fp64 runs drift to 1.4e-5 once a
step's optimizer (fp32 math in both) rounds one element differently.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models import resnet as rres
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models import resnet as pres
from paddle_tpu_torch.testing.parity import api_state_from_paddle_tpu
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)
from torch_api_parity import run_reference_traced

TOL = 1e-5
BATCH, IMAGE, CLASSES, STEPS = 4, 32, 10, 2


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _batches(dtype):
    rng = np.random.RandomState(0)
    xs = [rng.randn(BATCH, 3, IMAGE, IMAGE).astype(dtype)
          for _ in range(STEPS)]
    ys = [rng.randint(0, CLASSES, (BATCH,)).astype(np.int64)
          for _ in range(STEPS)]
    return xs, ys


def _train(pkg, step_cls, model, xs, ys, steps):
    opt = pkg.optimizer.Momentum(0.1, momentum=0.9,
                                 parameters=model.parameters())
    step = step_cls(model, lambda lg, lb: pkg.nn.functional.cross_entropy(
        lg, lb), opt)
    losses = [float(step(pkg.to_tensor(x), pkg.to_tensor(y)))
              for x, y in list(zip(xs, ys))[:steps]]
    return losses, _state(model)


def _pair(dtype):
    R.seed(0)
    ref = rres.resnet18(num_classes=CLASSES)
    port = pres.resnet18(num_classes=CLASSES)
    if dtype != "float32":
        ref.to(dtype=dtype)
        port.to(dtype=dtype)
    missing, unexpected = port.set_state_dict(
        api_state_from_paddle_tpu(_state(ref), layer=port))
    assert not missing and not unexpected
    return ref, port


def _rel(got, want):
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want)


def test_resnet18_first_step_fp32_matches_reference_train_step():
    xs, ys = _batches(np.float32)
    ref, port = _pair("float32")
    r_loss, r_state = _train(R, RefTrainStep, ref, xs, ys, 1)
    p_loss, p_state = _train(P, TrainStep, port, xs, ys, 1)
    assert abs(p_loss[0] - r_loss[0]) <= TOL * abs(r_loss[0])
    bufs = [k for k in r_state if k.endswith(("_mean", "_variance"))]
    assert len(bufs) == 40
    assert _rel({k: p_state[k] for k in bufs},
                {k: r_state[k] for k in bufs}) <= TOL


def test_resnet18_each_step_matches_reference_train_step_in_fp64():
    import torch
    xs, ys = _batches(np.float64)
    ref, port = _pair("float64")
    ropt = R.optimizer.Momentum(0.1, momentum=0.9,
                                parameters=ref.parameters())
    rstep = RefTrainStep(ref, lambda lg, lb: R.nn.functional.cross_entropy(
        lg, lb), ropt)
    popt = P.optimizer.Momentum(0.1, momentum=0.9,
                                parameters=port.parameters())
    pstep = TrainStep(port, lambda lg, lb: P.nn.functional.cross_entropy(
        lg, lb), popt)
    for x, y in zip(xs, ys):
        want = float(rstep(R.to_tensor(x), R.to_tensor(y)))
        got = float(pstep(P.to_tensor(x), P.to_tensor(y)))
        assert abs(got - want) <= TOL * abs(want), (got, want)
        r_state, p_state = _state(ref), _state(port)
        assert {str(v.dtype) for v in p_state.values()} == {"float64"}
        assert _rel(p_state, r_state) <= TOL
        # the next step from the reference's state and momentum
        port.set_state_dict(api_state_from_paddle_tpu(r_state, layer=port))
        for (name, _), rp in zip(popt.params, ref.parameters()):
            popt.state(name)["velocity"].copy_(torch.from_numpy(
                np.asarray(ropt._state[id(rp)]["velocity"])))
    moved = [k for k in r_state if k.endswith("_mean")
             and np.any(p_state[k] != 0)]
    assert len(moved) == 20


def test_train_step_over_an_api_layer_returns_an_api_tensor():
    _, port = _pair("float32")
    xs, ys = _batches(np.float32)
    opt = P.optimizer.Momentum(0.1, momentum=0.9,
                               parameters=port.parameters())
    step = TrainStep(port, lambda lg, lb: P.nn.functional.cross_entropy(
        lg, lb), opt)
    loss = step(P.to_tensor(xs[0]), P.to_tensor(ys[0]))
    assert isinstance(loss, P.Tensor) and loss.stop_gradient
    assert str(loss.numpy().dtype) == "float32"
    assert all(p.grad is None for p in port.parameters())


@pytest.mark.parametrize("name", ["resnet50", "wide_resnet50_2",
                                  "resnext50_32x4d"])
def test_parameter_counts_and_keys_equal_the_reference(name):
    R.seed(0)
    ref = getattr(rres, name)()
    port = getattr(pres, name)()
    r_state, p_state = ref.state_dict(), port.state_dict()
    assert list(p_state) == list(r_state)
    assert {k: tuple(v.shape) for k, v in p_state.items()} == \
        {k: tuple(v.shape) for k, v in r_state.items()}
    count = sum(int(np.prod(p.shape)) for p in port.parameters())
    assert count == sum(int(np.prod(p.shape)) for p in ref.parameters())
    if name == "resnet50":
        assert count == 25557032


def test_resnet50_eval_forward_matches_reference():
    R.seed(1)
    ref = rres.resnet50()
    port = pres.resnet50()
    port.set_state_dict(api_state_from_paddle_tpu(_state(ref), layer=port))
    ref.eval()
    port.eval()
    x = np.random.RandomState(2).randn(1, 3, 64, 64).astype(np.float32)
    want, _ = run_reference_traced(lambda pkg: ref, [x], {}, 3, grad=False)
    got = port(P.to_tensor(x)).numpy()
    want = np.asarray(want.numpy())
    assert got.shape == want.shape == (1, 1000)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_carrying_a_mismatched_state_names_the_difference():
    port = pres.resnet18(num_classes=CLASSES)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    extra = dict(state, **{"fc.extra": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="fc.extra"):
        api_state_from_paddle_tpu(extra, layer=port)
    state.pop("bn1._mean")
    with pytest.raises(KeyError, match="bn1._mean"):
        api_state_from_paddle_tpu(state, layer=port)
    state["bn1._mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="bn1._mean"):
        api_state_from_paddle_tpu(state, layer=port)
