"""The seventeen learning-rate schedulers of ``optimizer/lr.py`` in the port
against the JAX reference's, on the CPU: each one's rates over 30 steps
equal to the reference's (``ReduceOnPlateau`` fed a loss series).  A
scheduler as an optimizer's ``learning_rate`` is in
``tests/test_torch_optimizers.py``.
"""
import numpy as np
import pytest

from paddle_tpu.optimizer import lr as ref_lr

from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)


def _schedulers(mod):
    """The seventeen schedulers, built alike from ``mod``."""
    return {
        "Noam": mod.NoamDecay(d_model=64, warmup_steps=5),
        "Piecewise": mod.PiecewiseDecay([3, 8, 20], [0.5, 0.2, 0.1, 0.05]),
        "NaturalExp": mod.NaturalExpDecay(0.5, gamma=0.1),
        "InverseTime": mod.InverseTimeDecay(0.5, gamma=0.2),
        "Polynomial": mod.PolynomialDecay(0.5, decay_steps=12, power=2.0),
        "PolynomialCycle": mod.PolynomialDecay(0.5, decay_steps=7,
                                               cycle=True),
        "LinearWarmup": mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.5, T_max=10), warmup_steps=5,
            start_lr=0.0, end_lr=0.5),
        "Exponential": mod.ExponentialDecay(0.5, gamma=0.9),
        "MultiStep": mod.MultiStepDecay(0.5, milestones=[4, 9, 17]),
        "Step": mod.StepDecay(0.5, step_size=6, gamma=0.5),
        "Lambda": mod.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "Multiplicative": mod.MultiplicativeDecay(0.5, lambda e: 0.97),
        "CosineAnnealing": mod.CosineAnnealingDecay(0.5, T_max=12,
                                                    eta_min=0.01),
        "WarmRestarts": mod.CosineAnnealingWarmRestarts(0.5, T_0=4,
                                                        T_mult=2),
        "ReduceOnPlateau": mod.ReduceOnPlateau(0.5, factor=0.5, patience=2,
                                               cooldown=1),
        "OneCycle": mod.OneCycleLR(0.5, total_steps=25),
        "Cyclic": mod.CyclicLR(0.05, 0.5, step_size_up=4, step_size_down=6,
                               mode="triangular2"),
        "Linear": mod.LinearLR(0.5, total_steps=20, start_factor=0.25),
    }


def _plateau_losses():
    rng = np.random.RandomState(3)
    return [1.0 / (1 + i) + (0.3 if i % 7 > 3 else 0.0) + 0.01 * rng.rand()
            for i in range(30)]


@pytest.mark.parametrize("name", sorted(_schedulers(port_lr)))
def test_scheduler_rates_match_the_reference(name):
    ref, port = _schedulers(ref_lr)[name], _schedulers(port_lr)[name]
    assert type(port).__name__ == type(ref).__name__
    losses = _plateau_losses()
    got, want = [], []
    for i in range(30):
        got.append(port())
        want.append(ref())
        if name == "ReduceOnPlateau":
            port.step(losses[i])
            ref.step(losses[i])
        else:
            port.step()
            ref.step()
    assert got == want
    if name == "ReduceOnPlateau":
        assert min(got) < got[0]        # the series plateaus: lr drops


def test_seventeen_scheduler_classes():
    names = {type(s).__name__ for s in _schedulers(port_lr).values()}
    assert len(names) == 17
    assert all(issubclass(getattr(port_lr, n), port_lr.LRScheduler)
               for n in names)
