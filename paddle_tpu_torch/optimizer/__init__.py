from . import lr  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401
from .optimizer import (SGD, Adadelta, Adafactor, Adagrad,  # noqa: F401
                        Adam, Adamax, AdamW, Lamb, Momentum, Optimizer,
                        RMSProp, Rprop, adam_update)


class L2Decay:
    """A weight-decay coefficient holder (the reference's ``L2Decay``):
    an optimizer's ``weight_decay`` may be one."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    def __float__(self):
        return self._coeff


class L1Decay(L2Decay):
    """The reference's ``L1Decay`` holder; the optimizers read its
    coefficient as they read ``L2Decay``'s, as the reference's do."""


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "Rprop", "Adafactor",
           "LBFGS", "L2Decay", "L1Decay", "adam_update", "lr"]
