"""Carry weights from the reference package to the port.

The reference (``paddle_tpu``) names its Llama parameters as the port
does (``llama.layers.0.self_attn.q_proj.weight``, ...), but stores every
``Linear`` weight as ``[in, out]`` where the port stores torch's
``[out, in]``.  The layerwise step's stacked buffers have one layout in
both packages.  The state arrives as plain numpy arrays, so this module
imports nothing of the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _is_linear_weight(name: str) -> bool:
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def state_from_paddle_tpu(np_state: Dict[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """Map the reference's ``model.state_dict()`` (as numpy) onto the
    port's names and layouts: Linear weights transposed to ``[out, in]``,
    everything else unchanged."""
    out = {}
    for name, arr in np_state.items():
        a = np.asarray(arr)
        if _is_linear_weight(name):
            if a.ndim != 2:
                raise ValueError("%s: expected a 2-D Linear weight, got "
                                 "shape %s" % (name, a.shape))
            a = a.T
        out[name] = torch.tensor(np.ascontiguousarray(a))   # a copy
    return out


@torch.no_grad()
def load_paddle_tpu_weights(model: nn.Module,
                            np_state: Dict[str, np.ndarray]) -> None:
    """Load the reference state into ``model`` strictly: every key must
    match both ways and every shape must agree; values are cast to each
    parameter's dtype and copied to its device."""
    state = state_from_paddle_tpu(np_state)
    params = dict(model.state_dict())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError("reference/port state mismatch: missing %s, "
                       "unexpected %s" % (missing, unexpected))
    for name, t in state.items():
        p = params[name]
        if tuple(p.shape) != tuple(t.shape):
            raise ValueError("%s: port shape %s vs reference %s"
                             % (name, tuple(p.shape), tuple(t.shape)))
        p.copy_(t.to(device=p.device, dtype=p.dtype))


def layerwise_params_from_paddle_tpu(np_params) -> Dict:
    """The reference ``LlamaLayerwiseTrainStep.params`` tree (``emb``,
    ``norm``, ``head`` and ``blocks``, as numpy) as the port's stacked
    buffers: the same layout, so plain copies (load them with the port
    step's ``set_params``)."""
    def copy(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a)))

    out = {name: copy(np_params[name]) for name in ("emb", "norm", "head")}
    out["blocks"] = {name: copy(a) for name, a in
                     np_params["blocks"].items()}
    return out
