"""Carry weights from the reference package to the port.

The reference (``paddle_tpu``) names its Llama, Qwen2 and Mixtral
parameters as the port does (``llama.layers.0.self_attn.q_proj.weight``,
``mixtral.layers.0.block_sparse_moe.gate.weight``, ...), but stores every
``Linear`` weight as ``[in, out]`` where the port stores torch's
``[out, in]``: the projections, the LM head and the MoE router are
transposed.  Mixtral's expert banks (``w_gate``, ``w_up``, ``w_down``) are
raw ``[E, in, out]`` parameters in both packages and biases are 1-D, so
they carry across as they are.  The layerwise step's stacked buffers have
one layout in both packages.  The serving engine's int8 weight tree
(weight PTQ) keeps the reference's keys, 2-D int8 codes transposed like
the weights they replace, and expert-bank codes and every ``::scale``
entry as they are.  The state arrives as plain numpy arrays, so this
module imports nothing of the reference.  Under a tp/ep mesh,
:func:`shard_from_paddle_tpu` gives a rank its shard of the same state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _is_linear_weight(name: str) -> bool:
    return (name.endswith("_proj.weight") or name == "lm_head.weight"
            or name.endswith("block_sparse_moe.gate.weight"))


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


def _torch_of(a) -> torch.Tensor:
    """A copy of numpy ``a`` as a torch tensor; an ml_dtypes bfloat16
    array (what the reference's ``numpy()`` gives for bf16) through its
    ``uint16`` bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a))


def api_state_from_paddle_tpu(np_state: Dict[str, np.ndarray], layer=None
                              ) -> Dict[str, torch.Tensor]:
    """A reference paddle-API ``Layer.state_dict()`` (as numpy) as the
    port's ``Layer.set_state_dict`` input, bf16 carried through its
    ``uint16`` bits.  The keys and layouts are the same in both packages:
    the API's ``Linear`` ``[in, out]``; a convolution's weight ``[out,
    in/groups, *k]`` and a transpose's ``[in, out/groups, *k]``;
    BatchNorm's ``_mean``/``_variance`` buffers; the recurrent layers'
    ``weight_ih_l{k}[_reverse]``, ``weight_hh_...``, ``bias_ih_...``,
    ``bias_hh_...``; ``weight_norm``'s ``weight_g``/``weight_v``,
    ``spectral_norm``'s ``weight_orig`` and ``SpectralNorm``'s
    ``weight_u``/``weight_v`` buffers.  With ``layer`` (a port ``Layer``)
    the state must match its keys both ways and its shapes, or
    ``KeyError``/``ValueError`` names the difference."""
    out = {name: _torch_of(arr) for name, arr in np_state.items()}
    if layer is not None:
        have = {k: tuple(v.shape) for k, v in layer.state_dict().items()}
        missing = sorted(set(have) - set(out))
        unexpected = sorted(set(out) - set(have))
        if missing or unexpected:
            raise KeyError("reference/port state mismatch: missing %s, "
                           "unexpected %s" % (missing, unexpected))
        bad = ["%s: port %s vs reference %s" % (k, have[k],
                                               tuple(out[k].shape))
               for k in out if tuple(out[k].shape) != have[k]]
        if bad:
            raise ValueError("; ".join(bad))
    return out


def ptq_tree_from_paddle_tpu(np_tree: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """Map a reference PTQ tree (``quantize_param_tree`` of the
    reference's state, as numpy: int8 codes ``[in, out]`` under the
    weight's key and an ``[out]`` fp32 vector under ``key + "::scale"``,
    or an expert bank's codes ``[E, in, out]`` with ``[E, 1, out]``
    scales; everything else fp) onto the port's tree: 2-D codes
    transposed to ``[out, in]``, bank codes and every scale copied, the fp
    entries mapped as :func:`state_from_paddle_tpu` maps them."""
    from ..quantization.functional import (WEIGHT_SCALE_SUFFIX,
                                           is_weight_scale_key)
    out = {}
    fp = {}
    for name, arr in np_tree.items():
        a = np.asarray(arr)
        if is_weight_scale_key(name):
            out[name] = torch.tensor(np.ascontiguousarray(a))
        elif name + WEIGHT_SCALE_SUFFIX in np_tree:
            if a.dtype != np.int8 or a.ndim not in (2, 3):
                raise ValueError("%s: expected 2-D or 3-D int8 codes, got "
                                 "%s %s" % (name, a.dtype, a.shape))
            out[name] = torch.tensor(np.ascontiguousarray(
                a.T if a.ndim == 2 else a))
        else:
            fp[name] = a
    out.update(state_from_paddle_tpu(fp))
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


def shard_from_paddle_tpu(model_cls, config, mesh,
                          np_state: Dict[str, np.ndarray], rank=None,
                          device="cpu") -> nn.Module:
    """This rank's shard of the reference's weights under ``mesh`` (a
    tp/ep ``distributed.process_mesh.ProcessMesh``): the state mapped onto
    the port's names and layouts (:func:`state_from_paddle_tpu`), then cut
    by the spec of each key (``jit.spmd.shard_model``; the reference's
    spec tables, each 2-D Linear weight's spec swapped to the port's
    ``[out, in]``)."""
    from ..jit.spmd import shard_model
    return shard_model(model_cls, config, mesh, rank=rank, device=device,
                       state=state_from_paddle_tpu(np_state))


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


def gather_placed(arrays: Dict[str, torch.Tensor], specs, mesh
                  ) -> Dict[str, np.ndarray]:
    """Whole arrays (numpy, the port's layout) from this rank's placed
    slices: each array gathered over every axis its spec (port layout;
    absent = whole) names, with ``jit.spmd.gather_spec_axes``.  Collective:
    every rank of ``mesh`` calls it with the same keys in the same
    order.  :func:`paddle_tpu_names` gives the reference's layout."""
    from ..jit.spmd import gather_spec_axes
    comms = mesh.bind() if mesh is not None else {}
    out = {}
    for k, v in arrays.items():
        spec = specs.get(k, ())
        whole = gather_spec_axes(v.detach(), spec, comms) if spec else v
        out[k] = whole.detach().to("cpu", torch.float32).numpy()
    return out


def paddle_tpu_names(np_arrays: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_paddle_tpu` for whole arrays: a
    Linear weight (``<name>``) and its parameter-shaped optimizer state
    (``opt.<name>.<leaf>``) transposed back to the reference's
    ``[in, out]``."""
    out = {}
    for k, a in np_arrays.items():
        base = k[len("opt."):].rsplit(".", 1)[0] if k.startswith("opt.") \
            else k
        out[k] = (np.ascontiguousarray(a.T)
                  if _is_linear_weight(base) and a.ndim == 2 else a)
    return out


def train_state_from_paddle_tpu(state):
    """A reference checkpoint (``distributed.checkpoint.TrainState`` as the
    port's manager loads it) in the port's layout: every shard of a Linear
    weight and of its parameter-shaped optimizer state (``model.<name>``,
    ``opt.<name>.<leaf>``) transposed to ``[out, in]``, offsets and shapes
    swapped with it; everything else as it is."""
    from ..distributed.checkpoint import TrainState
    arrays = {}
    for key, shards in state.arrays.items():
        base = key.split(".", 1)[1]
        if key.startswith("opt."):
            base = base.rsplit(".", 1)[0]
        if _is_linear_weight(base) and len(shards[0][1]) == 2:
            shards = [(tuple(off[::-1]), tuple(shape[::-1]), dt,
                       np.ascontiguousarray(np.asarray(a).T))
                      for off, shape, dt, a in shards]
        arrays[key] = shards
    return TrainState(arrays, dict(state.meta))
