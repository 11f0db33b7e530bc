"""``group_sharded_parallel`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding_api.py``).

Levels ``"os"`` (ZeRO-1) and ``"os_g"`` (ZeRO-2) wrap the optimizer and
stamp it with ``_sharded_update = (mesh, ShardingConfig(stage, axis))``
from the hybrid group (``distributed.topology``): a ``TrainStep`` built
from that optimizer with no ``mesh`` runs the sharded update over that
axis, and degrades to the replicated step with a warning when it cannot
shard (``jit/train_step.py``).  ``"p_g_os"`` wraps both and stamps
nothing, as the reference does.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from .sharding import (GroupShardedOptimizerStage2, GroupShardedStage2,
                       GroupShardedStage3, _sharding_axis)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def group_sharded_parallel(model: nn.Module, optimizer, level: str,
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """``level``: ``"os"`` (stage 1), ``"os_g"`` (stage 2) or
    ``"p_g_os"`` (stage 3).  Returns ``(model, optimizer, scaler)``."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"bad sharding level {level!r}")
    if level in ("os", "os_g"):
        opt = GroupShardedOptimizerStage2(
            [p for _, p in optimizer.params], optimizer, group=group,
            offload=offload)
        model = GroupShardedStage2(model, opt, group=group,
                                   sync_buffers=sync_buffers,
                                   buffer_max_size=buffer_max_size)
        _mark_sharded_update(opt, level)
        return model, opt, scaler
    model = GroupShardedStage3(model, optimizer=optimizer, group=group,
                               sync_buffers=sync_buffers,
                               segment_size=segment_size, offload=offload)
    opt = GroupShardedOptimizerStage2(
        [p for _, p in optimizer.params], optimizer, group=group,
        offload=offload)
    return model, opt, scaler


def _mark_sharded_update(opt, level: str) -> None:
    """Stamp ``opt`` with the hybrid group's mesh and the ZeRO stage of
    ``level`` over its ``sharding`` (else ``data``) axis; no hybrid group,
    or neither axis above 1, stamps nothing."""
    from ...topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    mesh = hcg.mesh if hcg is not None else None
    axis = _sharding_axis(mesh) if mesh is not None else None
    if axis is None:
        return
    from ....jit.spmd import ShardingConfig
    opt._sharded_update = (
        mesh, ShardingConfig(stage=1 if level == "os" else 2, axis=axis))


def save_group_sharded_model(model, output: str, optimizer=None) -> None:
    """Write the model's state dict (``model.pdmodel``: whole on every
    rank of a ZeRO-1/2 step) and, given one, the optimizer's
    (``model.pdopt``: its own leaves, this rank's rows under a sharded
    step) under ``output``, from rank 0 of the world (or the one
    process)."""
    import torch.distributed as dist
    from ....framework_io import _atomic_pickle
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    inner = getattr(model, "_layers", model)
    _atomic_pickle({k: v.detach().cpu() for k, v in
                    inner.state_dict().items()},
                   os.path.join(output, "model.pdmodel"))
    if optimizer is not None:
        _atomic_pickle({k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                            else v)
                        for k, v in optimizer.state_dict().items()},
                       os.path.join(output, "model.pdopt"))
