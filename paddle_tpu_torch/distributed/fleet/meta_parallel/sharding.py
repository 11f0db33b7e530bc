"""The group-sharding wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding.py``), as far as
``group_sharded_parallel`` needs them.

The reference re-places arrays (optimizer state, gradients, parameters)
with GSPMD shardings over the hybrid group's ``sharding`` or ``data``
axis.  Over ``torch.distributed`` ranks the sharded update lives in the
training step instead: ``jit.train_step.TrainStep`` reads the marker that
``sharding_api._mark_sharded_update`` stamps on the wrapped optimizer and
runs ZeRO-1/2 over that axis.  So here the wrappers only hold what they
wrap: :class:`GroupShardedOptimizerStage2` passes every attribute through
to its optimizer (the step's updates, counts and state are the
optimizer's own), and :class:`GroupShardedStage2` / ``Stage3`` forward
to their layer.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from ...process_mesh import ProcessMesh

__all__ = ["GroupShardedOptimizerStage2", "GroupShardedStage2",
           "GroupShardedStage3"]


def _sharding_axis(mesh: ProcessMesh) -> Optional[str]:
    """The hybrid mesh's axis the states shard over: ``sharding``, else
    ``data``, whichever is above 1 first; None if neither is."""
    sizes = mesh.axis_sizes()
    for cand in ("sharding", "data"):
        if sizes.get(cand, 1) > 1:
            return cand
    return None


class GroupShardedOptimizerStage2:
    """The wrapped optimizer; every other attribute, read or written, is
    its optimizer's (``_sharded_update``, the marker, is the wrapper's
    own)."""

    _OWN = ("_optim", "_offload", "_sharded_update")

    def __init__(self, params, optim, group=None, offload: bool = False):
        object.__setattr__(self, "_optim", optim)
        object.__setattr__(self, "_offload", offload)
        object.__setattr__(self, "_sharded_update", None)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_optim"), name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._optim, name, value)

    def step(self) -> None:
        self._optim.step()

    def clear_grad(self) -> None:
        self._optim.clear_grad()


class _Wrapped(nn.Module):
    def __init__(self, layer: nn.Module):
        super().__init__()
        self._layers = layer

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)


class GroupShardedStage2(_Wrapped):
    """Gradient and optimizer-state sharding around ``layer`` (its
    sharded update is the marked ``TrainStep``'s)."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers: bool = False, buffer_max_size: int = 2 ** 23,
                 offload: bool = False):
        super().__init__(layer)
        self._optim = sharding_optimizer


class GroupShardedStage3(_Wrapped):
    """Parameter sharding around ``layer``: ``level="p_g_os"`` stamps no
    marker in the reference, so a ``TrainStep`` over it is replicated (the
    port's ZeRO-3 storage is the 2-D ``TrainStep``'s fsdp axis)."""

    def __init__(self, layer, optimizer=None, group=None,
                 sync_buffers: bool = False, segment_size: int = 2 ** 20,
                 offload: bool = False):
        super().__init__(layer)
        self._optim = optimizer
