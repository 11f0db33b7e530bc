"""Sharded checkpoint load with resharding (counterpart of
``paddle_tpu/distributed/checkpoint/load_state_dict.py``): each target is
filled from only the saved shards that overlap its box, so a checkpoint
saved under one mesh loads under another."""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict

import torch

from ...jit.redistribute import Placed, spec_box
from .manager import _as_tensor, assemble_box
from .metadata import Metadata

__all__ = ["load_state_dict"]


def load_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id=None, offload=False):
    """Fill the tensors of ``state_dict`` in place: a tensor with the
    whole value, a ``Placed`` slice with its box of it."""
    import torch.distributed as dist
    meta_files = glob.glob(os.path.join(path, "*.metadata"))
    if not meta_files:
        raise FileNotFoundError(f"no .metadata file under {path}")
    with open(meta_files[0], "rb") as f:
        meta: Metadata = pickle.load(f)
    payload: Dict = {}
    for fname in glob.glob(os.path.join(path, "*.distcp")):
        with open(fname, "rb") as f:
            payload.update(pickle.load(f))
    rank = dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0
    with torch.no_grad():
        for key, target in state_dict.items():
            if key not in meta.state_dict_metadata:
                raise KeyError(f"tensor {key!r} not present in checkpoint")
            shards = []
            for m in meta.state_dict_metadata[key]:
                arr, dtype_name = payload[(key, m.global_offset)]
                shards.append((m.global_offset, m.local_shape, dtype_name,
                               arr))
            if isinstance(target, Placed):
                if not target.mesh.holds(rank):
                    continue
                box = spec_box(target.shape, target.spec,
                               target.mesh.axis_sizes(),
                               target.mesh.coords(rank))
                dst = target.local
            else:
                dst = target
                box = tuple((0, n) for n in dst.shape)
            dst.copy_(_as_tensor(assemble_box(shards, box)).to(dst.dtype))
    return state_dict
