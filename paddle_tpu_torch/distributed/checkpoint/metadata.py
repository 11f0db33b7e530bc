"""Distributed-checkpoint metadata (a copy of
``paddle_tpu/distributed/checkpoint/metadata.py``): a global index mapping
tensor key -> [global_offset, local_shape] per saved shard, so a
checkpoint saved under one mesh can be loaded under another.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class LocalTensorMetadata:
    """Shape/offset of one saved shard (reference metadata.py:20)."""
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str


@dataclass(frozen=True)
class LocalTensorIndex:
    """Key of one saved shard (reference metadata.py:33)."""
    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclass
class Metadata:
    """Checkpoint-global metadata (reference metadata.py:40)."""
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = \
        field(default_factory=dict)
    storage_metadata: Dict[LocalTensorIndex, str] = field(default_factory=dict)
    flat_mapping: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
