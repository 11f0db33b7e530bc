"""Sharded, atomic, async checkpoints over ``torch.distributed`` ranks
(counterpart of ``paddle_tpu/distributed/checkpoint``)."""
from .save_state_dict import save_state_dict
from .load_state_dict import load_state_dict
from .metadata import Metadata, LocalTensorMetadata, LocalTensorIndex
from .manager import (CheckpointManager, TrainState, assemble,
                      assemble_box)

__all__ = ["save_state_dict", "load_state_dict", "Metadata",
           "LocalTensorMetadata", "LocalTensorIndex", "CheckpointManager",
           "TrainState", "assemble", "assemble_box"]
