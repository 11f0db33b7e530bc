"""Token sampling of the serving step (counterpart of
``paddle_tpu/ops/sampling.py``).  This slice ports greedy decoding only;
stochastic sampling and speculative verification are not ported."""
from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary of each row ``[rows, V]`` in fp32 (the
    first maximum on ties, as ``jnp.argmax``), as int32."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
