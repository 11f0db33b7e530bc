"""Layers of the Llama path (counterparts of ``paddle_tpu/nn/layers.py``).

Parameters are created uninitialized (and trainable) on the given device
and dtype; the model initializes them from an explicit ``torch.Generator``
or loads them (``testing/parity.py``).
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from . import functional as PF


class Linear(nn.Module):
    """``y = x W^T + b`` with ``W`` stored in torch's ``[out, in]``
    layout.  The reference stores ``W`` as ``[in, out]``
    (``paddle_tpu/nn/layers.py`` ``Linear``); the weight loader
    (``testing/parity.state_from_paddle_tpu``) transposes."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               **kw))
        self.bias = (nn.Parameter(torch.empty(out_features, **kw))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Token lookup, weight ``[num_embeddings, embedding_dim]`` (the same
    layout as the reference)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, embedding_dim, device=device,
                        dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    """:func:`functional.rms_norm` as a layer; weight initialized to 1."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return PF.rms_norm(x, self.weight, self.epsilon)
