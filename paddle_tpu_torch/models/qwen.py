"""Qwen2-family causal LM (counterpart of ``paddle_tpu/models/qwen.py``).

Qwen2 is the Llama architecture with q/k/v biases, grouped-query
attention and optionally tied embeddings, so it reuses the port's Llama
stack with those switches set, as the reference does: the same training
path (the flash kernels over k and v repeated to the query heads), the
same cache path and ``generate``, and the same serving steps (the biases
enter the q/k/v projections before the RoPE + QKV epilogue kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion)

__all__ = ["Qwen2Config", "Qwen2Model", "Qwen2ForCausalLM",
           "Qwen2PretrainingCriterion", "qwen2_tiny_config"]


@dataclass
class Qwen2Config(LlamaConfig):
    """Qwen2-7B's widths as the defaults."""
    vocab_size: int = 151936
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0
    attention_bias: bool = True          # the qwen2 signature difference
    tie_word_embeddings: bool = False


def qwen2_tiny_config(**kw) -> Qwen2Config:
    cfg = dict(vocab_size=1024, hidden_size=128, intermediate_size=352,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=256)
    cfg.update(kw)
    return Qwen2Config(**cfg)


class Qwen2Model(LlamaModel):
    """Decoder stack with the qwen2 switches (GQA + qkv biases)."""


class Qwen2ForCausalLM(LlamaForCausalLM):
    """Llama's wrapper (``.llama``, ``generate``, the cache path) over a
    config that must carry the q/k/v biases."""

    def __init__(self, config: Qwen2Config, device=None, generator=None):
        if not getattr(config, "attention_bias", False):
            raise ValueError("Qwen2Config requires attention_bias=True")
        super().__init__(config, device=device, generator=generator)


Qwen2PretrainingCriterion = LlamaPretrainingCriterion
