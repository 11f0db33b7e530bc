"""The model families of the port: Llama, Mixtral (sparse MoE) and
Qwen2.  GPT-2 and the ResNet family through the paddle API are
``models.gpt`` and ``models.resnet``, each imported on its own (they build
the API's op table)."""
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaPretrainingCriterion, llama_7b_config,
                    llama_tiny_config)
from .mixtral import (MixtralConfig, MixtralForCausalLM,  # noqa: F401
                      MixtralPretrainingCriterion, MixtralSparseMoeBlock,
                      mixtral_8x7b_config, mixtral_tiny_config,
                      shard_mixtral)
from .qwen import (Qwen2Config, Qwen2ForCausalLM, Qwen2Model,  # noqa: F401
                   Qwen2PretrainingCriterion, qwen2_tiny_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "llama_7b_config", "llama_tiny_config", "MixtralConfig",
           "MixtralForCausalLM", "MixtralPretrainingCriterion",
           "MixtralSparseMoeBlock", "mixtral_8x7b_config",
           "mixtral_tiny_config", "shard_mixtral", "Qwen2Config",
           "Qwen2ForCausalLM", "Qwen2Model", "Qwen2PretrainingCriterion",
           "qwen2_tiny_config"]
