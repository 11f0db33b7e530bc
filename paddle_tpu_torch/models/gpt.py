"""GPT-2 through the paddle API (counterpart of
``paddle_tpu/models/gpt.py``): ``GPTConfig`` (GPT-2 small by default:
50,304 vocab, 768 wide, 12 layers of 12 heads, a 3,072-wide MLP, 1,024
positions), ``GPTBlock``, ``GPTModel`` and ``GPTForCausalLM`` (the LM
head tied to ``wte``).  Built from ``nn.Layer`` s; every block's
attention is ``F.scaled_dot_product_attention`` with ``is_causal`` and no
dropout, so it runs the flash kernels (#1 forward, #2 or #3 backward).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..nn.layer_base import Layer
from ..nn.layers import Embedding, Linear, LayerNorm, Dropout, LayerList
from ..nn.transformer import MultiHeadAttention
from ..nn import functional as F


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5


class GPTBlock(Layer):
    def __init__(self, c: GPTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.attn = MultiHeadAttention(c.hidden_size, c.num_attention_heads,
                                       c.attention_probs_dropout_prob)
        self.ln_2 = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.fc1 = Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, x, mask=None):
        h = self.ln_1(x)
        B, S = h.shape[0], h.shape[1]
        q = self.attn.q_proj(h).reshape([B, S, self.attn.num_heads,
                                         self.attn.head_dim])
        k = self.attn.k_proj(h).reshape([B, S, self.attn.num_heads,
                                         self.attn.head_dim])
        v = self.attn.v_proj(h).reshape([B, S, self.attn.num_heads,
                                         self.attn.head_dim])
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           training=self.training)
        a = self.attn.out_proj(a.reshape([B, S, -1]))
        x = x + self.dropout(a)
        m = self.fc2(F.gelu(self.fc1(self.ln_2(x))))
        return x + self.dropout(m)


class GPTModel(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.wte = Embedding(config.vocab_size, config.hidden_size)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size)
        self.drop = Dropout(config.hidden_dropout_prob)
        self.blocks = LayerList([GPTBlock(config)
                                 for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps)

    def forward(self, input_ids):
        from ..ops.creation import arange
        from ..ops.manipulation import unsqueeze
        S = input_ids.shape[1]
        pos = unsqueeze(arange(S, dtype="int64"), 0)
        h = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            h = blk(h)
        return self.ln_f(h)


class GPTForCausalLM(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.gpt = GPTModel(config)

    def forward(self, input_ids):
        h = self.gpt(input_ids)
        from ..ops.linalg import matmul
        return matmul(h, self.gpt.wte.weight, transpose_y=True)
