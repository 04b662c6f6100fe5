"""The GPT model family (paddle_tpu/models/gpt.py): GPT-2-style decoder
blocks over the eager transformer stack (nn.LayerNorm, nn.MultiHeadAttention
with causal attention bound on as ``_forward_causal``, tanh GELU, dropout).
Attention goes through F.scaled_dot_product_attention: on a card, the CUDA
flash kernels (D = 64 at the gpt2 widths), attention dropout inside them.

``GPTForCausalLM(input_ids, labels)`` returns the cross-entropy of the
logits against ``labels`` at the same positions, with no shift, as the
reference computes it: the caller passes next-token labels.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

from .. import nn
from ..nn import functional as F
from ..ops.creation import arange

__all__ = ["GPTConfig", "GPTForCausalLM", "GPT_PRESETS", "GPTBlock"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1
    dtype: str = "bfloat16"


GPT_PRESETS = {
    "gpt2": GPTConfig(),
    "gpt2-medium": GPTConfig(hidden_size=1024, num_hidden_layers=24,
                             num_attention_heads=16, intermediate_size=4096),
    "gpt2-large": GPTConfig(hidden_size=1280, num_hidden_layers=36,
                            num_attention_heads=20, intermediate_size=5120),
    "debug": GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=128,
                       max_position_embeddings=128, dropout=0.0,
                       dtype="float32"),
}


class GPTBlock(nn.Layer):
    """Pre-norm: x + drop(attn(ln_1(x))), then x + drop(mlp(ln_2(x)))."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.ln_1 = nn.LayerNorm(h, epsilon=cfg.layer_norm_eps)
        self.attn = nn.MultiHeadAttention(h, cfg.num_attention_heads,
                                          dropout=cfg.dropout)
        self.ln_2 = nn.LayerNorm(h, epsilon=cfg.layer_norm_eps)
        self.mlp = nn.Sequential(
            nn.Linear(h, cfg.intermediate_size),
            nn.GELU(approximate=True),
            nn.Linear(cfg.intermediate_size, h),
        )
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        a = self.attn._forward_causal(self.ln_1(x))
        x = x + self.drop(a)
        x = x + self.drop(self.mlp(self.ln_2(x)))
        return x


def _mha_forward_causal(self, x):
    """Causal self-attention of x [B, S, hidden] (gpt.py:66-77)."""
    b, s = x.shape[0], x.shape[1]
    q = self.q_proj(x).reshape([b, s, self.num_heads, self.head_dim])
    k = self.k_proj(x).reshape([b, s, self.num_heads, self.head_dim])
    v = self.v_proj(x).reshape([b, s, self.num_heads, self.head_dim])
    out = F.scaled_dot_product_attention(
        q, k, v, is_causal=True, dropout_p=self.dropout,
        training=self.training)
    return self.out_proj(out.reshape([b, s, self.embed_dim]))


# the causal variant bound onto MultiHeadAttention, as the reference does
nn.MultiHeadAttention._forward_causal = _mha_forward_causal


class GPTForCausalLM(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.drop = nn.Dropout(cfg.dropout)
        self.blocks = nn.LayerList(
            [GPTBlock(cfg) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias_attr=False)

    def forward(self, input_ids, labels=None):
        s = input_ids.shape[1]
        pos = arange(s, dtype="int64").unsqueeze(0)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        logits = self.lm_head(x)
        if labels is not None:
            return F.cross_entropy(
                logits.reshape([-1, self.config.vocab_size]),
                labels.reshape([-1]))
        return logits

    @classmethod
    def from_preset(cls, name):
        return cls(copy.deepcopy(GPT_PRESETS[name]))
